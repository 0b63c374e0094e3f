"""Distributed LMC over ``torch.distributed``: row-block placement of the
node axis (sharding.py) and the row exchanges between ranks
(collectives.py). The step that uses them is ``core.distributed``."""
from repro_torch.dist.collectives import (all_gather_blocks, all_reduce_sum,
                                          fetch_rows, route_rows)
from repro_torch.dist.sharding import (dp_axis_size, dp_rank, lmc_placement,
                                       owner_of, row_block, take_block)

__all__ = ["fetch_rows", "route_rows", "all_gather_blocks", "all_reduce_sum",
           "dp_axis_size", "dp_rank", "lmc_placement", "owner_of",
           "row_block", "take_block"]
