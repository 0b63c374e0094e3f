"""Distribution over ``torch.distributed``. The GNN half: row-block
placement of the node axis (sharding.py) and the row exchanges between
ranks (collectives.py), used by ``core.distributed``. The LM half: device
meshes (mesh.py) and DTensor placements and activation constraints
(sharding.py), used by ``launch.steps.build_cell``."""
from repro_torch.dist.collectives import (all_gather_blocks, all_reduce_sum,
                                          fetch_rows, route_rows)
from repro_torch.dist.sharding import (dp_axis_size, dp_rank, lmc_placement,
                                       owner_of, row_block, take_block)

__all__ = ["fetch_rows", "route_rows", "all_gather_blocks", "all_reduce_sum",
           "dp_axis_size", "dp_rank", "lmc_placement", "owner_of",
           "row_block", "take_block"]
