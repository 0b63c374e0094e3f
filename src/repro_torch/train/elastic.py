"""Elastic rescaling: continue training after the device pool changes.

The LMC historical stores are *soft state*: Thm 2 bounds the staleness
contribution by C·ρ^{(k-1)/2}, so after a rescale they can be (a) carried
over as they are, or (b) cold-reinitialized, paying only a transient bias
spike that decays geometrically — the cheap path when the node-partition
itself changed (cluster count is retuned to the new device count).
Under distributed LMC (a process group) a carried store is resharded into
this rank's row block of the new world (``checkpoint.reshard``).
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.manager import reshard
from repro_torch.core.history import (HistoricalState, init_history,
                                      stacked)
from repro_torch.dist.sharding import (ROW_AXES, distributed, dp_axis_size,
                                       dp_rank, row_block)
from repro_torch.graph.partition import partition_graph
from repro_torch.graph.sampler import ClusterSampler


def rescale_lmc_state(graph, store: HistoricalState, *,
                      old_num_parts: int, new_num_parts: int, seed: int = 0,
                      reuse_store: bool = True, guard=None, group=None
                      ) -> tuple[ClusterSampler, HistoricalState]:
    """Re-partition for a new device count and carry (or reset) the stores.

    The historical values are per-*node*, so they survive a re-partition
    unchanged when `reuse_store` (partition only changes which rows are
    updated together); resetting them is also sound (Thm 2). A reset store
    is zeros on the old store's own device. Stores whose layers differ in
    width (GAT's) raise ValueError: resharding them is not supported.

    Under a process group (``group``, or the default one) ``store`` is the
    whole store, as a whole-tree checkpoint restores it, and the result is
    this rank's row block of it for the group's world size (a reset store:
    a zero block of that size).

    ``guard`` (a ``train.health.HealthGuard``, optional) keeps the Thm-2
    staleness accounting honest across the rescale: a reused store carries
    its counters (row ages are unchanged by re-partitioning), while a cold
    reinit zeroes them (every row is byte-fresh — the transient bias of the
    reset is what decays as ρ^k, not row staleness).
    """
    if not isinstance(store.h, torch.Tensor):
        store = HistoricalState(stacked(store.h, "rescale_lmc_state"),
                                stacked(store.v, "rescale_lmc_state"))
    parts = partition_graph(graph, new_num_parts, seed=seed)
    sampler = ClusterSampler(graph, new_num_parts, parts=parts, seed=seed)
    sharded = distributed(group)
    if sharded and store.h.shape[1] != graph.num_nodes:
        raise ValueError(
            f"rescale_lmc_state under a process group takes the whole store "
            f"({graph.num_nodes} rows), not a block of "
            f"{store.h.shape[1]}: restore it from a whole-tree checkpoint")
    if reuse_store:
        new_store = store if not sharded else HistoricalState(*reshard(
            (store.h, store.v), ROW_AXES["store"], group=group,
            device=store.h.device))
    else:
        L, _, d = store.h.shape
        start, stop = (row_block(graph.num_nodes, dp_axis_size(group),
                                 dp_rank(group))
                       if sharded else (0, graph.num_nodes))
        new_store = init_history(L, stop - start, d,
                                 dtype=store.h.dtype, device=store.h.device)
        if guard is not None:
            guard.reset_staleness()
    return sampler, new_store
