"""Row-block placement of the node axis over the ranks of a process group.

The counterpart of the GNN half of ``repro.dist.sharding``: where the
reference shards the node axis of the stores and features over the ``data``
axis of a device mesh (``row_sharding``, ``store_sharding``), the port gives
each rank of a ``torch.distributed`` group one contiguous block of node rows.
Rank ``r`` of ``world`` owns rows ``[r·b, min(n, (r+1)·b))`` with
``b = ceil(n / world)``, so every block but the last has ``b`` rows and the
last is short (or empty).

A *placement* says which leaves of a state tree are row-blocked and which
are replicated: a tree of the same structure whose leaves are the node axis
of a row-blocked leaf (an ``int``) or ``None`` for a replicated one. The
stores ``h`` and ``v`` and the features ``x`` and ``self_w`` are
row-blocked; parameters and optimizer state are replicated
(:func:`lmc_placement`, the counterpart of ``spmd_shardings``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# node axis of each row-blocked leaf of an LMC state tree
ROW_AXES = {"store": (1, 1), "x": 0, "self_w": 0}


def distributed(group=None) -> bool:
    """True when ``group`` is given or a default process group exists."""
    return group is not None or (dist.is_available()
                                 and dist.is_initialized())


def dp_axis_size(group=None) -> int:
    """Row-parallel ways: the group's world size, 1 without a group."""
    return dist.get_world_size(group) if distributed(group) else 1


def dp_rank(group=None) -> int:
    """This process's rank in ``group``; 0 without a group."""
    return dist.get_rank(group) if distributed(group) else 0


def block_size(n: int, world: int) -> int:
    """Rows per block: ``ceil(n / world)``."""
    return -(-int(n) // int(world))


def row_block(n: int, world: int, rank: int) -> tuple[int, int]:
    """``(start, stop)`` of rank ``rank``'s contiguous block of ``n`` rows;
    the last block is short, and empty when ``world`` blocks overshoot."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    b = block_size(n, world)
    return min(n, rank * b), min(n, (rank + 1) * b)


def owner_of(gids, n: int, world: int):
    """The rank that owns each global row id in ``gids`` (numpy array or
    tensor, same kind back). Ids must lie in ``[0, n)``."""
    b = block_size(n, world)
    if isinstance(gids, torch.Tensor):
        return torch.div(gids.long(), b, rounding_mode="floor")
    return np.asarray(gids, np.int64) // b


def lmc_placement(tree: dict) -> dict:
    """The placement of an LMC state tree, a dict with some of the keys
    ``params``, ``opt`` (replicated: every rank applies the same all-reduced
    update), ``store`` (``(h, v)``, row-blocked on axis 1), ``x`` and
    ``self_w`` (row-blocked on axis 0). Other keys are replicated."""
    def replicated(t):
        if isinstance(t, dict):
            return {k: replicated(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(replicated(v) for v in t)
        return None

    return {k: ROW_AXES[k] if k in ROW_AXES else replicated(v)
            for k, v in tree.items()}


def take_block(leaf, axis: Optional[int], world: int, rank: int):
    """Rank ``rank``'s row block of ``leaf`` along ``axis`` (the whole leaf
    when ``axis`` is None)."""
    if axis is None:
        return leaf
    start, stop = row_block(leaf.shape[axis], world, rank)
    idx = [slice(None)] * leaf.ndim
    idx[axis] = slice(start, stop)
    return leaf[tuple(idx)]
