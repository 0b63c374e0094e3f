"""Parameter spec trees: shapes + logical axes, materializable or abstract.

Every LM block declares its parameters as a tree of :class:`PSpec` leaves
(shape + logical axis names + init style), as in the reference. The same
tree then produces
  * real tensors   (``materialize`` — drawn from an explicit generator)
  * meta tensors   (``abstract`` — shapes and dtypes, no allocation)
The logical axis names are kept for sharding rules, not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: tuple
    logical: tuple            # logical axis name (or None) per dim
    init: str = "normal"      # normal | zeros | ones
    scale: float = 0.02
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def tree_map(fn, tree):
    """Apply ``fn`` to every non-dict leaf of a nested dict (keys sorted, as
    ``jax.tree`` orders them)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree, path: tuple = ()) -> list:
    """``[(path, leaf)]`` of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves(tree[k], path + (k,))
        return out
    return [(path, tree)]


def materialize(tree, generator: torch.Generator, device) -> dict:
    """Real tensors on ``device``: normal·scale drawn in f32 and cast, or
    zeros / ones. ``generator`` must live on ``device``; leaves draw in the
    order of ``tree_leaves``."""
    def make(s: PSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(s.scale).to(s.dtype)
    return tree_map(make, tree)


def abstract(tree) -> dict:
    """Tensors on the ``meta`` device: shape and dtype, no storage."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), tree)
