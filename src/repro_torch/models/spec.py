"""Parameter spec trees: shapes + logical axes, materializable or abstract.

Every LM block declares its parameters as a tree of :class:`PSpec` leaves
(shape + logical axis names + init style), as in the reference. The same
tree then produces
  * real tensors   (``materialize`` — drawn from an explicit generator)
  * meta tensors   (``abstract`` — shapes and dtypes, no allocation)
  * placements     (``shardings`` — via logical -> mesh axis rules)
With placements and a mesh, ``materialize`` and ``abstract`` give DTensors:
the same full tensors cut into this rank's shards, or meta local shards.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor

from repro_torch.dist.sharding import (_axes, axes_to_placements, distribute,
                                       local_shape, resolve_axes)


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


def materialize(tree, generator: torch.Generator, device,
                shardings=None, mesh=None) -> dict:
    """Real tensors on ``device``: normal·scale drawn in f32 and cast, or
    zeros / ones. ``generator`` must live on ``device``; leaves draw in the
    order of ``tree_leaves``. With ``shardings`` (a placement list per
    leaf) the full tensors are then cut into ``mesh``'s shards, so sharded
    and plain parameters are the same numbers."""
    def make(s: PSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(s.scale).to(s.dtype)
    full = tree_map(make, tree)
    return full if shardings is None else distribute(full, shardings, mesh)


def abstract(tree, shardings=None, mesh=None) -> dict:
    """Tensors on the ``meta`` device: shape and dtype, no storage. With
    ``shardings`` and ``mesh``: DTensors over meta local shards."""
    if shardings is None:
        return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                              device="meta"), tree)

    def make(s: PSpec, plc) -> DTensor:
        loc = torch.empty(local_shape(mesh, s.shape, plc), dtype=s.dtype,
                          device="meta")
        return DTensor.from_local(loc, mesh, plc, run_check=False)
    return _zip_map(make, tree, shardings)


def _zip_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], other[k]) for k in sorted(tree)}
    return fn(tree, other)


# logical axis -> mesh axes. `fsdp` resolves to ("data",) or ("pod","data").
def default_rules(fsdp_axes=("data",)) -> dict:
    return {
        "embed": fsdp_axes,       # weight-sharding (ZeRO/FSDP) dimension
        "embed2": ("model",),
        "batch": ("pod", "data"),      # activations / caches
        "cache_seq": ("model",),       # sequence-sharded decode KV caches
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),   # dropped when not divisible
        "mlp": ("model",),
        "experts": ("model",),
        "moe_mlp": ("data",),
        "kv_lora": ("model",),
        "q_lora": None,
        "head_dim": None,
        "state": None,
        "conv": None,
        "layers": None,
        "dconv": None,
        None: None,
    }


def spec_axes(spec: PSpec, rules: dict, mesh) -> tuple:
    """The mesh axes each dim of ``spec`` shards over, by the reference's
    ``partition_spec`` rule: a logical axis's mesh axes that the mesh has
    and no earlier dim uses, dropped when they do not divide the dim (a
    size-1 axis is kept). ``mesh``: a ``DeviceMesh`` or anything with the
    reference mesh's ``axis_names`` and ``devices.shape``."""
    names, sizes = _axes(mesh)
    wanted = []
    for logical in spec.logical:
        ax = rules.get(logical)
        wanted.append(None if ax is None else
                      ax if isinstance(ax, tuple) else (ax,))
    return resolve_axes(names, sizes, spec.shape, wanted, drop_trivial=False)


def partition_spec(spec: PSpec, rules: dict, mesh) -> list:
    """``spec``'s placements on ``mesh`` (one per mesh axis)."""
    return axes_to_placements(mesh, spec_axes(spec, rules, mesh))


def shardings(tree, rules: dict, mesh) -> dict:
    """The placements of every leaf of a PSpec tree."""
    return tree_map(lambda s: partition_spec(s, rules, mesh), tree)
