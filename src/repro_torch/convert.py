"""Load the reference package's parameters, stores and caches into the port.

The reference keeps GNN parameters as a nested dict
``{"embed": {...}, "layers": {name: [per-layer]}, "head": {...}}`` of arrays
applied as ``h @ w``; :class:`repro_torch.models.gnn.GNN` keeps the same
layout and orientation, so conversion is a leaf-for-leaf copy. Pass the
reference tree with its leaves as numpy arrays (``np.asarray`` of each).
Historical stores have the same (L, n, d) layout in both packages.

LM parameters, decode caches and optimizer states are nested dicts in both
packages, with the same keys and stacked layer axes
(``repro_torch.models.lm.LM``, ``repro_torch.optim``). Their bf16
leaves arrive as ``ml_dtypes.bfloat16`` arrays, which torch cannot take
directly; they pass through float32, which holds every bf16 value exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.history import HistoricalState
from repro_torch.device import resolve_device
from repro_torch.models.gnn import GNN
from repro_torch.models.lm import LM
from repro_torch.models.spec import tree_leaves


def _leaves(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, path + (i,)))
        return out
    return {path: tree}


def params_from_reference(gnn: GNN, tree) -> dict:
    """Copy ``tree`` into ``gnn``'s parameters leaf by leaf; returns
    ``gnn.params()``.

    Raises ValueError if a leaf of ``gnn`` is missing from ``tree``, a leaf
    of ``tree`` is left over, or a shape differs — before copying anything.
    """
    ours = _leaves(gnn.params())
    theirs = _leaves(tree)
    missing = sorted(map(str, set(ours) - set(theirs)))
    extra = sorted(map(str, set(theirs) - set(ours)))
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, "
                         f"left over {extra}")
    arrays = {k: np.asarray(v) for k, v in theirs.items()}
    for k, p in ours.items():
        if tuple(arrays[k].shape) != tuple(p.shape):
            raise ValueError(f"parameter {k}: reference shape "
                             f"{tuple(arrays[k].shape)} != {tuple(p.shape)}")
    with torch.no_grad():
        for k, p in ours.items():
            p.copy_(torch.from_numpy(np.array(arrays[k], dtype=np.float32)))
    return gnn.params()


def state_from_reference(h, v, device=None) -> HistoricalState:
    """A reference ``HistoricalState``'s stores, given as numpy arrays
    ``h`` (L, n, d) and ``v`` (L-1, n, d), as the port's on ``device``
    (None: the card). The arrays are copied, never shared."""
    dev = resolve_device(device)
    return HistoricalState(
        h=torch.tensor(np.asarray(h), device=dev),
        v=None if v is None else torch.tensor(np.asarray(v), device=dev))


_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "int8": torch.int8, "int32": torch.int32}


def _tensor(arr, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A numpy array (bf16 ones included) as a fresh tensor of ``dtype``."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)


def _unflatten(leaves: dict) -> dict:
    out: dict = {}
    for path, v in leaves.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def lm_params_from_reference(lm: LM, tree) -> dict:
    """Load the reference ``LM``'s parameter tree (leaves as numpy arrays)
    into ``lm`` on ``lm.device``, each leaf in the dtype of ``lm``'s spec;
    returns ``lm.params()``.

    Raises ValueError if a leaf of the spec is missing from ``tree``, a leaf
    of ``tree`` is left over, or a shape differs — before loading anything.
    """
    ours = {p: s for p, s in tree_leaves(lm.params_spec())}
    theirs = {p: np.asarray(v) for p, v in tree_leaves(tree)}
    missing = sorted(map(str, set(ours) - set(theirs)))
    extra = sorted(map(str, set(theirs) - set(ours)))
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, "
                         f"left over {extra}")
    for p, s in ours.items():
        if tuple(theirs[p].shape) != tuple(s.shape):
            raise ValueError(f"parameter {p}: reference shape "
                             f"{tuple(theirs[p].shape)} != {tuple(s.shape)}")
    return lm.load_params(_unflatten(
        {p: _tensor(theirs[p], s.dtype, lm.device) for p, s in ours.items()}))


def lm_caches_from_reference(tree, device=None) -> dict:
    """A reference decode-cache tree (leaves as numpy arrays) as tensors of
    the same dtypes on ``device`` (None: the card), copied, never shared."""
    dev = resolve_device(device)
    return _unflatten({p: _tensor(v, _TORCH_DTYPES[np.asarray(v).dtype.name],
                                  dev)
                       for p, v in tree_leaves(tree)})


def lm_opt_state_from_reference(lm: LM, opt_name: str, state) -> dict:
    """The reference's optimizer state for ``lm``'s parameters under
    ``make_optimizer(opt_name)`` (leaves as numpy arrays) as the port's, on
    ``lm.device``, so a port step can continue a reference run. Every leaf
    keeps its dtype (f32 moments and masters, AdamW-8bit's int8 codes, the
    int32 step count).

    Raises ValueError if a leaf the port's state has is missing from
    ``state``, a leaf of ``state`` is left over, or a shape or dtype
    differs — before converting anything.
    """
    from repro_torch.optim import make_optimizer
    ours = dict(tree_leaves(make_optimizer(opt_name).init(
        lm.abstract_params())))
    theirs = {p: np.asarray(v) for p, v in tree_leaves(state)}
    missing = sorted(map(str, set(ours) - set(theirs)))
    extra = sorted(map(str, set(theirs) - set(ours)))
    if missing or extra:
        raise ValueError(f"optimizer states differ: missing {missing}, "
                         f"left over {extra}")
    for p, t in ours.items():
        got = (tuple(theirs[p].shape), _TORCH_DTYPES.get(theirs[p].dtype.name))
        if got != (tuple(t.shape), t.dtype):
            raise ValueError(f"optimizer state {p}: reference {got} != "
                             f"{(tuple(t.shape), t.dtype)}")
    return _unflatten({p: _tensor(theirs[p], t.dtype, lm.device)
                       for p, t in ours.items()})
