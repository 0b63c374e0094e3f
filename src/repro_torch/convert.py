"""Load the reference package's GNN parameters into the port's GNN.

The reference keeps GNN parameters as a nested dict
``{"embed": {...}, "layers": {name: [per-layer]}, "head": {...}}`` of arrays
applied as ``h @ w``; :class:`repro_torch.models.gnn.GNN` keeps the same
layout and orientation, so conversion is a leaf-for-leaf copy. Pass the
reference tree with its leaves as numpy arrays (``np.asarray`` of each).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.gnn import GNN


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
