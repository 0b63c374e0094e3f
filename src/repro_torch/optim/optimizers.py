"""Optimizers on parameter trees (nested dicts and lists of tensors).

The reference's ``repro.optim.optimizers`` in PyTorch, minus its sharding
specs: each optimizer exposes

  init(params) -> state                 (zeros beside the parameters)
  update(grads, state, params, lr) -> (new_params, new_state, grad_norm)

Updates are functional (new tensors), as in the reference, so a caller can
drop a step's update and keep the old parameters. Implemented: SGD with
momentum and AdamW (f32 master weights and moments), both after a global
norm clip. ``adamw8bit`` and ``adafactor`` are not ported yet.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import torch


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of dict/list trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def global_norm_clip(grads, max_norm: float):
    """(grads scaled to global norm ≤ ``max_norm``, in f32; the norm)."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), gn


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable            # params -> state
    update: Callable          # (grads, state, params, lr) -> (params, state, gn)
    lr: float = 1e-3


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


# --------------------------------------------------------------- SGD momentum
def _sgd_init(params) -> dict:
    return {"mom": _zeros_f32(params), "count": _count(params)}


def _sgd_update(grads, state, params, lr, *, beta=0.9, clip=1.0):
    g32, gn = global_norm_clip(grads, clip)
    mom = tree_map(lambda m, g: beta * m + g, state["mom"], g32)
    new_p = tree_map(lambda p, m: (p.float() - lr * m).to(p.dtype),
                     params, mom)
    return new_p, {"mom": mom, "count": state["count"] + 1}, gn


# -------------------------------------------------------------------- AdamW
def _adamw_init(params) -> dict:
    return {"m": _zeros_f32(params), "v": _zeros_f32(params),
            "master": _zeros_f32(params), "count": _count(params)}


def _adamw_update(grads, state, params, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                  wd=0.1, clip=1.0):
    g32, gn = global_norm_clip(grads, clip)
    cnt = state["count"] + 1
    t = cnt.float()
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], g32)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], g32)
    # master==0 at step 1 means "adopt current params" (init-free warm start)
    master = tree_map(lambda ms, p: torch.where(cnt == 1, p.float(), ms),
                      state["master"], params)
    master = tree_map(
        lambda ms, m_, v_: ms - lr * ((m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
                                      + wd * ms),
        master, m, v)
    new_p = tree_map(lambda ms, p: ms.to(p.dtype), master, params)
    return new_p, {"m": m, "v": v, "master": master, "count": cnt}, gn


# -------------------------------------------------------------------- factory
def sgd(lr=1e-2, **kw) -> Optimizer:
    return Optimizer("sgd", _sgd_init, partial(_sgd_update, **kw), lr=lr)


def adamw(lr=3e-4, **kw) -> Optimizer:
    return Optimizer("adamw", _adamw_init, partial(_adamw_update, **kw), lr=lr)

