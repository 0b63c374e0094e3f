"""Optimizers on parameter trees (nested dicts and lists of tensors).

The reference's ``repro.optim.optimizers`` in PyTorch, minus its sharding
specs: each optimizer exposes

  init(params) -> state                 (zeros beside the parameters)
  update(grads, state, params, lr) -> (new_params, new_state, grad_norm)

Updates are functional (new tensors), as in the reference, so a caller can
drop a step's update and keep the old parameters. Implemented: SGD with
momentum, AdamW (f32 master weights and moments), AdamW-8bit (block-
quantized moments, an f32 master) and Adafactor (factored second moment,
with the reference's streamed paths for big leaves), and
``make_optimizer``, the reference's table by name.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import torch

QBLOCK = 256  # block size for 8-bit moment quantization


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """``fn`` over the leaves of dict/list trees of one structure;
    ``is_leaf(x)`` true stops the descent at ``x``."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs, is_leaf=is_leaf)
                          for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in the reference's order (dict keys sorted, lists and
    tuples in order); ``None`` is an empty subtree, as in JAX."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


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


# --------------------------------------------------------------- AdamW 8-bit
def _q8_scale_shape(shape) -> tuple:
    if not shape:
        return (1,)
    last = shape[-1]
    return tuple(shape[:-1]) + (max(1, (last + QBLOCK - 1) // QBLOCK),)


def _adamw8_init(params) -> dict:
    def q8(p):
        return torch.zeros_like(p, dtype=torch.int8)

    def sc(p):
        return torch.zeros(_q8_scale_shape(tuple(p.shape)),
                           dtype=torch.float32, device=p.device)
    return {"m_q": tree_map(q8, params), "m_s": tree_map(sc, params),
            "v_q": tree_map(q8, params), "v_s": tree_map(sc, params),
            "master": _zeros_f32(params), "count": _count(params)}


def _q8_encode(x: torch.Tensor):
    """(int8 codes of ``x``'s shape, f32 scales per block of QBLOCK along
    the last axis): the absmax of a block maps to ±127, rounded half to
    even as ``jnp.round`` does."""
    shape = tuple(x.shape)
    if not shape:
        x = x[None]
        shape = (1,)
    last = shape[-1]
    pad = (-last) % QBLOCK
    xb = torch.nn.functional.pad(x, (0, pad)).reshape(*shape[:-1], -1, QBLOCK)
    s = xb.abs().amax(-1) / 127.0
    q = torch.round(xb / torch.clamp(s, min=1e-12)[..., None]).to(torch.int8)
    return q.reshape(*shape[:-1], -1)[..., :last], s


def _q8_decode(q: torch.Tensor, s: torch.Tensor, shape) -> torch.Tensor:
    shape = tuple(shape)
    last = shape[-1] if shape else 1
    pad = (-last) % QBLOCK
    qp = torch.nn.functional.pad(q, (0, pad))
    xb = qp.reshape(*q.shape[:-1], -1, QBLOCK).float()
    out = (xb * s[..., None]).reshape(*q.shape[:-1], -1)[..., :last]
    return out.reshape(shape)


def _adamw8_update(grads, state, params, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                   wd=0.1, clip=1.0):
    g32, gn = global_norm_clip(grads, clip)
    cnt = state["count"] + 1
    t = cnt.float()
    bc1, bc2 = 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)

    def upd(p, g, mq, ms, vq, vs, master):
        m = b1 * _q8_decode(mq, ms, p.shape) + (1 - b1) * g
        v = b2 * _q8_decode(vq, vs, p.shape) + (1 - b2) * g * g
        mst = torch.where(cnt == 1, p.float(), master)
        mst = mst - lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * mst)
        mq2, ms2 = _q8_encode(m)
        vq2, vs2 = _q8_encode(v)
        return mst.to(p.dtype), mq2, ms2, vq2, vs2, mst

    outs = tree_map(upd, params, g32, state["m_q"], state["m_s"],
                    state["v_q"], state["v_s"], state["master"])
    return _part(outs, 0), {"m_q": _part(outs, 1), "m_s": _part(outs, 2),
                            "v_q": _part(outs, 3), "v_s": _part(outs, 4),
                            "master": _part(outs, 5), "count": cnt}, gn


def _part(outs, i: int):
    """Output ``i`` of a tree of per-leaf output tuples, as a tree."""
    return tree_map(lambda o: o[i], outs,
                    is_leaf=lambda x: isinstance(x, tuple))


# ------------------------------------------------------------------ Adafactor
def _adafactor_init(params) -> dict:
    def vr(p):
        shape = p.shape[:-1] if p.ndim >= 2 else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def vc(p):
        shape = (p.shape[:-2] + p.shape[-1:]) if p.ndim >= 2 else (1,)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    return {"vr": tree_map(vr, params), "vc": tree_map(vc, params),
            "count": _count(params)}


def _sq_einsum(g: torch.Tensor, axis: int) -> torch.Tensor:
    """Σ g² over one axis, in f32. The reference multiplies bf16 operands
    with f32 accumulation; a product of two bf16 values is exact in f32, so
    upcasting first changes only the order of the sum."""
    gf = g.float()
    return (gf * gf).sum(axis)


def _adafactor_update(grads, state, params, lr, *, decay=0.8, eps=1e-30,
                      clip=1.0, wd=0.0, stream_bytes=1 << 27):
    """Adafactor as the reference computes it.

    * global-norm clip folded into the per-leaf update
    * factored second-moment statistics for leaves of ndim >= 2
    * leaves of more than ``stream_bytes`` in f32 are updated in pieces, as
      in the reference, and the pieces change the numbers: a leaf of ndim
      >= 3 is updated per slice of its leading axis (its relative-RMS clip
      is per layer), a bigger 2-D leaf in up to 64 chunks of rows (the
      clip is per chunk; the row statistics' mean and the column
      statistics stay whole-leaf).
    """
    gn = torch.sqrt(sum(_sq_einsum(g.reshape(-1), 0)
                        for g in tree_leaves(grads)))
    scale = torch.clamp(clip / torch.clamp(gn, min=1e-9), max=1.0)
    cnt = state["count"] + 1
    t = cnt.float()
    beta = 1.0 - torch.pow(t, -decay)
    s2 = scale * scale

    def rms_clip(u):
        rms_u = torch.sqrt(torch.mean(u * u) + 1e-12)
        return u / torch.clamp(rms_u, min=1.0)

    def upd(p, g, vr, vc):
        if g.ndim >= 2:
            vr2 = beta * vr + (1 - beta) * (s2 * _sq_einsum(g, g.ndim - 1)
                                            / g.shape[-1] + eps)
            vc2 = beta * vc + (1 - beta) * (s2 * _sq_einsum(g, g.ndim - 2)
                                            / g.shape[-2] + eps)
            denom = torch.clamp(vr2.mean(-1, keepdim=True), min=eps)
            r_fac = torch.rsqrt(torch.clamp(vr2 / denom, min=eps))[..., None]
            c_fac = torch.rsqrt(torch.clamp(vc2, min=eps))[..., None, :]
            u = rms_clip(g.float() * scale * r_fac * c_fac)
            newp = (1.0 - lr * wd) * p.float() - lr * u
            return newp.to(p.dtype), vr2, vc2
        vr2 = beta * vr + (1 - beta) * (s2 * g.float() ** 2 + eps)
        u = g.float() * scale * torch.rsqrt(torch.clamp(vr2, min=eps))
        u = rms_clip(u)
        newp = (1.0 - lr * wd) * p.float() - lr * u
        return newp.to(p.dtype), vr2, vc

    def upd_leaf(p, g, vr, vc):
        if p.numel() * 4 <= stream_bytes:
            return upd(p, g, vr, vc)
        if p.ndim >= 3:
            outs = [upd(p[i], g[i], vr[i], vc[i]) for i in range(p.shape[0])]
            return tuple(torch.stack(o) for o in zip(*outs))
        rows = p.shape[0]
        chunks = 1
        for c in (64, 32, 16, 8, 4, 2):
            if rows % c == 0 and p.numel() * 4 // c <= stream_bytes:
                chunks = c
                break
        n = rows // chunks
        pieces = [slice(i * n, (i + 1) * n) for i in range(chunks)]
        vc_parts = torch.stack([_sq_einsum(g[sl], 0) / n for sl in pieces])
        vc2 = beta * vc + (1 - beta) * (s2 * vc_parts.mean(0) + eps)
        # two passes: (1) the row statistics per chunk, (2) the update with
        # their mean over the whole leaf
        vr2 = torch.stack([beta * vr[sl] + (1 - beta)
                           * (s2 * _sq_einsum(g[sl], 1) / g.shape[-1] + eps)
                           for sl in pieces])
        denom = torch.clamp(vr2.mean(), min=eps)
        c_fac = torch.rsqrt(torch.clamp(vc2, min=eps))[None, :]
        newp = []
        for i, sl in enumerate(pieces):
            r_fac = torch.rsqrt(torch.clamp(vr2[i] / denom, min=eps))[..., None]
            u = rms_clip(g[sl].float() * scale * r_fac * c_fac)
            newp.append(((1.0 - lr * wd) * p[sl].float() - lr * u).to(p.dtype))
        return torch.cat(newp), vr2.reshape(vr.shape), vc2

    outs = tree_map(upd_leaf, params, grads, state["vr"], state["vc"])
    return _part(outs, 0), {"vr": _part(outs, 1), "vc": _part(outs, 2),
                            "count": cnt}, gn


# -------------------------------------------------------------------- factory
def sgd(lr=1e-2, **kw) -> Optimizer:
    return Optimizer("sgd", _sgd_init, partial(_sgd_update, **kw), lr=lr)


def adamw(lr=3e-4, **kw) -> Optimizer:
    return Optimizer("adamw", _adamw_init, partial(_adamw_update, **kw), lr=lr)


def adamw8bit(lr=3e-4, **kw) -> Optimizer:
    return Optimizer("adamw8bit", _adamw8_init, partial(_adamw8_update, **kw),
                     lr=lr)


def adafactor(lr=1e-2, **kw) -> Optimizer:
    return Optimizer("adafactor", _adafactor_init,
                     partial(_adafactor_update, **kw), lr=lr)


def make_optimizer(name: str, lr: Optional[float] = None) -> Optimizer:
    """The optimizer ``name`` with its default settings; ``lr`` overrides
    its learning rate."""
    table = {"sgd": sgd, "adamw": adamw, "adamw8bit": adamw8bit,
             "adafactor": adafactor}
    opt = table[name]()
    if lr is not None:
        opt = dataclasses.replace(opt, lr=lr)
    return opt

