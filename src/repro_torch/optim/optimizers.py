"""Optimizers on parameter trees (nested dicts and lists of tensors).

The reference's ``repro.optim.optimizers`` in PyTorch: each optimizer
exposes

  init(params) -> state                 (zeros beside the parameters)
  state_spec(param_spec) -> PSpec tree  (the state's shapes and logical
                                         axes, so it shards like the
                                         reference's; zeros, as ``init``)
  abstract_state(param_spec)            (meta tensors of the state)
  update(grads, state, params, lr) -> (new_params, new_state, grad_norm)

``update`` runs on plain tensors and on DTensor leaves alike (a sharded
leaf's sum of squares is reduced to a replicated scalar before the norm).

Updates are functional (new tensors), as in the reference, so a caller can
drop a step's update and keep the old parameters. Implemented: SGD with
momentum, AdamW (f32 master weights and moments), AdamW-8bit (block-
quantized moments, an f32 master) and Adafactor (factored second moment,
with the reference's streamed paths for big leaves), and
``make_optimizer``, the reference's table by name.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.dist.sharding import mesh_tensor
from repro_torch.models.spec import PSpec, abstract, tree_map as _spec_map

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


def _replicated(x: torch.Tensor) -> torch.Tensor:
    """A DTensor reduction (a ``Partial`` sum over its sharded axes)
    reduced to a replicated value; a plain tensor as it is."""
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
    return x


def _loc(x):
    """A replicated DTensor scalar's local value; anything else as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def _local_leaves(fn: Callable, *trees):
    """``tree_map(fn, *trees)`` for an elementwise ``fn``. Where the leaves
    are DTensors, which must share one mesh, shape and placements, ``fn``
    runs on their local shards and its outputs (a tensor or a tuple) take
    the same placements: one call per leaf instead of a DTensor dispatch
    per op. Scalars ``fn`` closes over must be local (:func:`_loc`)."""
    def go(*xs):
        if not isinstance(xs[0], DTensor):
            return fn(*xs)
        mesh, plc, shape = xs[0].device_mesh, xs[0].placements, xs[0].shape
        if any(not isinstance(x, DTensor) or x.placements != plc
               or x.shape != shape for x in xs):
            raise ValueError(f"leaves of shape {tuple(shape)} differ in "
                             f"placement: {[getattr(x, 'placements', None) for x in xs]}")
        out = fn(*(x.to_local() for x in xs))

        def wrap(o):
            return DTensor.from_local(o, mesh, plc, run_check=False)
        return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)
    return tree_map(go, *trees)


def global_norm_clip(grads, max_norm: float):
    """(grads scaled to global norm ≤ ``max_norm``, in f32; the norm)."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(_replicated(torch.sum(torch.square(g.float())))
                        for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    sc = _loc(scale)
    return _local_leaves(lambda g: g.float() * sc, grads), gn


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable            # params -> state
    update: Callable          # (grads, state, params, lr) -> (params, state, gn)
    lr: float = 1e-3
    state_spec: Optional[Callable] = None   # param PSpec tree -> state's

    def abstract_state(self, param_spec):
        return abstract(self.state_spec(param_spec))


def _count(params) -> torch.Tensor:
    ref = tree_leaves(params)[0]
    return mesh_tensor(ref, lambda s: torch.zeros(s, dtype=torch.int32,
                                                  device=ref.device), ())


def _f32_spec(s: PSpec) -> PSpec:
    return PSpec(s.shape, s.logical, init="zeros", dtype=torch.float32)


_COUNT = PSpec((), (), init="zeros", dtype=torch.int32)


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


# --------------------------------------------------------------- SGD momentum
def _sgd_init(params) -> dict:
    return {"mom": _zeros_f32(params), "count": _count(params)}


def _sgd_update(grads, state, params, lr, *, beta=0.9, clip=1.0):
    g32, gn = global_norm_clip(grads, clip)
    mom = _local_leaves(lambda m, g: beta * m + g, state["mom"], g32)
    new_p = _local_leaves(lambda p, m: (p.float() - lr * m).to(p.dtype),
                          params, mom)
    return new_p, {"mom": mom, "count": state["count"] + 1}, gn


def _sgd_spec(pspec) -> dict:
    return {"mom": _spec_map(_f32_spec, pspec), "count": _COUNT}


# -------------------------------------------------------------------- AdamW
def _adamw_spec(pspec) -> dict:
    return {"m": _spec_map(_f32_spec, pspec), "v": _spec_map(_f32_spec, pspec),
            "master": _spec_map(_f32_spec, pspec), "count": _COUNT}


def _adamw_init(params) -> dict:
    return {"m": _zeros_f32(params), "v": _zeros_f32(params),
            "master": _zeros_f32(params), "count": _count(params)}


def _adamw_update(grads, state, params, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                  wd=0.1, clip=1.0):
    g32, gn = global_norm_clip(grads, clip)
    cnt = state["count"] + 1
    t = cnt.float()
    bc1, bc2, first = (_loc(x) for x in (1.0 - torch.pow(b1, t),
                                         1.0 - torch.pow(b2, t), cnt == 1))

    def upd(g, m_, v_, ms, p):
        m = b1 * m_ + (1 - b1) * g
        v = b2 * v_ + (1 - b2) * g * g
        # master==0 at step 1 means "adopt current params" (init-free warm
        # start)
        ms = torch.where(first, p.float(), ms)
        ms = ms - lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * ms)
        return ms.to(p.dtype), m, v, ms

    outs = _local_leaves(upd, g32, state["m"], state["v"], state["master"],
                         params)
    return _part(outs, 0), {"m": _part(outs, 1), "v": _part(outs, 2),
                            "master": _part(outs, 3), "count": cnt}, gn


# --------------------------------------------------------------- AdamW 8-bit
def _q8_scale_shape(shape) -> tuple:
    if not shape:
        return (1,)
    last = shape[-1]
    return tuple(shape[:-1]) + (max(1, (last + QBLOCK - 1) // QBLOCK),)


def _adamw8_spec(pspec) -> dict:
    def q8(s):
        return PSpec(s.shape, s.logical, init="zeros", dtype=torch.int8)

    def sc(s):
        return PSpec(_q8_scale_shape(s.shape),
                     tuple(s.logical[:-1]) + (None,) if s.shape else (None,),
                     init="zeros", dtype=torch.float32)
    return {"m_q": _spec_map(q8, pspec), "m_s": _spec_map(sc, pspec),
            "v_q": _spec_map(q8, pspec), "v_s": _spec_map(sc, pspec),
            "master": _spec_map(_f32_spec, pspec), "count": _COUNT}


def _adamw8_init(params) -> dict:
    def q8(p):
        return torch.zeros_like(p, dtype=torch.int8)

    def sc(p):
        return mesh_tensor(p, lambda s: torch.zeros(s, dtype=torch.float32,
                                                    device=p.device),
                           _q8_scale_shape(tuple(p.shape)))
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
def _adafactor_spec(pspec) -> dict:
    def vr(s):
        if len(s.shape) >= 2:
            return PSpec(s.shape[:-1], s.logical[:-1], init="zeros",
                         dtype=torch.float32)
        return _f32_spec(s)

    def vc(s):
        if len(s.shape) >= 2:
            return PSpec(s.shape[:-2] + s.shape[-1:],
                         s.logical[:-2] + s.logical[-1:], init="zeros",
                         dtype=torch.float32)
        return PSpec((1,), (None,), init="zeros", dtype=torch.float32)
    return {"vr": _spec_map(vr, pspec), "vc": _spec_map(vc, pspec),
            "count": _COUNT}


def _adafactor_init(params) -> dict:
    def zeros(p, shape):
        return mesh_tensor(p, lambda s: torch.zeros(s, dtype=torch.float32,
                                                    device=p.device), shape)

    def vr(p):
        return zeros(p, p.shape[:-1] if p.ndim >= 2 else p.shape)

    def vc(p):
        return zeros(p, (p.shape[:-2] + p.shape[-1:]) if p.ndim >= 2
                     else (1,))
    return {"vr": tree_map(vr, params), "vc": tree_map(vc, params),
            "count": _count(params)}


def _sq_einsum(g: torch.Tensor, axis: Optional[int] = None) -> torch.Tensor:
    """Σ g² over one axis (every axis when None), in f32. The reference multiplies bf16 operands
    with f32 accumulation; a product of two bf16 values is exact in f32, so
    upcasting first changes only the order of the sum."""
    gf = g.float()
    return (gf * gf).sum() if axis is None else (gf * gf).sum(axis)


def _f32_copy(t: torch.Tensor) -> torch.Tensor:
    """A fresh f32 copy of ``t`` (``float()`` of an f32 tensor is itself)."""
    return t.to(torch.float32, copy=True)


class _Local:
    """A leaf's local shard, its global offset, and sums over the ranks
    that hold the leaf's other blocks. A plain tensor is its own shard."""

    def __init__(self, t: torch.Tensor, placements=None):
        self.shape = tuple(t.shape)
        if not isinstance(t, DTensor):
            self.mesh, self.plc, self.t = None, (), t
            self.offset = (0,) * t.ndim
            return
        if placements is not None and list(t.placements) != list(placements):
            raise ValueError(f"a leaf of shape {self.shape} is placed "
                             f"{t.placements}, its update needs "
                             f"{list(placements)}")
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        self.mesh, self.plc, self.t = t.device_mesh, tuple(t.placements), \
            t.to_local()
        _, self.offset = compute_local_shape_and_global_offset(
            t.shape, self.mesh, self.plc)

    def sharding(self, dim: int) -> list:
        """The mesh dims that shard tensor dim ``dim``."""
        nd = len(self.shape)
        return [i for i, p in enumerate(self.plc)
                if isinstance(p, Shard) and p.dim % nd == dim % nd]

    def sum(self, x: torch.Tensor, dims) -> torch.Tensor:
        """``x``, a partial sum over this shard's part of tensor dims
        ``dims``, summed over the ranks that hold the other parts."""
        if self.mesh is None:
            return x
        from torch.distributed import _functional_collectives as funcol
        for i in sorted({i for d in dims for i in self.sharding(d)}):
            x = funcol.wait_tensor(funcol.all_reduce(x, "sum",
                                                     (self.mesh, i)))
        return x

    def placements_without(self, dim: int) -> list:
        """The placements of this leaf's statistics over all dims but
        ``dim``: a shard of a dim past ``dim`` moves down by one."""
        nd = len(self.shape)
        out = []
        for p in self.plc:
            d = p.dim % nd if isinstance(p, Shard) else None
            out.append(Replicate() if d is None or d == dim
                       else Shard(d - (d > dim)))
        return out

    def wrap(self, local: torch.Tensor, plc, shape) -> torch.Tensor:
        if self.mesh is None:
            return local
        return DTensor.from_local(local, self.mesh, plc, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _row_pieces(rows: int, start: int, size: int):
    """``(a, b, k)``: the local rows ``[a, b)`` of a shard of ``rows``
    rows that starts at global row ``start``, cut where global pieces of
    ``size`` rows end; ``k`` is the global piece."""
    a = 0
    while a < rows:
        k = (start + a) // size
        b = min(rows, (k + 1) * size - start)
        yield a, b, k
        a = b


def _streamed_sq(g: torch.Tensor, stream_bytes: int) -> torch.Tensor:
    """Σ g² of a big leaf, in f32, one piece of its leading axis at a time
    (at most ``stream_bytes`` of f32), summed over the ranks of a sharded
    leaf: a replicated scalar."""
    loc = _Local(g)
    t = loc.t
    per_row = max(1, t[0].numel() * 4) if t.shape[0] else 1
    step = max(1, stream_bytes // per_row)
    acc = torch.zeros((), dtype=torch.float32, device=t.device)
    with torch.no_grad():
        for a in range(0, t.shape[0], step):
            piece = _f32_copy(t[a:a + step]).reshape(-1)
            acc = acc + torch.dot(piece, piece)
    acc = loc.sum(acc, range(t.ndim))
    return loc.wrap(acc, [Replicate()] * len(loc.plc), ())


def _adafactor_update(grads, state, params, lr, *, decay=0.8, eps=1e-30,
                      clip=1.0, wd=0.0, stream_bytes=1 << 27):
    """Adafactor as the reference computes it.

    * global-norm clip folded into the per-leaf update
    * factored second-moment statistics for leaves of ndim >= 2
    * leaves of more than ``stream_bytes`` in f32 are streamed as the
      reference's ``jax.lax.map`` streams them, one piece at a time, so
      each f32 temporary is one piece: a leaf of ndim >= 3 per slice of its
      leading axis (its relative-RMS clip is per slice), a 2-D leaf in up
      to 64 chunks of rows (the clip is per chunk; the row statistics'
      mean and the column statistics, the mean of the chunks' means, stay
      whole-leaf).

    A streamed leaf that is a DTensor is walked over the pieces of its
    local shard, written into a local output: nothing slices the DTensor
    or concatenates pieces (either would gather the leaf). The statistics
    that span shards (the sums behind the row and column statistics, the
    rows' mean, each piece's RMS) are summed over the ranks that hold the
    leaf's other blocks explicitly, once per leaf and pass.
    """
    # each leaf's Σg² over all its dims at once (a reshape(-1) of a sharded
    # leaf would gather it); a big leaf's one piece at a time
    def leaf_sq(g):
        if g.numel() * 4 > stream_bytes and g.ndim >= 2:
            return _streamed_sq(g, stream_bytes)
        return _replicated(_sq_einsum(g))

    gn = torch.sqrt(sum(leaf_sq(g) for g in tree_leaves(grads)))
    scale = torch.clamp(clip / torch.clamp(gn, min=1e-9), max=1.0)
    cnt = state["count"] + 1
    t = cnt.float()
    beta = 1.0 - torch.pow(t, -decay)
    s2 = scale * scale

    def rms_clip(u):
        return u / torch.clamp(torch.sqrt(torch.mean(u * u) + 1e-12),
                               min=1.0)

    def new_param(p, u):
        return ((1.0 - lr * wd) * p.float() - lr * u).to(p.dtype)

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
            return new_param(p, u), vr2, vc2
        vr2 = beta * vr + (1 - beta) * (s2 * g.float() ** 2 + eps)
        u = g.float() * scale * torch.rsqrt(torch.clamp(vr2, min=eps))
        return new_param(p, rms_clip(u)), vr2, vc

    sc, bt, lr_, s2_ = (_loc(x) for x in (scale, beta, lr, s2))

    @torch.no_grad()
    def upd_streamed(p, g, vr, vc, chunks):
        """One big leaf, one piece of its local shard at a time: pieces are
        slices of the leading axis (``chunks`` None) or ``chunks`` pieces
        of rows (2-D)."""
        P = _Local(p)
        shape, nd = P.shape, len(P.shape)
        size, n_pieces = ((1, shape[0]) if chunks is None     # slices
                          else (shape[0] // chunks, chunks))  # row chunks
        # the statistics are placed as the leaf without its last (vr) or
        # next-to-last (vc) axis, the gradient as the leaf
        vr_plc, vc_plc = (P.placements_without(nd - 1),
                          P.placements_without(nd - 2))
        lg = _Local(g, P.plc).t
        VR, VC = _Local(vr, vr_plc), _Local(vc, vc_plc)
        lp = P.t
        pieces = list(_row_pieces(lp.shape[0], P.offset[0], size))
        dev = lp.device
        # pass 1: the sums of squares behind the row and column statistics
        rowsq = torch.empty(lp.shape[:-1], dtype=torch.float32, device=dev)
        if chunks is None:
            colsq = torch.empty(lp.shape[:-2] + lp.shape[-1:],
                                dtype=torch.float32, device=dev)
        else:
            colsq = torch.zeros(lp.shape[-1:], dtype=torch.float32,
                                device=dev)
        for a, b, _ in pieces:
            sq = _f32_copy(lg[a:b]).square_()
            rowsq[a:b] = sq.sum(-1)
            if chunks is None:
                colsq[a:b] = sq.sum(-2)
            else:   # the chunk's column means, summed over the chunks
                colsq += sq.sum(0) / size
            del sq
        # the statistics, in place in those buffers (the reference's
        # beta·v + (1 - beta)·(s2·Σ/n + eps), its sums in its order)
        vr2 = P.sum(rowsq, [nd - 1]).mul_(s2_).div_(shape[-1]).add_(eps)
        vr2 = vr2.mul_(1 - bt).add_(bt * VR.t)
        if chunks is None:
            vc2 = P.sum(colsq, [nd - 2]).mul_(s2_).div_(shape[-2])
        else:   # s2 times the mean of the chunks' means
            vc2 = P.sum(colsq, [0]).div_(chunks).mul_(s2_)
        vc2 = vc2.add_(eps).mul_(1 - bt).add_(bt * VC.t)
        # the rows' mean: per slice (over its rows), or over the whole leaf
        if chunks is None:
            denom = P.sum(vr2.sum(-1, keepdim=True), [nd - 2]) / shape[-2]
        else:
            denom = P.sum(vr2.sum(), [0]) / shape[0]
        denom = torch.clamp(denom, min=eps)
        r_fac = torch.div(vr2, denom).clamp_(min=eps).rsqrt_()[..., None]
        c_fac = vc2.clamp(min=eps).rsqrt_()
        c_fac = c_fac[..., None, :] if chunks is None else c_fac[None, :]
        n_elem = math.prod(shape) // n_pieces

        def u_of(a, b):
            u = _f32_copy(lg[a:b]).mul_(sc).mul_(r_fac[a:b])
            return u.mul_(c_fac[a:b] if chunks is None else c_fac)

        # pass 2: each piece's Σu², summed over the piece's ranks
        usq = torch.zeros(n_pieces, dtype=torch.float32, device=dev)
        for a, b, k in pieces:
            u = u_of(a, b).reshape(-1)
            usq[k] += torch.dot(u, u)
            del u
        rms = torch.sqrt(P.sum(usq, range(nd)) / n_elem + 1e-12)
        div = torch.clamp(rms, min=1.0)
        # pass 3: the update, written into the local output
        out = torch.empty_like(lp)
        for a, b, k in pieces:
            u = u_of(a, b).div_(div[k]).mul_(lr_)
            w = _f32_copy(lp[a:b]).mul_(1.0 - lr_ * wd).sub_(u)
            out[a:b].copy_(w)
            del u, w
        return (P.wrap(out, P.plc, shape), VR.wrap(vr2, vr_plc, vr.shape),
                VC.wrap(vc2, vc_plc, vc.shape))

    def upd_leaf(p, g, vr, vc):
        if p.numel() * 4 <= stream_bytes or p.ndim < 2:
            return upd(p, g, vr, vc)
        if p.ndim >= 3:
            return upd_streamed(p, g, vr, vc, None)
        chunks = next((c for c in (64, 32, 16, 8, 4, 2) if p.shape[0] % c == 0
                       and p.numel() * 4 // c <= stream_bytes), 1)
        if chunks == 1:
            return upd(p, g, vr, vc)
        return upd_streamed(p, g, vr, vc, chunks)

    outs = tree_map(upd_leaf, params, grads, state["vr"], state["vc"])
    return _part(outs, 0), {"vr": _part(outs, 1), "vc": _part(outs, 2),
                            "count": cnt}, gn

# -------------------------------------------------------------------- factory
def sgd(lr=1e-2, **kw) -> Optimizer:
    return Optimizer("sgd", _sgd_init, partial(_sgd_update, **kw), lr=lr,
                     state_spec=_sgd_spec)


def adamw(lr=3e-4, **kw) -> Optimizer:
    return Optimizer("adamw", _adamw_init, partial(_adamw_update, **kw), lr=lr,
                     state_spec=_adamw_spec)


def adamw8bit(lr=3e-4, **kw) -> Optimizer:
    return Optimizer("adamw8bit", _adamw8_init, partial(_adamw8_update, **kw),
                     lr=lr, state_spec=_adamw8_spec)


def adafactor(lr=1e-2, **kw) -> Optimizer:
    return Optimizer("adafactor", _adafactor_init,
                     partial(_adafactor_update, **kw), lr=lr,
                     state_spec=_adafactor_spec)


def make_optimizer(name: str, lr: Optional[float] = None) -> Optimizer:
    """The optimizer ``name`` with its default settings; ``lr`` overrides
    its learning rate."""
    table = {"sgd": sgd, "adamw": adamw, "adamw8bit": adamw8bit,
             "adafactor": adafactor}
    opt = table[name]()
    if lr is not None:
        opt = dataclasses.replace(opt, lr=lr)
    return opt

