"""GAT's attention aggregation over the ELL buckets: the CUDA kernels, their
wrappers, their plain twins, and the differentiable entry point.

For ``z`` (n, H, F) and the scores ``u``, ``v`` (n, H), over the edges j→i
of the batch's adjacency A whose weight is not 0 (``w == 0`` marks padding:
the padded COO's edges into row 0 and the buckets' empty slots) and one
self loop a row::

    e_ij = LeakyReLU_0.2(u_j + v_i),  α_ij = softmax over the row of e_ij,
    o_i  = Σ_j α_ij z_j                                     (each head)

:func:`gat_attention` returns ``o`` with the heads concatenated (n, H·F) or
averaged (n, F). It is a ``torch.autograd.Function`` in the setup_context
style, so ``torch.func.vjp`` takes it; its backward gives the cotangents of
``z``, ``u`` and ``v`` and needs the bucketed Aᵀ (``with_transpose=True``).

The ELL buckets split a row of more than ``K_max`` edges into pieces, which
may lie in two buckets (row 0 of a padded COO has thousands). The softmax
needs a row whole, so :func:`attention_plan` lists, once a batch, each
row's pieces (``Pieces``: ``ptr`` (n+1,) and ``code`` = slot row << 2 |
bucket), with no host synchronisation, and leaves out the pieces that hold
no real edge. The kernels (``csrc/gat_attention.cu``) walk a row's pieces
in that order:

* ``gat_attn_fwd``: one warp a (row, head), an online softmax (a running
  max and sum) over the self loop and the real slots, 32 slots at a time;
  writes ``o`` and the log-sum-exp ``lse`` (n, H);
* ``gat_attn_dst`` over A, for the backward: ``D_i = go_i · o_i`` (``o``
  recomputed) and ``dv_i = Σ_j c_ij α_ij (go_i·z_j − D_i)``, with ``c`` the
  LeakyReLU's slope, summed as ``−0.8 (go_i · Σ_{pre ≤ 0} α z_j − D_i Σ_{pre
  ≤ 0} α)`` since the sum with ``c = 1`` is 0;
* ``gat_attn_src`` over Aᵀ: ``dz_j = Σ_i α_ij go_i`` and ``du_j = Σ_i c_ij
  α_ij (go_i·z_j − D_i)``, ``α`` recomputed from ``u``, ``v`` and ``lse``.

Nothing of size E·H·F is written and no float is added with atomics, so a
result repeats bit for bit. On CPU tensors the wrappers run the plain twins
(:func:`attention_plain`, :func:`attention_vjp_plain`): the same formulas in
PyTorch over the same pieces. ``LAUNCHES`` counts kernel launches (never
plain calls): one a forward, two a backward.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from repro_torch import trace
from repro_torch.kernels.build import load_kernel
from repro_torch.kernels.ops import ELLGraph

LAUNCHES = 0
LAUNCHES_FORWARD = 1    # kernel launches of one forward call
LAUNCHES_BACKWARD = 2   # ... of one backward call
SLOPE = 0.2             # LeakyReLU's negative slope
MAX_BUCKETS = 4         # the kernels' bucket slots (2 bits of a code)
MAX_WIDTH = 512         # F: at most 16 columns a lane

_GRAPH = ctypes.POINTER(ctypes.c_longlong)
_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [_GRAPH] + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p]
_DST_ARGTYPES = [ctypes.c_void_p] * 7 + [_GRAPH] + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p]
_SRC_ARGTYPES = [ctypes.c_void_p] * 8 + [_GRAPH] + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p]


@dataclasses.dataclass(frozen=True)
class Pieces:
    """One direction's ELL pieces by destination row: row ``i``'s pieces
    are ``code[ptr[i]:ptr[i + 1]]``, each ``slot row << 2 | bucket``, in
    bucket order and, within a bucket, in slot-row order. (A dataclass, not
    a pytree: ``torch.func`` leaves its tensors unwrapped.)"""
    graph: ELLGraph
    ptr: torch.Tensor    # (n + 1,) int32
    code: torch.Tensor   # (P,) int32


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """The pieces of A (the forward, and the backward's ``dv``) and of Aᵀ
    (the backward's ``dz`` and ``du``; None without the transpose)."""
    fwd: Pieces
    bwd: Optional[Pieces]


def pieces(g: ELLGraph) -> Pieces:
    """Each row's pieces of ``g`` that hold a real (``w != 0``) slot, from
    a stable sort of the pieces by row; no host synchronisation."""
    if len(g.bucket_idx) > MAX_BUCKETS:
        raise ValueError(f"gat_attention: {len(g.bucket_idx)} buckets, the "
                         f"kernels take at most {MAX_BUCKETS}")
    n, dev = g.num_rows, g.bucket_rows[0].device
    keys, codes = [], []
    for b, (w, rows) in enumerate(zip(g.bucket_w, g.bucket_rows)):
        r = rows.shape[0] if g.bucket_real is None else g.bucket_real[b]
        if r >= 1 << 29:
            raise ValueError(f"gat_attention: bucket {b} has {r} rows; a "
                             f"piece code holds 2^29")
        keep = (w[:r] != 0).any(1) & (rows[:r] < n)
        keys.append(torch.where(keep, rows[:r].to(torch.int32), n))
        codes.append(torch.arange(r, dtype=torch.int32, device=dev) * 4 + b)
    key, order = torch.sort(torch.cat(keys), stable=True)
    ptr = torch.searchsorted(
        key, torch.arange(n + 1, dtype=key.dtype, device=dev), out_int32=True)
    return Pieces(g, ptr, torch.cat(codes)[order].contiguous())


def attention_plan(ell: ELLGraph) -> AttentionPlan:
    """The plan of a batch's ELL graph, once for all of a step's layers."""
    return AttentionPlan(pieces(ell), None if ell.transpose is None
                         else pieces(ell.transpose))


# ------------------------------------------------------------ plain twins
def _edges(p: Pieces) -> tuple:
    """``(row, col)`` of every real slot of the pieces, then one self loop
    a row, as int64."""
    g, dev = p.graph, p.ptr.device
    n = g.num_rows
    counts = (p.ptr[1:] - p.ptr[:-1]).long()
    prow = torch.repeat_interleave(torch.arange(n, device=dev), counts)
    code = p.code[:int(p.ptr[-1])].long()   # the rows' pieces: real ones
    rows, cols = [], []
    for b, (idx, w) in enumerate(zip(g.bucket_idx, g.bucket_w)):
        sel = code % 4 == b
        r = torch.div(code[sel], 4, rounding_mode="floor")
        real = w[r] != 0
        rows.append(prow[sel][:, None].expand_as(real)[real])
        cols.append(idx[r].long()[real])
    loop = torch.arange(n, device=dev)
    return torch.cat(rows + [loop]), torch.cat(cols + [loop])


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, SLOPE * x)


def attention_plain(p: Pieces, z: torch.Tensor, u: torch.Tensor,
                    v: torch.Tensor) -> tuple:
    """Plain PyTorch of ``gat_attn_fwd``: ``(o (n, H, F), lse (n, H))``."""
    row, col = _edges(p)
    e = _leaky(u[col] + v[row])
    m = e.new_full(u.shape, float("-inf")).scatter_reduce(
        0, row[:, None].expand_as(e), e, "amax")
    ex = torch.exp(e - m[row])
    s = ex.new_zeros(u.shape).index_add_(0, row, ex)
    o = z.new_zeros(z.shape).index_add_(0, row, ex[..., None] * z[col])
    return o / s[..., None], m + torch.log(s)


def dst_plain(p: Pieces, z: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
              lse: torch.Tensor, go: torch.Tensor) -> tuple:
    """Plain PyTorch of ``gat_attn_dst`` over A's pieces: ``(d, dv)``."""
    row, col = _edges(p)                   # i, j
    pre = u[col] + v[row]
    a = torch.exp(_leaky(pre) - lse[row])
    an = torch.where(pre > 0, 0.0, a)
    o = z.new_zeros(z.shape).index_add_(0, row, a[..., None] * z[col])
    on = z.new_zeros(z.shape).index_add_(0, row, an[..., None] * z[col])
    d = (go * o).sum(-1)
    dv = -(1.0 - SLOPE) * ((go * on).sum(-1)
                           - d * an.new_zeros(u.shape).index_add_(0, row, an))
    return d, dv


def src_plain(p: Pieces, z: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
              lse: torch.Tensor, go: torch.Tensor, d: torch.Tensor) -> tuple:
    """Plain PyTorch of ``gat_attn_src`` over Aᵀ's pieces: ``(dz, du)``."""
    row, col = _edges(p)                   # j, i
    pre = u[row] + v[col]
    a = torch.exp(_leaky(pre) - lse[col])
    ca = torch.where(pre > 0, a, SLOPE * a)
    dz = z.new_zeros(z.shape).index_add_(0, row, a[..., None] * go[col])
    gsum = z.new_zeros(z.shape).index_add_(0, row, ca[..., None] * go[col])
    du = (z * gsum).sum(-1) - ca.new_zeros(u.shape).index_add_(
        0, row, ca * d[col])
    return dz, du


def attention_vjp_plain(plan: AttentionPlan, z: torch.Tensor,
                        u: torch.Tensor, v: torch.Tensor, lse: torch.Tensor,
                        go: torch.Tensor) -> tuple:
    """:func:`dst_plain` then :func:`src_plain`: ``(dz, du, dv)`` for the
    output's cotangent ``go`` (n, H, F)."""
    d, dv = dst_plain(plan.fwd, z, u, v, lse, go)
    dz, du = src_plain(plan.bwd, z, u, v, lse, go, d)
    return dz, du, dv


# ------------------------------------------------------------ the kernels
def _graph_arg(p: Pieces):
    """The direction as the host array the kernels read: the pieces'
    pointers, the bucket count, then per bucket its idx and w pointers and
    its width K."""
    g = p.graph
    pad = MAX_BUCKETS - len(g.bucket_idx)
    vals = [p.ptr.data_ptr(), p.code.data_ptr(), len(g.bucket_idx)]
    vals += [t.data_ptr() for t in g.bucket_idx] + [0] * pad
    vals += [t.data_ptr() for t in g.bucket_w] + [0] * pad
    vals += [int(t.shape[1]) for t in g.bucket_idx] + [0] * pad
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch(symbol: str, argtypes: list, tensors: tuple, p: Pieces,
            z: torch.Tensor) -> None:
    """One launch on the current stream of ``z``'s card."""
    g = p.graph
    if not all(t.is_contiguous() for t in (*g.bucket_idx, *g.bucket_w)):
        raise ValueError(f"{symbol}: the ELL buckets must be contiguous")
    n, heads, width = z.shape
    fn = load_kernel("gat_attention", symbol, argtypes)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in tensors), _graph_arg(p), n, heads,
                width, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol}: kernel launch failed with CUDA error "
                           f"{rc} (n={n}, H={heads}, F={width})")
    global LAUNCHES
    LAUNCHES += 1


def _plain_path(z: torch.Tensor) -> bool:
    """Whether the plain twins run: for CPU tensors."""
    return z.device.type == "cpu"


def _check(z: torch.Tensor, *others: torch.Tensor) -> None:
    if z.dim() != 3 or z.shape[2] > MAX_WIDTH:
        raise ValueError(f"gat_attention: z {tuple(z.shape)} must be (n, H, "
                         f"F) with F <= {MAX_WIDTH}")
    if len({t.device for t in (z, *others)}) != 1:
        raise ValueError("gat_attention: inputs on several devices")
    if z.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gat_attention: no kernel for device {z.device}")
    kinds = (torch.float32,) if z.device.type == "cuda" \
        else (torch.float32, torch.float64)
    if any(t.dtype not in kinds or t.dtype != z.dtype for t in others) \
            or z.dtype not in kinds:
        raise TypeError(f"gat_attention: z, u, v and the cotangent must be "
                        f"one of {kinds} on {z.device.type}")


def attention_forward(p: Pieces, z: torch.Tensor, u: torch.Tensor,
                      v: torch.Tensor) -> tuple:
    """``(o, lse)`` over A's pieces: one ``gat_attn_fwd`` launch on CUDA
    tensors, :func:`attention_plain` on CPU tensors."""
    _check(z, u, v)
    if _plain_path(z):
        return attention_plain(p, z, u, v)
    z, u, v = z.contiguous(), u.contiguous(), v.contiguous()
    o, lse = torch.empty_like(z), torch.empty_like(u)
    _launch("repro_gat_attn_fwd", _FWD_ARGTYPES, (z, u, v, o, lse), p, z)
    return o, lse


def attention_backward(plan: AttentionPlan, z: torch.Tensor, u: torch.Tensor,
                       v: torch.Tensor, lse: torch.Tensor,
                       go: torch.Tensor) -> tuple:
    """``(dz, du, dv)``: ``gat_attn_dst`` over A, then ``gat_attn_src``
    over Aᵀ, on CUDA tensors; :func:`attention_vjp_plain` on CPU
    tensors."""
    if plan.bwd is None:
        raise ValueError("gat_attention: gradient requested but the ELLGraph "
                         "was built with with_transpose=False; the backward "
                         "walks the bucketed Aᵀ")
    _check(z, u, v, lse, go)
    if _plain_path(z):
        return attention_vjp_plain(plan, z, u, v, lse, go)
    z, u, v, go = z.contiguous(), u.contiguous(), v.contiguous(), \
        go.contiguous()
    d, dv = torch.empty_like(u), torch.empty_like(u)
    dz, du = torch.empty_like(z), torch.empty_like(u)
    _launch("repro_gat_attn_dst", _DST_ARGTYPES, (z, u, v, lse, go, d, dv),
            plan.fwd, z)
    _launch("repro_gat_attn_src", _SRC_ARGTYPES,
            (z, u, v, lse, go, d, dz, du), plan.bwd, z)
    return dz, du, dv


def _unwrapped(t: torch.Tensor) -> torch.Tensor:
    """``t`` without functorch's wrappers: under ``torch.func.vjp`` the saved
    tensors reach the backward wrapped, with no storage a kernel can read.
    The backward is not differentiated again, so nothing is lost."""
    while torch._C._functorch.is_functorch_wrapped_tensor(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t


class _Attention(torch.autograd.Function):
    """``(o, lse)``; the backward recomputes ``α`` from ``u``, ``v`` and the
    saved ``lse``. ``lse`` is not differentiable."""

    @staticmethod
    def forward(plan, z, u, v):
        with trace.span("gat.attention"):
            return attention_forward(plan.fwd, z, u, v)

    @staticmethod
    def setup_context(ctx, inputs, output):
        plan, z, u, v = inputs
        ctx.plan = plan
        ctx.save_for_backward(z, u, v, output[1])
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, go, _):
        z, u, v, lse = map(_unwrapped, ctx.saved_tensors)
        with trace.span("gat.attention.vjp"):
            dz, du, dv = attention_backward(ctx.plan, z, u, v, lse, go)
        return None, dz, du, dv


def gat_attention(z: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  plan: AttentionPlan, *, concat: bool = True) -> torch.Tensor:
    """GAT's attention aggregation over the batch's ELL graph, given as its
    :class:`AttentionPlan` (:func:`attention_plan`, once a batch): ``z``
    (n, H, F), ``u``, ``v`` (n, H) -> (n, H·F) with the heads concatenated,
    (n, F) averaged. f32; differentiable in ``z``, ``u`` and ``v``."""
    o, _ = _Attention.apply(plan, z, u, v)
    return o.reshape(o.shape[0], -1) if concat else o.mean(1)
