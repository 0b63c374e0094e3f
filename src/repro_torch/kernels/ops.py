"""Degree-bucketed ELL: host construction and the differentiable kernel wrappers.

`bucketed_spmm` is the deployable aggregation: rows are degree-bucketed host
side (powers of two) so ELL padding waste stays < 2x, each bucket runs one
`ell_spmm` launch, and an `index_add_` sums every bucket's partial rows into
an (n+1, D) buffer whose last row catches the padding rows and is dropped.

`lmc_compensate` is the entry point of the fused gather+lerp compensation
kernel (Eq. 9/12). Neither wrapper pads D or copies the store: the kernels
mask the tail themselves.

Both are `torch.autograd.Function`s (setup_context style, so `torch.func.vjp`
takes them too), with the reference's custom VJPs: the SpMM's backward is the
same kernel over the bucketed Aᵀ, the compensation's a gather/scatter in
plain PyTorch. `stream` keeps the reference's knob: None/True run the
streaming kernels, False the resident-source kernels (small sources only).

`build_ell` / `ell_from_coo` are the reference's bulk-numpy preprocessors,
copied so that the bucket arrays equal the reference's exactly; they return
CPU tensors, or numpy arrays with ``as_torch=False``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.compensate import (lmc_compensate_kernel,
                                            lmc_compensate_resident)
from repro_torch.kernels.ell_spmm import ell_spmm, ell_spmm_resident


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class ELLCapacityError(ValueError):
    """A bucket's real row count exceeds its fixed padded capacity.

    Raised by the host-side constructors (``build_ell``/``ell_from_coo``) when
    ``row_capacity`` is given and a degree bucket would need more rows than
    the fixed shape allows — the alternative, silent truncation, would drop
    edges and corrupt aggregations. Catch it to rebuild with larger
    capacities (or let ``fixed_capacity=True`` derive worst-case ones).
    """


@dataclasses.dataclass(frozen=True)
class ELLGraph:
    """Degree-bucketed padded-ELL adjacency (host-built tensors).

    ``transpose`` (the bucketed Aᵀ, for the SpMM's backward pass) is an
    ELLGraph itself, built only on request (``with_transpose=True``): the
    forward-only serving path never reads it. ``to(device)`` moves it along.
    """
    bucket_idx: tuple      # per bucket: (rows_b, K_b) int32 neighbor ids
    bucket_w: tuple        # per bucket: (rows_b, K_b) f32 weights
    bucket_rows: tuple     # per bucket: (rows_b,) int32 destination rows
    num_rows: int          # output rows
    num_cols: int          # gather-source rows, == h.shape[0]
    transpose: Optional["ELLGraph"] = None

    def to(self, device) -> "ELLGraph":
        """This graph (and its transpose) with every tensor on ``device``."""
        def mv(ts):
            return tuple(torch.as_tensor(t).to(device) for t in ts)
        return ELLGraph(mv(self.bucket_idx), mv(self.bucket_w),
                        mv(self.bucket_rows), self.num_rows, self.num_cols,
                        None if self.transpose is None
                        else self.transpose.to(device))


# ------------------------------------------------------- host construction
def _ell_buckets(indptr: np.ndarray, indices: np.ndarray, weights: np.ndarray,
                 buckets: Sequence[int], block_rows: int,
                 row_capacity: Optional[Sequence[int]], as_torch: bool = True):
    """CSR -> per-bucket (idx, w, rows) arrays, fully vectorized.

    Reproduces the row order of the original per-node loop exactly: rows are
    emitted in (node, chunk) order; each chunk of ≤ kmax neighbors lands in
    the smallest bucket that fits it; deg-0 nodes emit one empty bucket-0 row.
    ``as_torch=False`` keeps the bucket arrays as numpy.
    """
    n = indptr.shape[0] - 1
    deg = np.diff(indptr).astype(np.int64)
    kmax = int(buckets[-1])

    # one row per kmax-chunk of each neighbor list (deg-0 nodes get one chunk)
    nchunks = np.maximum((deg + kmax - 1) // kmax, 1)
    row_node = np.repeat(np.arange(n, dtype=np.int64), nchunks)
    first = np.zeros(n, np.int64)
    first[1:] = np.cumsum(nchunks)[:-1]
    chunk_start = (np.arange(row_node.shape[0], dtype=np.int64)
                   - np.repeat(first, nchunks)) * kmax
    chunk_len = np.clip(deg[row_node] - chunk_start, 0, kmax)
    bucket_of = np.searchsorted(np.asarray(buckets, np.int64), chunk_len)

    b_idx, b_w, b_rows = [], [], []
    for b, k in enumerate(buckets):
        sel = np.flatnonzero(bucket_of == b)   # preserves (node, chunk) order
        rows = sel.shape[0]
        if row_capacity is not None:
            rows_pad = int(row_capacity[b])
            if rows > rows_pad:
                raise ELLCapacityError(
                    f"bucket {b} (K={k}): {rows} rows exceed capacity {rows_pad}")
        else:
            rows_pad = max(_round_up(rows, block_rows), block_rows)
        idx = np.zeros((rows_pad, k), np.int32)
        w = np.zeros((rows_pad, k), np.float32)
        rid = np.full((rows_pad,), n, np.int32)  # pad rows -> dropped
        if rows:
            if indices.shape[0]:
                base = indptr[row_node[sel]] + chunk_start[sel]
                offs = np.arange(k, dtype=np.int64)
                valid = offs[None, :] < chunk_len[sel][:, None]
                pos = np.where(valid, base[:, None] + offs[None, :], 0)
                idx[:rows] = np.where(valid, indices[pos], 0).astype(np.int32)
                w[:rows] = np.where(valid, weights[pos], 0.0).astype(np.float32)
            # else: edgeless graph — every row is an all-padding deg-0 row
            rid[:rows] = row_node[sel].astype(np.int32)
        conv = torch.from_numpy if as_torch else (lambda a: a)
        b_idx.append(conv(idx))
        b_w.append(conv(w))
        b_rows.append(conv(rid))
    return tuple(b_idx), tuple(b_w), tuple(b_rows)


def _build_ell_loop(indptr, indices, weights, buckets=(8, 32, 128),
                    block_rows: int = 256):
    """Original per-node Python-loop construction (numpy arrays out).

    Kept only as the correctness reference for the vectorized `build_ell`;
    O(n) interpreted Python — do not use on large graphs.
    """
    n = indptr.shape[0] - 1
    kmax = buckets[-1]
    b_idx, b_w, b_rows = [], [], []
    row_ids = [[] for _ in buckets]
    row_idx = [[] for _ in buckets]
    row_ws = [[] for _ in buckets]

    for v in range(n):
        lo, hi = indptr[v], indptr[v + 1]
        nbrs, ws = indices[lo:hi], weights[lo:hi]
        for s in range(0, max(len(nbrs), 1), kmax):
            part_n = nbrs[s:s + kmax]
            part_w = ws[s:s + kmax]
            b = next(i for i, k in enumerate(buckets) if len(part_n) <= k)
            k = buckets[b]
            pad = k - len(part_n)
            row_ids[b].append(v)
            row_idx[b].append(np.pad(part_n.astype(np.int32), (0, pad)))
            row_ws[b].append(np.pad(part_w.astype(np.float32), (0, pad)))

    for b, k in enumerate(buckets):
        rows = len(row_ids[b])
        rows_pad = max(_round_up(rows, block_rows), block_rows)
        idx = np.zeros((rows_pad, k), np.int32)
        w = np.zeros((rows_pad, k), np.float32)
        rid = np.full((rows_pad,), n, np.int32)
        if rows:
            idx[:rows] = np.stack(row_idx[b])
            w[:rows] = np.stack(row_ws[b])
            rid[:rows] = np.asarray(row_ids[b], np.int32)
        b_idx.append(idx)
        b_w.append(w)
        b_rows.append(rid)
    return ELLGraph(tuple(b_idx), tuple(b_w), tuple(b_rows),
                    num_rows=n, num_cols=n)


def _transpose_csr(indptr, indices, weights, num_cols):
    """CSR of A -> CSR of Aᵀ (bulk numpy: one argsort over the edge list)."""
    n = indptr.shape[0] - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    order = np.argsort(indices, kind="stable")
    counts = np.bincount(indices, minlength=num_cols)
    t_indptr = np.zeros(num_cols + 1, np.int64)
    t_indptr[1:] = np.cumsum(counts)
    return t_indptr, rows[order].astype(np.int32), \
        np.asarray(weights)[order].astype(np.float32)


def build_ell(indptr: np.ndarray, indices: np.ndarray, weights: np.ndarray,
              buckets=(8, 32, 128), block_rows: int = 256, *,
              num_cols: Optional[int] = None,
              row_capacity: Optional[Sequence[int]] = None,
              with_transpose: bool = False, as_torch: bool = True) -> ELLGraph:
    """CSR -> degree-bucketed ELL (bulk numpy, no per-node Python loop).

    Rows with deg > max(buckets) are split into multiple partial rows (their
    partial sums add in the final ``index_add_``, keeping K bounded). When
    ``with_transpose`` the transposed adjacency is bucketed too.
    ``row_capacity`` (per-bucket padded row counts, applied to both
    directions) fixes the array shapes so every batch of a sampler has one
    shape. ``block_rows`` rounds the unfixed row counts, as the reference
    does for its TPU tile height, so the buckets equal the reference's.
    """
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices)
    weights = np.asarray(weights)
    n = indptr.shape[0] - 1
    num_cols = n if num_cols is None else int(num_cols)

    idx, w, rows = _ell_buckets(indptr, indices, weights, buckets, block_rows,
                                row_capacity, as_torch)
    t = None
    if with_transpose:
        t_ptr, t_ind, t_w = _transpose_csr(indptr, indices, weights, num_cols)
        ti, tw, tr = _ell_buckets(t_ptr, t_ind, t_w, buckets, block_rows,
                                  row_capacity, as_torch)
        t = ELLGraph(ti, tw, tr, num_rows=num_cols, num_cols=n)
    return ELLGraph(idx, w, rows, num_rows=n, num_cols=num_cols, transpose=t)


def fixed_row_capacity(num_rows: int, num_edges: int, buckets=(8, 32, 128),
                       block_rows: int = 256) -> tuple:
    """Worst-case per-bucket row counts for any graph with ≤ num_edges edges
    over num_rows rows: each row emits ≤ 1 remainder chunk (any bucket) plus
    full-kmax chunks (last bucket only, ≤ E/kmax in total)."""
    caps = [max(_round_up(max(num_rows, 1), block_rows), block_rows)
            for _ in buckets]
    caps[-1] = max(_round_up(max(num_rows, 1) + num_edges // int(buckets[-1]),
                             block_rows), block_rows)
    return tuple(caps)


def ell_from_coo(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                 num_rows: int, *, buckets=(8, 32, 128),
                 block_rows: int = 256, fixed_capacity: bool = True,
                 with_transpose: bool = False,
                 as_torch: bool = True) -> ELLGraph:
    """Padded local COO (a PaddedSubgraph's edge list) -> square ELLGraph.

    Aggregation semantics match ``models.gnn.segment_spmm``: out[dst] +=
    w·h[src]; padded edges (w == 0) contribute nothing. With
    ``fixed_capacity`` the bucket shapes depend only on (num_rows, E), so all
    batches of a sampler share one shape. ``with_transpose`` also buckets
    Aᵀ (see `build_ell`).
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(w, np.float32)
    order = np.argsort(dst, kind="stable")
    counts = np.bincount(dst, minlength=num_rows)
    indptr = np.zeros(num_rows + 1, np.int64)
    indptr[1:] = np.cumsum(counts)
    caps = (fixed_row_capacity(num_rows, src.shape[0], buckets, block_rows)
            if fixed_capacity else None)
    return build_ell(indptr, src[order], w[order], buckets, block_rows,
                     num_cols=num_rows, row_capacity=caps,
                     with_transpose=with_transpose, as_torch=as_torch)


# ------------------------------------------------------------ kernel wrappers
def _spmm(bucket_idx, bucket_w, bucket_rows, num_rows: int, h: torch.Tensor,
          stream: Optional[bool]) -> torch.Tensor:
    """Σ over buckets of one kernel launch each, summed by ``index_add_``
    into an (n+1, D) buffer whose row n catches the padding rows."""
    spmm = ell_spmm_resident if stream is False else ell_spmm
    h = h.contiguous()
    out = h.new_zeros((num_rows + 1, h.shape[1]))
    for idx, w, rows in zip(bucket_idx, bucket_w, bucket_rows):
        out.index_add_(0, rows, spmm(idx, w, h))
    return out[:num_rows]


class _BucketedSpMM(torch.autograd.Function):
    """out = A h; dh = Aᵀ ct on the same kernel over the bucketed Aᵀ; the
    weight cotangents only when asked for (``ctx.needs_input_grad``)."""

    @staticmethod
    def forward(g, stream, h, *bucket_w):
        return _spmm(g.bucket_idx, bucket_w, g.bucket_rows, g.num_rows, h,
                     stream)

    @staticmethod
    def setup_context(ctx, inputs, output):
        g, stream, h, *bucket_w = inputs
        ctx.g, ctx.stream = g, stream
        ctx.w_dtypes = tuple(w.dtype for w in bucket_w)
        ctx.save_for_backward(h)

    @staticmethod
    def backward(ctx, ct):
        g = ctx.g
        (h,) = ctx.saved_tensors
        dh = None
        if ctx.needs_input_grad[2]:
            t = g.transpose
            if t is None:
                raise ValueError(
                    "bucketed_spmm: gradient requested but the ELLGraph was "
                    "built with with_transpose=False; the SpMM's backward "
                    "needs the bucketed Aᵀ")
            dh = _spmm(t.bucket_idx, t.bucket_w, t.bucket_rows, t.num_rows,
                       ct, ctx.stream)
        # dw[i,k] = ⟨ct[rows[i]], h[idx[i,k]]⟩; the zero row n of the padded
        # ct zeroes the all-padding rows (padding slots get ct·h[0], as in
        # the reference: never read back)
        dws = [None] * len(g.bucket_idx)
        if any(ctx.needs_input_grad[3:]):
            ctp = torch.cat([ct, ct.new_zeros((1, ct.shape[1]))])
            for i, (idx, rows) in enumerate(zip(g.bucket_idx,
                                                g.bucket_rows)):
                if ctx.needs_input_grad[3 + i]:
                    dws[i] = torch.einsum(
                        "rd,rkd->rk", _gather_clip(ctp, rows),
                        _gather_clip(h, idx.reshape(-1)).reshape(
                            *idx.shape, h.shape[1])).to(ctx.w_dtypes[i])
        return (None, None, dh, *dws)


def _gather_clip(buf: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """buf[ids] with ids clipped into ``[0, len(buf))`` (the reference's
    ``mode="clip"`` gather)."""
    return buf.index_select(0, ids.clamp(0, buf.shape[0] - 1))


def bucketed_spmm(g: ELLGraph, h: torch.Tensor, *,
                  stream: Optional[bool] = None) -> torch.Tensor:
    """out = A h over all degree buckets: out[i] = Σ_{j in N(i)} w_ij h[j].

    One ``ell_spmm`` launch per bucket (``stream=False``: the resident-source
    kernel ``ell_spmm_resident``); partial rows (and split heavy rows)
    combine with ``index_add_`` into an (n+1, D) buffer whose row n catches
    the padding rows. On CUDA that ``index_add_`` uses atomics, so a row
    split across buckets (degree > max bucket) sums in no fixed order.

    Differentiable (``torch.autograd`` and ``torch.func``): dh runs the same
    kernel over ``g.transpose`` with the same ``stream`` setting, so the
    graph must be built with ``with_transpose=True``; d(bucket_w) is formed
    only when a bucket weight requires grad.
    """
    return _BucketedSpMM.apply(g, stream, h, *g.bucket_w)


class _Compensate(torch.autograd.Function):
    """Eq. 9/12 on the fused kernel; the adjoint is the reference's
    gather/scatter (``d_store`` an ``index_add_`` into zeros)."""

    @staticmethod
    def forward(store, gids, beta, fresh, mask, stream):
        kernel = (lmc_compensate_resident if stream is False
                  else lmc_compensate_kernel)
        return kernel(store, gids, beta.float(), fresh.contiguous(),
                      mask.float())

    @staticmethod
    def setup_context(ctx, inputs, output):
        store, gids, beta, fresh, mask, _ = inputs
        ctx.save_for_backward(store, gids, beta, fresh, mask)

    @staticmethod
    def backward(ctx, ct):
        store, gids, beta, fresh, mask = ctx.saved_tensors
        need = ctx.needs_input_grad
        hist = _gather_clip(store, gids)
        d_store = d_beta = d_fresh = d_mask = None
        if need[0]:   # out-of-range gids are dropped, as the reference's scatter
            keep = (gids >= 0) & (gids < store.shape[0])
            d_store = torch.zeros_like(store).index_add_(
                0, gids[keep].long(),
                ((mask * (1.0 - beta))[:, None] * ct)[keep].to(store.dtype))
        if need[2]:
            d_beta = (ct * mask[:, None] * (fresh - hist)).sum(-1).to(
                beta.dtype)
        if need[3]:
            d_fresh = (ct * (mask * beta)[:, None]).to(fresh.dtype)
        if need[4]:
            d_mask = (ct * ((1.0 - beta)[:, None] * hist
                            + beta[:, None] * fresh)).sum(-1).to(mask.dtype)
        return d_store, None, d_beta, d_fresh, d_mask, None


def lmc_compensate(store: torch.Tensor, gids: torch.Tensor,
                   beta: torch.Tensor, fresh: torch.Tensor,
                   mask: torch.Tensor, *,
                   stream: Optional[bool] = None) -> torch.Tensor:
    """ĥ = mask · [(1-β)·store[gid] + β·fresh]  (Eq. 9/12), differentiable.

    store (M, D); gids/beta/mask (N,); fresh (N, D) -> (N, D). Arbitrary N
    and D; the store is read in place (never padded or copied).
    ``stream=False`` runs the resident-store kernel (small stores only).
    """
    return _Compensate.apply(store, gids, beta, fresh, mask, stream)


def ell_aggregate_fn(g: ELLGraph, *, stream: Optional[bool] = None):
    """AggregateFn adapter for repro_torch.models.gnn (ignores the COO edge
    list — the ELL graph already encodes the same adjacency)."""
    def aggregate(edges, h, num_rows):
        del edges
        out = bucketed_spmm(g, h, stream=stream)
        if out.shape[0] != num_rows:
            raise ValueError(f"ELL graph has {out.shape[0]} rows, "
                             f"expected {num_rows}")
        return out
    return aggregate
