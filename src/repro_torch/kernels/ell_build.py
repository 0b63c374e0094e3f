"""The batch's degree-bucketed ELL: planned on the host, built on its device.

``plan_ell`` is the host half: from the COO's row counts alone (two
``np.bincount``), it gives each bucket's real rows at the fixed capacities
``ops.fixed_row_capacity`` gives, and raises
:class:`~repro_torch.kernels.ops.ELLCapacityError` before anything is
launched. The :class:`ELLPlan` it returns holds Python ints only, so a batch
that carries it pins and copies its COO and no buckets.

``ELLPlan.build(src, dst, w)`` is the device half, on the device the COO
lies on. On a card (``build_torch``): a stable sort of the edges by
destination (and of those by source, for Aᵀ: the order of
``ops._transpose_csr``'s stable argsort), then per direction
:func:`ell_rows` (each row's start, each node's rows per bucket), one scan
of those counts, and :func:`ell_scatter`, which places every edge in its
bucket; nothing in it synchronises with the host. Both launch the
hand-written kernels of ``csrc/ell_build.cu`` on CUDA tensors (or raise)
and run their plain twins (:func:`ell_rows_plain`,
:func:`ell_scatter_plain`) on CPU tensors, against which the tests and
``chip_smoke.py`` hold the kernels. On the CPU, ``build`` runs the numpy
builder ``ops.build_ell`` at the plan's capacities. The buckets equal
``ops.ell_from_coo``'s bit for bit, ``bucket_real`` included. ``LAUNCHES``
counts kernel launches only: two a direction.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.build import load_kernel
from repro_torch.kernels.ops import (ELLCapacityError, ELLGraph, build_ell,
                                     fixed_row_capacity)

LAUNCHES = 0
MAX_BUCKETS = 4   # the kernel's argument slots

_LAYOUT = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
_ROWS_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + _LAYOUT
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + _LAYOUT


class Layout(NamedTuple):
    """Where each bucket of one direction lies in the flat arrays: its
    width, its padded rows, the real rows of the buckets before it
    (``first``: where its rows start in the flat scan of the row counts),
    and its first element of ``rid`` and of ``idx``/``wout``."""
    widths: tuple
    capacity: tuple
    first: tuple
    row_off: tuple
    idx_off: tuple

    @classmethod
    def of(cls, widths: tuple, capacity: tuple, real: tuple) -> "Layout":
        """The layout of buckets laid one after another."""
        def starts(sizes):
            return tuple(np.concatenate([[0], np.cumsum(sizes)[:-1]])
                         .astype(np.int64).tolist())
        return cls(tuple(widths), tuple(capacity), starts(real),
                   starts(capacity),
                   starts([c * k for c, k in zip(capacity, widths)]))


@dataclasses.dataclass(frozen=True)
class ELLPlan:
    """What the host knows of a batch's ELL before it is built: per bucket
    (``buckets``, ascending K), the padded rows (``capacity``, shared by A
    and Aᵀ) and the real rows of A (``real``) and, where the transpose is
    planned, of Aᵀ (``t_real``; None without). ``build`` makes the
    :class:`ELLGraph` on the device of the COO it is given."""
    num_rows: int
    buckets: tuple
    capacity: tuple
    real: tuple
    t_real: Optional[tuple] = None

    def build(self, src: torch.Tensor, dst: torch.Tensor,
              w: torch.Tensor) -> ELLGraph:
        """The bucketed A (and Aᵀ) of the COO ``out[dst] += w · h[src]``,
        on its device: on a card :meth:`build_torch`, with no host
        synchronisation; on the CPU the numpy builder, single-threaded,
        since the same PyTorch operations run multithreaded there and stall
        for tens of ms each on a loaded host."""
        if src.device.type != "cpu":
            return self.build_torch(src, dst, w)
        n, dst = self.num_rows, dst.numpy()
        order = np.argsort(dst, kind="stable")
        indptr = np.zeros(n + 1, np.int64)
        indptr[1:] = np.cumsum(np.bincount(dst, minlength=n))
        return build_ell(indptr, src.numpy()[order], w.numpy()[order],
                         self.buckets, num_cols=n, row_capacity=self.capacity,
                         with_transpose=self.t_real is not None)

    def build_torch(self, src: torch.Tensor, dst: torch.Tensor,
                    w: torch.Tensor) -> ELLGraph:
        """The device half in PyTorch: stable sorts, then per direction
        :func:`ell_rows`, a scan and :func:`ell_scatter` (the kernels on
        CUDA tensors, their plain twins on CPU tensors)."""
        src, dst = src.to(torch.int32), dst.to(torch.int32)
        key, order = torch.sort(dst, stable=True)
        col, wa = src[order], w.to(torch.float32)[order]
        g = _bucket(key, col, wa, self.num_rows, self.buckets,
                    self.capacity, self.real)
        if self.t_real is None:
            return g
        key_t, order_t = torch.sort(col, stable=True)
        t = _bucket(key_t, key[order_t], wa[order_t], self.num_rows,
                    self.buckets, self.capacity, self.t_real)
        return dataclasses.replace(g, transpose=t)


def _plan_rows(rows: np.ndarray, n: int, buckets: tuple,
               caps: tuple) -> tuple:
    """The real rows per bucket of the ELL whose edges have the rows
    ``rows``; raises ELLCapacityError past ``caps``."""
    deg = np.bincount(np.asarray(rows), minlength=n)
    if deg.shape[0] != n:
        raise ValueError(f"plan_ell: a row id is outside [0, {n})")
    kmax = buckets[-1]
    pieces = np.maximum((deg + kmax - 1) // kmax, 1)
    last = np.searchsorted(np.asarray(buckets), deg - (pieces - 1) * kmax)
    real = np.bincount(last, minlength=len(buckets))
    real[-1] += int((pieces - 1).sum())
    for b, (k, r, c) in enumerate(zip(buckets, real.tolist(), caps)):
        if r > c:
            raise ELLCapacityError(
                f"bucket {b} (K={k}): {r} rows exceed capacity {c}")
    return tuple(int(r) for r in real)


def plan_ell(src: np.ndarray, dst: np.ndarray, num_rows: int, *,
             buckets: Sequence[int] = (8, 32, 128),
             with_transpose: bool = False) -> ELLPlan:
    """The host half of ``ops.ell_from_coo`` on the same arguments: the
    buckets' real rows, checked against the fixed capacities
    (``fixed_row_capacity``, shared by A and Aᵀ, as there), in O(E + n) and
    with no (rows × K) array."""
    buckets = tuple(int(k) for k in buckets)
    if not 1 <= len(buckets) <= MAX_BUCKETS or any(
            a >= b for a, b in zip(buckets, buckets[1:])) or buckets[0] < 1:
        raise ValueError(f"plan_ell: buckets {buckets} must be 1 to "
                         f"{MAX_BUCKETS} ascending positive widths")
    caps = fixed_row_capacity(num_rows, int(np.shape(src)[0]), buckets)
    real = _plan_rows(dst, num_rows, buckets, caps)
    t_real = (_plan_rows(src, num_rows, buckets, caps) if with_transpose
              else None)
    return ELLPlan(int(num_rows), buckets, caps, real, t_real)


def _bucket(key: torch.Tensor, col: torch.Tensor, w: torch.Tensor, n: int,
            buckets: tuple, capacity: tuple, real: tuple) -> ELLGraph:
    """One direction: the sorted COO (``key`` ascending) into zeroed
    buckets of the planned capacities."""
    dev = key.device
    lay = Layout.of(buckets, capacity, real)
    rowptr = torch.empty(n + 1, dtype=torch.int32, device=dev)
    counts = torch.empty(len(buckets) * n, dtype=torch.int32, device=dev)
    ell_rows(key, rowptr, counts, lay)
    incl = counts.cumsum(0, dtype=torch.int32)   # bucket after bucket
    slots = [c * k for c, k in zip(capacity, buckets)]
    idx = torch.zeros(sum(slots), dtype=torch.int32, device=dev)
    wout = torch.zeros(sum(slots), dtype=torch.float32, device=dev)
    rid = torch.full((sum(capacity),), n, dtype=torch.int32, device=dev)
    ell_scatter(key, col, w, rowptr, counts, incl, idx, wout, rid, lay)
    shapes = list(zip(capacity, buckets))
    return ELLGraph(
        tuple(t.view(s) for t, s in zip(idx.split(slots), shapes)),
        tuple(t.view(s) for t, s in zip(wout.split(slots), shapes)),
        rid.split(list(capacity)), num_rows=n, num_cols=n,
        bucket_real=tuple(real))


def ell_rows_plain(key: torch.Tensor, rowptr: torch.Tensor,
                   counts: torch.Tensor, layout: Layout) -> None:
    """Plain PyTorch of the rows kernel, on any device: ``rowptr[r]``, the
    first sorted edge whose row is at least r, and ``counts[b * n + v]``,
    node v's rows in bucket b (one a piece: full pieces in the widest
    bucket, the last piece, or a degree-0 row's empty one, in the smallest
    that holds it). Writes in place."""
    n, ks = rowptr.shape[0] - 1, layout.widths
    kmax = ks[-1]
    rowptr.copy_(torch.searchsorted(
        key, torch.arange(n + 1, dtype=key.dtype, device=key.device),
        out_int32=True))
    deg = rowptr[1:] - rowptr[:-1]
    pieces = torch.div(deg + (kmax - 1), kmax,
                       rounding_mode="floor").clamp_(min=1)
    last = torch.zeros_like(deg)
    for k in ks[:-1]:
        last += (deg - (pieces - 1) * kmax) > k
    per = counts.view(len(ks), n)
    for b in range(len(ks)):
        per[b] = last == b
    per[-1] += pieces - 1


def ell_scatter_plain(key, col, w, rowptr, counts, incl, idx, wout, rid,
                      layout: Layout) -> None:
    """Plain PyTorch of the scatter kernel, on any device: every edge of
    the sorted COO into its (bucket, slot row, slot) of the flat
    ``idx``/``wout``, the row id of each piece's first slot and of each
    degree-0 row into ``rid``. Writes in place; rows outside [0, n) and
    slot rows outside their bucket's capacity are skipped."""
    n, nb, kmax = rowptr.shape[0] - 1, len(layout.widths), layout.widths[-1]
    ks, cap, first, ro, io = (torch.tensor(x, dtype=torch.long,
                                           device=key.device)
                              for x in layout)
    rp, v = rowptr.long(), key.long()
    base = (incl - counts).long()   # exclusive scan

    def pick(t, at):
        return t.index_select(0, at)

    e = torch.arange(key.shape[0], device=key.device)
    keep = (v >= 0) & (v < n)
    if not bool(keep.all()):
        e, v = e[keep], v[keep]
    lo = pick(rp, v)
    deg = pick(rp, v + 1) - lo
    piece = torch.div(e - lo, kmax, rounding_mode="floor")
    slot = e - lo - piece * kmax
    pieces = torch.div(deg + (kmax - 1), kmax, rounding_mode="floor")
    b = torch.zeros_like(v)
    for k in layout.widths[:-1]:
        b += (deg - piece * kmax) > k
    b = torch.where(piece == pieces - 1, b, nb - 1)
    row = pick(base, b * n + v) - pick(first, b) \
        + torch.where(b == nb - 1, piece, 0)
    keep = (row >= 0) & (row < pick(cap, b))
    if not bool(keep.all()):
        e, v, b, row, slot = (t[keep] for t in (e, v, b, row, slot))
    at = pick(io, b) + row * pick(ks, b) + slot
    idx[at] = pick(col, e)
    wout[at] = pick(w, e)
    head = torch.nonzero(slot == 0).flatten()
    rid[pick(pick(ro, b), head) + pick(row, head)] = pick(v, head).to(
        torch.int32)
    empty = torch.nonzero(rp[1:] == rp[:-1]).flatten()
    row = pick(base, empty)
    keep = (row >= 0) & (row < cap[0])
    rid[ro[0] + row[keep]] = empty[keep].to(torch.int32)


def _check(name: str, tensors: dict, layout: Layout) -> None:
    """Dtypes, devices and contiguity of a launch's tensors."""
    want = {k: torch.float32 if k in ("w", "wout") else torch.int32
            for k in tensors}
    bad = [k for k, t in tensors.items() if t.dtype != want[k]]
    if bad:
        raise TypeError(f"{name}: {', '.join(bad)} must be "
                        f"{', '.join(str(want[k]) for k in bad)}")
    if len({t.device for t in tensors.values()}) != 1:
        raise ValueError(f"{name}: inputs on several devices")
    if not all(t.is_contiguous() for t in tensors.values()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if not 1 <= len(layout.widths) <= MAX_BUCKETS:
        raise ValueError(f"{name}: {len(layout.widths)} buckets, the kernel "
                         f"takes 1 to {MAX_BUCKETS}")


def _launch(name: str, symbol: str, argtypes: list, tensors: tuple,
            ints: tuple, layout: Layout) -> None:
    """One launch of ``symbol`` on the current stream of the tensors'
    card: their pointers, ``ints``, the layout as the host array the
    kernel reads, the stream."""
    pad = (0,) * (MAX_BUCKETS - len(layout.widths))
    host = (ctypes.c_longlong * (5 * MAX_BUCKETS))(
        *(x for field in layout for x in (*field, *pad)))
    fn = load_kernel("ell_build", symbol, argtypes)
    dev = tensors[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in tensors), *ints, host, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc} ({ints}, {layout})")
    global LAUNCHES
    LAUNCHES += 1


def ell_rows(key: torch.Tensor, rowptr: torch.Tensor, counts: torch.Tensor,
             layout: Layout) -> None:
    """From the sorted row keys (``key``, ascending), each row's first
    sorted edge into ``rowptr`` (n + 1,) and each node's rows per bucket
    into ``counts`` (nb · n,), bucket after bucket. One kernel launch on
    CUDA tensors (``csrc/ell_build.cu``), :func:`ell_rows_plain` on CPU
    tensors."""
    _check("ell_rows", {"key": key, "rowptr": rowptr, "counts": counts},
           layout)
    n = rowptr.shape[0] - 1
    if key.dim() != 1 or counts.shape != (len(layout.widths) * n,):
        raise ValueError(f"ell_rows: key {tuple(key.shape)}, counts "
                         f"{tuple(counts.shape)} for {n} rows and "
                         f"{len(layout.widths)} buckets")
    if key.device.type == "cpu":
        ell_rows_plain(key, rowptr, counts, layout)
    elif key.device.type == "cuda":
        _launch("ell_rows", "repro_ell_rows", _ROWS_ARGTYPES,
                (key, rowptr, counts), (key.shape[0], n, len(layout.widths)),
                layout)
    else:
        raise ValueError(f"ell_rows: no kernel for device {key.device}")


def ell_scatter(key: torch.Tensor, col: torch.Tensor, w: torch.Tensor,
                rowptr: torch.Tensor, counts: torch.Tensor,
                incl: torch.Tensor, idx: torch.Tensor, wout: torch.Tensor,
                rid: torch.Tensor, layout: Layout) -> None:
    """Place each edge of the sorted COO (``key`` its row, ascending;
    ``col``, ``w`` in the same order; ``rowptr`` and ``counts`` from
    :func:`ell_rows`, ``incl`` the inclusive scan of ``counts``) into the
    buckets laid flat as ``layout`` says in ``idx``/``wout`` (zeroed) and
    ``rid`` (filled with n). One kernel launch on CUDA tensors
    (``csrc/ell_build.cu``), :func:`ell_scatter_plain` on CPU tensors."""
    t = {"key": key, "col": col, "w": w, "rowptr": rowptr, "counts": counts,
         "incl": incl, "idx": idx, "wout": wout, "rid": rid}
    _check("ell_scatter", t, layout)
    n, e, nb = rowptr.shape[0] - 1, key.shape[0], len(layout.widths)
    if counts.shape != (nb * n,) or incl.shape != counts.shape \
            or col.shape != (e,) or w.shape != (e,) \
            or idx.shape != wout.shape \
            or idx.numel() < layout.idx_off[-1] \
            + layout.capacity[-1] * layout.widths[-1] \
            or rid.numel() < layout.row_off[-1] + layout.capacity[-1]:
        raise ValueError(
            "ell_scatter: " + ", ".join(f"{k} {tuple(v.shape)}"
                                        for k, v in t.items())
            + f" do not fit {nb} buckets of {n} rows laid as {layout}")
    if key.device.type == "cpu":
        ell_scatter_plain(*t.values(), layout)
    elif key.device.type == "cuda":
        _launch("ell_scatter", "repro_ell_build", _ARGTYPES,
                tuple(t.values()), (e, n, nb), layout)
    else:
        raise ValueError(f"ell_scatter: no kernel for device {key.device}")
