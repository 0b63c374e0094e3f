"""ELL SpMM for one degree bucket: the CUDA kernels, their wrappers, their plain twins.

``ell_spmm(idx, w, h)`` computes ``out[i] = Σ_k w[i,k] · h[idx[i,k]]`` with
an f32 accumulator and the output in ``h``'s dtype. On CUDA tensors it
launches the hand-written Hopper kernel ``csrc/ell_spmm.cu`` (which replaces
the TPU kernel ``repro.kernels.ell_spmm._spmm_stream_kernel``) or raises; on
CPU tensors it runs :func:`ell_spmm_plain`, the same arithmetic in plain
PyTorch, which is also what the kernel is checked against on the card.
``ell_spmm_scatter(idx, w, rows, h, out)`` is the same kernel in its scatter
form, what ``bucketed_spmm`` runs: it adds each real row's sum into
``out[rows[i]]`` of a zeroed (n, D) output and skips the padding rows
(``rows[i] >= n``); its twin is :func:`ell_spmm_scatter_plain`.
``ell_spmm_resident`` and ``ell_spmm_resident_scatter`` are the same two
functions on the resident-source kernel of the same file (which replaces
``_spmm_resident_kernel``, ``stream=False``): it stages column slabs of the
whole of ``h`` in shared memory, so it takes only small sources, and it
equals the streaming kernel bit for bit per bucket. ``LAUNCHES`` and
``LAUNCHES_RESIDENT`` count launches of the two kernels, in either form
(never plain-version calls), so a run can show that its path went through
them.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import load_kernel, slab_cols, smem_optin

LAUNCHES = 0
LAUNCHES_RESIDENT = 0

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_ARGTYPES_RESIDENT = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 \
    + [ctypes.c_void_p]


def ell_spmm_plain(nbr_idx: torch.Tensor, nbr_w: torch.Tensor,
                   h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: f32 ``Σ_k w[i,k] · h[idx[i,k]]``, cast to ``h``'s dtype."""
    rows, k = nbr_idx.shape
    gathered = h.index_select(0, nbr_idx.reshape(-1)).reshape(
        rows, k, h.shape[1])
    out = torch.einsum("nk,nkd->nd", nbr_w.float(), gathered.float())
    return out.to(h.dtype)


def ell_spmm_scatter_plain(nbr_idx: torch.Tensor, nbr_w: torch.Tensor,
                           rows: torch.Tensor, h: torch.Tensor,
                           out: torch.Tensor,
                           real_rows: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch of the scatter form: the bucket's rows through
    :func:`ell_spmm_plain`, then ``index_add_`` into ``out`` with the rows
    ``>= out.shape[0]`` (padding) dropped. Adds in place; returns ``out``."""
    if real_rows is not None:
        nbr_idx, nbr_w, rows = (t[:real_rows] for t in (nbr_idx, nbr_w, rows))
    keep = rows < out.shape[0]
    return out.index_add_(0, rows[keep].long(),
                          ell_spmm_plain(nbr_idx[keep], nbr_w[keep], h))


def _validate(name: str, nbr_idx: torch.Tensor, nbr_w: torch.Tensor,
              h: torch.Tensor) -> None:
    if nbr_idx.shape != nbr_w.shape or nbr_idx.dim() != 2 or h.dim() != 2:
        raise ValueError(f"{name}: idx {tuple(nbr_idx.shape)}, w "
                         f"{tuple(nbr_w.shape)} must be equal (N, K); h "
                         f"{tuple(h.shape)} must be (M, D)")
    if nbr_idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be int32, got {nbr_idx.dtype}")
    if nbr_w.dtype not in _DTYPES or h.dtype not in _DTYPES:
        raise TypeError(f"{name}: w/h must be float32 or bfloat16, got "
                        f"{nbr_w.dtype}/{h.dtype}")
    devices = {t.device for t in (nbr_idx, nbr_w, h)}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {h.device}")


def _validate_scatter(name: str, nbr_idx: torch.Tensor, nbr_w: torch.Tensor,
                      rows: torch.Tensor, h: torch.Tensor, out: torch.Tensor,
                      real_rows: Optional[int]) -> None:
    _validate(name, nbr_idx, nbr_w, h)
    if rows.shape != nbr_idx.shape[:1] or rows.dtype != torch.int32:
        raise ValueError(f"{name}: rows must be int32 of shape "
                         f"{tuple(nbr_idx.shape[:1])}, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if out.dim() != 2 or out.shape[1] != h.shape[1] or out.dtype != h.dtype:
        raise ValueError(f"{name}: out {out.dtype} {tuple(out.shape)} must "
                         f"be (n, {h.shape[1]}) in h's dtype {h.dtype}")
    if {rows.device, out.device} != {h.device}:
        raise ValueError(f"{name}: rows and out must be on {h.device}")
    if real_rows is not None and not 0 <= real_rows <= nbr_idx.shape[0]:
        raise ValueError(f"{name}: real_rows={real_rows} outside "
                         f"[0, {nbr_idx.shape[0]}]")


def _launch(name: str, nbr_idx: torch.Tensor, nbr_w: torch.Tensor,
            h: torch.Tensor, resident: bool,
            rows: Optional[torch.Tensor] = None,
            out: Optional[torch.Tensor] = None,
            real_rows: Optional[int] = None) -> torch.Tensor:
    """One launch: the per-bucket form (``rows is None``: a new (N, D)
    output) or the scatter form (adds into ``out``, returns it)."""
    tensors = (nbr_idx, nbr_w, h) + (() if rows is None else (rows, out))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: idx, w, h, rows and out must be "
                         f"contiguous")
    n_rows, k = nbr_idx.shape
    m, d = h.shape
    if rows is None:
        out = torch.empty((n_rows, d), dtype=h.dtype, device=h.device)
    elif real_rows is not None:
        n_rows = real_rows
    if n_rows == 0 or d == 0:
        return out
    if m == 0 and k:
        raise ValueError(f"{name}: gather source h has no rows")
    vec = 16 // h.element_size()
    vector = (d % vec == 0 and h.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    args = [nbr_idx.data_ptr(), nbr_w.data_ptr(),
            None if rows is None else rows.data_ptr(), h.data_ptr(),
            out.data_ptr(), n_rows, k, max(m, 1), d, out.shape[0]]
    if resident:
        args.append(slab_cols(m, d, h.element_size(),
                              smem_optin(h.device.index or 0)))
        fn = load_kernel("ell_spmm", "repro_ell_spmm_resident",
                         _ARGTYPES_RESIDENT)
    else:
        fn = load_kernel("ell_spmm", "repro_ell_spmm", _ARGTYPES)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, int(nbr_w.dtype == torch.bfloat16),
                int(h.dtype == torch.bfloat16), int(vector), stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc} (rows={n_rows}, K={k}, M={m}, D={d})")
    global LAUNCHES, LAUNCHES_RESIDENT
    if resident:
        LAUNCHES_RESIDENT += 1
    else:
        LAUNCHES += 1
    return out


def ell_spmm(nbr_idx: torch.Tensor, nbr_w: torch.Tensor,
             h: torch.Tensor) -> torch.Tensor:
    """out[i] = Σ_k w[i,k] · h[idx[i,k]].  idx/w: (N, K); h: (M, D) -> (N, D).

    idx is int32; w and h are f32 or bf16. Any N, K, D (no tile padding).
    The kernel clamps indices into [0, M); ``build_ell`` never emits others.
    """
    _validate("ell_spmm", nbr_idx, nbr_w, h)
    if h.device.type == "cpu":
        return ell_spmm_plain(nbr_idx, nbr_w, h)
    return _launch("ell_spmm", nbr_idx, nbr_w, h, resident=False)


def ell_spmm_resident(nbr_idx: torch.Tensor, nbr_w: torch.Tensor,
                      h: torch.Tensor) -> torch.Tensor:
    """:func:`ell_spmm` on the resident-source kernel (``stream=False``).

    On the card, raises ValueError when not even one 16-byte vector of each
    of h's M rows fits the shared memory of one block (about 14.5k rows on
    an H100); it never falls back to the streaming kernel.
    """
    _validate("ell_spmm_resident", nbr_idx, nbr_w, h)
    if h.device.type == "cpu":
        return ell_spmm_plain(nbr_idx, nbr_w, h)
    return _launch("ell_spmm_resident", nbr_idx, nbr_w, h, resident=True)


def ell_spmm_scatter(nbr_idx: torch.Tensor, nbr_w: torch.Tensor,
                     rows: torch.Tensor, h: torch.Tensor, out: torch.Tensor,
                     real_rows: Optional[int] = None) -> torch.Tensor:
    """out[rows[i]] += Σ_k w[i,k] · h[idx[i,k]] for every rows[i] < n.

    idx/w: (N, K); rows: (N,) int32; h: (M, D); out: (n, D) in h's dtype,
    added to in place and returned. Rows with ``rows[i] >= n`` are padding
    and skipped. ``real_rows`` (the bucket's real row count, when known:
    padding rows sit at the tail) stops the work there. Pieces of one
    destination row sum in f32 before they are added; rows added to from
    several pieces or buckets take atomics on the card, in no fixed order.
    """
    _validate_scatter("ell_spmm_scatter", nbr_idx, nbr_w, rows, h, out,
                      real_rows)
    if h.device.type == "cpu":
        return ell_spmm_scatter_plain(nbr_idx, nbr_w, rows, h, out, real_rows)
    return _launch("ell_spmm_scatter", nbr_idx, nbr_w, h, False, rows, out,
                   real_rows)


def ell_spmm_resident_scatter(nbr_idx: torch.Tensor, nbr_w: torch.Tensor,
                              rows: torch.Tensor, h: torch.Tensor,
                              out: torch.Tensor,
                              real_rows: Optional[int] = None) -> torch.Tensor:
    """:func:`ell_spmm_scatter` on the resident-source kernel
    (``stream=False``); the same cap as :func:`ell_spmm_resident`."""
    _validate_scatter("ell_spmm_resident_scatter", nbr_idx, nbr_w, rows, h,
                      out, real_rows)
    if h.device.type == "cpu":
        return ell_spmm_scatter_plain(nbr_idx, nbr_w, rows, h, out, real_rows)
    return _launch("ell_spmm_resident_scatter", nbr_idx, nbr_w, h, True,
                   rows, out, real_rows)
