"""Fused LMC compensation (Eq. 9/12): the CUDA kernels, their wrappers, their plain twin.

``lmc_compensate_kernel(store, gids, beta, fresh, mask)`` computes
``mask · ((1-β) · store[gid] + β · fresh)`` row by row, with the store row
cast to ``fresh``'s dtype and ``gid`` clipped into the store. On CUDA tensors
it launches the hand-written Hopper kernel ``csrc/compensate.cu`` (which
replaces the TPU kernel ``repro.kernels.compensate._comp_stream_kernel``) or
raises; on CPU tensors it runs :func:`lmc_compensate_plain`. On f32 inputs the
two agree bit for bit. The streaming kernel gives each row one warp, which
issues every load of the row before its arithmetic.
``lmc_compensate_resident`` is the same function on the resident-store kernel
of the same file (which replaces ``_comp_resident_kernel``,
``stream=False``): each block, at most about one per SM, stages one column
slab of the whole store in shared memory once and computes a contiguous
share of the rows from it (:func:`~repro_torch.kernels.build.resident_grid`),
so it takes only small stores. ``LAUNCHES`` and ``LAUNCHES_RESIDENT`` count
kernel launches only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (load_kernel, resident_grid, slab_cols,
                                      smem_optin)

LAUNCHES = 0
LAUNCHES_RESIDENT = 0

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_ARGTYPES_RESIDENT = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
    + [ctypes.c_void_p]


def lmc_compensate_plain(store: torch.Tensor, gids: torch.Tensor,
                         beta: torch.Tensor, fresh: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch, same casts and operation order as the kernel."""
    g = gids.clamp(0, max(store.shape[0] - 1, 0))
    hist = store.index_select(0, g).to(fresh.dtype).float()
    b = beta.to(fresh.dtype).float()[:, None]
    m = mask.to(fresh.dtype).float()[:, None]
    return (m * ((1.0 - b) * hist + b * fresh.float())).to(fresh.dtype)


def _validate(store, gids, beta, fresh, mask) -> None:
    n, d = fresh.shape
    if store.dim() != 2 or store.shape[1] != d or gids.shape != (n,) \
            or beta.shape != (n,) or mask.shape != (n,):
        raise ValueError(
            f"lmc_compensate: store {tuple(store.shape)}, gids "
            f"{tuple(gids.shape)}, beta {tuple(beta.shape)}, fresh "
            f"{tuple(fresh.shape)}, mask {tuple(mask.shape)} do not match "
            "(M, D), (N,), (N,), (N, D), (N,)")
    if gids.dtype != torch.int32:
        raise TypeError(f"lmc_compensate: gids must be int32, got {gids.dtype}")
    if beta.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError("lmc_compensate: beta and mask must be float32")
    if store.dtype not in _DTYPES or fresh.dtype not in _DTYPES:
        raise TypeError(f"lmc_compensate: store/fresh must be float32 or "
                        f"bfloat16, got {store.dtype}/{fresh.dtype}")
    devices = {t.device for t in (store, gids, beta, fresh, mask)}
    if len(devices) != 1:
        raise ValueError(f"lmc_compensate: inputs on several devices {devices}")
    if fresh.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lmc_compensate: no kernel for device {fresh.device}")


def _launch(store, gids, beta, fresh, mask, resident: bool, *,
            block_rows: int | None = None) -> torch.Tensor:
    """Launch one kernel. ``block_rows`` overrides the resident layout's
    rows per block (:func:`resident_grid`); ``chip_smoke.py`` times other
    layouts through it."""
    if not all(t.is_contiguous() for t in (store, gids, beta, fresh, mask)):
        raise ValueError("lmc_compensate: all inputs must be contiguous")
    n, d = fresh.shape
    m = store.shape[0]
    out = torch.empty((n, d), dtype=fresh.dtype, device=fresh.device)
    if n == 0 or d == 0:
        return out
    if m == 0:
        raise ValueError("lmc_compensate: the store has no rows")
    args = [store.data_ptr(), gids.data_ptr(), beta.data_ptr(),
            fresh.data_ptr(), mask.data_ptr(), out.data_ptr(), n, m, d]
    if resident:
        elt = store.element_size()
        unit = 16 // elt   # elements of one 16-byte slab vector
        vector = d % unit == 0 and store.data_ptr() % 16 == 0 and all(
            t.data_ptr() % min(16, unit * t.element_size()) == 0
            for t in (fresh, out))
        bd = slab_cols(m, d, elt, smem_optin(fresh.device.index or 0))
        if block_rows is None:
            sms = torch.cuda.get_device_properties(
                fresh.device).multi_processor_count
            block_rows = resident_grid(n, d, bd, unit if vector else 1,
                                       sms)[2]
        args += [bd, block_rows]
        fn = load_kernel("compensate", "repro_lmc_compensate_resident",
                         _ARGTYPES_RESIDENT)
    else:
        vector = d % 4 == 0 and all(
            t.data_ptr() % (4 * t.element_size()) == 0
            for t in (store, fresh, out))
        fn = load_kernel("compensate", "repro_lmc_compensate", _ARGTYPES)
    with torch.cuda.device(fresh.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, int(store.dtype == torch.bfloat16),
                int(fresh.dtype == torch.bfloat16), int(vector), stream)
    if rc != 0:
        raise RuntimeError(f"lmc_compensate: kernel launch failed with CUDA "
                           f"error {rc} (N={n}, M={m}, D={d})")
    global LAUNCHES, LAUNCHES_RESIDENT
    if resident:
        LAUNCHES_RESIDENT += 1
    else:
        LAUNCHES += 1
    return out


def lmc_compensate_kernel(store: torch.Tensor, gids: torch.Tensor,
                          beta: torch.Tensor, fresh: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """store (M, D); gids (N,) int32; beta/mask (N,) f32; fresh (N, D) -> (N, D).

    store and fresh are f32 or bf16; the output takes fresh's dtype. Any N
    and D (no tile padding, and never a padded copy of the store).
    """
    _validate(store, gids, beta, fresh, mask)
    if fresh.device.type == "cpu":
        return lmc_compensate_plain(store, gids, beta, fresh, mask)
    return _launch(store, gids, beta, fresh, mask, resident=False)


def lmc_compensate_resident(store: torch.Tensor, gids: torch.Tensor,
                            beta: torch.Tensor, fresh: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """:func:`lmc_compensate_kernel` on the resident-store kernel
    (``stream=False``).

    On the card, raises ValueError when not even one 16-byte vector of each
    store row fits the shared memory of one block (about 14.5k rows on an
    H100); it never falls back to the streaming kernel.
    """
    _validate(store, gids, beta, fresh, mask)
    if fresh.device.type == "cpu":
        return lmc_compensate_plain(store, gids, beta, fresh, mask)
    return _launch(store, gids, beta, fresh, mask, resident=True)
