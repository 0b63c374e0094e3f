"""Build the CUDA kernels of ``repro_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into ``build/repro_torch/``
at the repository root. The file name carries a hash of the source and the
flags, so an edited source rebuilds and an unchanged one is reused.
``build_kernels()`` starts one ``nvcc`` per missing library, all at once, and
raises :class:`KernelBuildError` with nvcc's stderr if any fails. Nothing
here runs at import time: CPU-only machines import the package without a
CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("ell_spmm", "compensate", "ell_build", "gat_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}
_smem: dict = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or failed on one of the kernel sources."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((str(Path(home) / "bin" / "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the built library of kernel ``name`` lives (source-hash keyed)."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_kernels(names=KERNELS) -> dict:
    """Compile every named kernel whose library is missing; name -> path.

    One ``nvcc`` per source, all started together and all waited for.
    """
    with _lock:
        paths = {n: library_path(n) for n in names}
        todo = {n: p for n, p in paths.items() if not p.exists()}
        if not todo:
            return paths
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n, p in todo.items():
            tmp = p.with_name(f"{p.stem}.{os.getpid()}.tmp.so")
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        errors = []
        for n, (tmp, proc) in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                errors.append(f"nvcc failed on {n}.cu (exit "
                              f"{proc.returncode}):\n{out}{err}")
            else:
                os.replace(tmp, todo[n])   # atomic publish
        if errors:
            raise KernelBuildError("\n".join(errors))
        return paths


def smem_optin(device_index: int) -> int:
    """The card's opt-in shared memory per block in bytes (232,448 on an
    H100): what one block of a resident-source kernel may stage."""
    with _lock:
        hit = _smem.get(device_index)
    if hit is None:
        fn = load_kernel("ell_spmm", "repro_smem_optin",
                         [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
        out = ctypes.c_int(0)
        rc = fn(device_index, ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"cudaDeviceGetAttribute failed with CUDA "
                               f"error {rc} on device {device_index}")
        hit = out.value
        with _lock:
            _smem[device_index] = hit
    return hit


def slab_cols(m: int, d: int, elt: int, smem_bytes: int) -> int:
    """Column-tile width of a resident-source kernel: the widest multiple of
    the 16-byte vector for which an (m, width) slab of ``elt``-byte elements
    fits ``smem_bytes``, at most D rounded up to that vector.

    Raises ValueError when not even one vector per row fits (about 14.5k
    rows on an H100): the source is too large to be resident.
    """
    vec = 16 // elt
    cols = (smem_bytes // (max(m, 1) * elt)) // vec * vec
    if cols < vec:
        raise ValueError(
            f"resident source of M={m} rows does not fit: one 16-byte vector "
            f"per row needs {max(m, 1) * 16} bytes of shared memory, the "
            f"card allows {smem_bytes} per block; use stream=True")
    return min(cols, -(-d // vec) * vec)


def resident_grid(n: int, d: int, bd: int, unit: int,
                  sms: int) -> tuple[int, int, int]:
    """Layout of the resident compensation kernel on a card of ``sms`` SMs:
    ``(C, P, rows)``.

    C = ceil(d / bd) column tiles, each split into P shares of ``rows``
    contiguous rows, one block of 32 warps per (share, tile), so that each
    block stages its (M, bd) slab exactly once. ``unit`` is the elements of
    one slab vector (16 bytes of the store, or 1 element-wise): a warp
    splits into lane groups of bd / unit lanes, one row each. P is at most
    ``sms // C`` (about one block per SM) and at most what leaves each
    block two passes of its lane groups, since every share stages the
    column tile again; P is then cut to ceil(n / rows), so no share is
    empty.
    """
    c = -(-d // bd)
    groups = 32 * (32 // min(bd // unit, 32))   # rows of one block's pass
    p = max(1, min(sms // c, n // (2 * groups)))
    rows = -(-n // p)
    return c, -(-n // rows), rows


def load_kernel(name: str, symbol: str, argtypes: list):
    """The C function ``symbol`` of kernel ``name`` (built on first use)."""
    with _lock:
        hit = _libs.get((name, symbol))
    if hit is None:
        lib = ctypes.CDLL(str(build_kernels((name,))[name]))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        hit = (lib, fn)   # the CDLL stays referenced while fn is in use
        with _lock:
            _libs[(name, symbol)] = hit
    return hit[1]
