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
KERNELS = ("ell_spmm", "compensate")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}


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
