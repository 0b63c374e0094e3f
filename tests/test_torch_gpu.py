"""The CUDA kernels on the card: each against its plain PyTorch twin, the
launch counters, and NaN propagation. Every test needs an NVIDIA GPU and
skips without one; this file imports no JAX, so it runs where only the port
is installed: ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.

Tolerances: f32 rtol = atol = 1e-5 (the same f32 sums in another order;
rows split across buckets combine through atomic ``index_add_`` in no fixed
order, which the bound covers too); bf16 2e-2 compared in f32 (one bf16
rounding of the output); the compensation is bit-equal to its twin. Matmuls
in full f32: TF32 is off.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import (build_ell, bucketed_spmm, ell_spmm,
                                 lmc_compensate_kernel)
from repro_torch.kernels.compensate import lmc_compensate_plain
from repro_torch.kernels.ell_spmm import ell_spmm_plain

F32 = dict(rtol=1e-5, atol=1e-5)
# the kernel modules (the package re-exports a function under ell_spmm)
SPMM_MOD = importlib.import_module("repro_torch.kernels.ell_spmm")
COMP_MOD = importlib.import_module("repro_torch.kernels.compensate")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,m,d", [(8, 3776, 256), (128, 3776, 256),
                                   (33, 70, 130), (5, 50, 50)])
def test_ell_spmm_kernel_matches_plain(cuda, dtype, k, m, d):
    g = torch.Generator(device=cuda).manual_seed(k + d)
    idx = torch.randint(0, m, (300, k), generator=g, device=cuda,
                        dtype=torch.int32)
    w = torch.rand((300, k), generator=g, device=cuda).to(dtype)
    h = torch.randn((m, d), generator=g, device=cuda).to(dtype)
    before = SPMM_MOD.LAUNCHES
    got = ell_spmm(idx, w, h)
    assert SPMM_MOD.LAUNCHES == before + 1
    want = ell_spmm_plain(idx, w, h)
    tol = F32 if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,d", [(3648, 169343, 256), (70, 123, 50)])
def test_lmc_compensate_kernel_matches_plain(cuda, dtype, n, m, d):
    g = torch.Generator(device=cuda).manual_seed(n)
    store = torch.randn((m, d), generator=g, device=cuda).to(dtype)
    gids = torch.randint(-3, m + 3, (n,), generator=g, device=cuda,
                         dtype=torch.int32)   # out of range -> clipped
    beta = torch.rand(n, generator=g, device=cuda)
    mask = (torch.rand(n, generator=g, device=cuda) > 0.2).float()
    fresh = torch.randn((n, d), generator=g, device=cuda).to(dtype)
    before = COMP_MOD.LAUNCHES
    got = lmc_compensate_kernel(store, gids, beta, fresh, mask)
    assert COMP_MOD.LAUNCHES == before + 1
    # same casts and operation order, no fused multiply-add: bit-equal
    assert torch.equal(got, lmc_compensate_plain(store, gids, beta, fresh,
                                                 mask))


def test_kernels_propagate_nan_through_padding(cuda):
    """0·NaN = NaN on the card too: padding slots and masked rows are
    multiplied through, never skipped."""
    h = torch.ones((4, 256), device=cuda)
    h[0] = float("nan")
    idx = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    assert torch.isnan(ell_spmm(idx, torch.zeros((2, 8), device=cuda),
                                h)).all()
    out = lmc_compensate_kernel(
        h, torch.zeros(2, dtype=torch.int32, device=cuda),
        torch.zeros(2, device=cuda), torch.ones((2, 256), device=cuda),
        torch.zeros(2, device=cuda))
    assert torch.isnan(out).all()


def test_bucketed_spmm_on_gpu_matches_cpu(cuda):
    """Rows of degree 130 and 300 split across buckets and combine through
    atomics on the card; D = 130 exercises the unvectorised tail path."""
    r = np.random.default_rng(4)
    n = 40
    deg = r.choice([0, 1, 3, 7, 8, 20, 130, 300], size=n)
    deg[:2] = (130, 300)
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    nnz = int(indptr[-1])
    g = build_ell(indptr, r.integers(0, n, nnz).astype(np.int32),
                  r.random(nnz).astype(np.float32))
    h = torch.from_numpy(r.normal(size=(n, 130)).astype(np.float32))
    before = SPMM_MOD.LAUNCHES
    got = bucketed_spmm(g.to(cuda), h.to(cuda))
    assert SPMM_MOD.LAUNCHES == before + len(g.bucket_idx)
    torch.testing.assert_close(got.cpu(), bucketed_spmm(g, h), **F32)
