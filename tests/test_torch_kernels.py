"""Port parity, kernels: the wrappers' plain versions against the reference's
Pallas kernels (interpret mode on the CPU, as the reference's own tests run
them). The CUDA kernels against their plain versions: test_torch_gpu.py.

Tolerances: f32 rtol = atol = 1e-5 (sums of ≤ 300 f32 products in another
order); bf16 5e-2 compared in f32 (one bf16 ulp at |x| ≤ 8 is ≤ 3e-2, and the
two packages round at different points).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import build_ell as j_build_ell
from repro.kernels import bucketed_spmm as j_bucketed_spmm
from repro.kernels import ell_spmm as j_ell_spmm
from repro.kernels import lmc_compensate as j_lmc_compensate
from repro.kernels import ref as jref

from repro_torch.kernels import (build_ell, bucketed_spmm, ell_aggregate_fn,
                                 ell_spmm, lmc_compensate,
                                 lmc_compensate_kernel, ref)
from repro_torch.kernels.compensate import lmc_compensate_plain

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
# the kernel modules (the package re-exports a function under ell_spmm)
SPMM_MOD = importlib.import_module("repro_torch.kernels.ell_spmm")
COMP_MOD = importlib.import_module("repro_torch.kernels.compensate")


def _heavy_csr(seed, n=40):
    """CSR with deg-0 rows and rows of degree 130 and 300 (> max bucket)."""
    r = np.random.default_rng(seed)
    deg = r.choice([0, 1, 3, 7, 8, 20, 130, 300], size=n)
    deg[:2] = (130, 300)
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    nnz = int(indptr[-1])
    return (indptr, r.integers(0, n, nnz).astype(np.int32),
            r.random(nnz).astype(np.float32))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# --------------------------------------------------------- plain vs reference
@pytest.mark.parametrize("k,m,d", [(8, 64, 128), (32, 300, 256),
                                   (128, 1000, 128)])
def test_ell_spmm_matches_reference_f32(k, m, d):
    rng = np.random.default_rng(k)
    n = 256
    idx = rng.integers(0, m, (n, k)).astype(np.int32)
    w = (rng.random((n, k)) * (rng.random((n, k)) > 0.3)).astype(np.float32)
    h = rng.normal(size=(m, d)).astype(np.float32)
    want = j_ell_spmm(jnp.asarray(idx), jnp.asarray(w), jnp.asarray(h))
    got = ell_spmm(*(torch.from_numpy(a) for a in (idx, w, h)))
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_ell_spmm_matches_reference_bf16():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 64, (256, 8)).astype(np.int32)
    w = rng.random((256, 8)).astype(np.float32)
    h = rng.normal(size=(64, 128)).astype(np.float32)
    want = j_ell_spmm(jnp.asarray(idx), jnp.asarray(w, jnp.bfloat16),
                      jnp.asarray(h, jnp.bfloat16))
    got = ell_spmm(torch.from_numpy(idx),
                   torch.from_numpy(w).to(torch.bfloat16),
                   torch.from_numpy(h).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


@pytest.mark.parametrize("d", [50, 130])
def test_bucketed_spmm_matches_reference_heavy_rows(d):
    """Rows of degree 130 and 300 split across buckets; D not a multiple of
    128 (the port masks the tail instead of padding D)."""
    indptr, indices, weights = _heavy_csr(d)
    n = indptr.shape[0] - 1
    h = np.random.default_rng(1).normal(size=(n, d)).astype(np.float32)
    want = j_bucketed_spmm(j_build_ell(indptr, indices, weights),
                           jnp.asarray(h))
    got = bucketed_spmm(build_ell(indptr, indices, weights),
                        torch.from_numpy(h))
    assert got.shape == (n, d)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    oracle = ref.degree_bucket_spmm_ref(
        *(torch.from_numpy(a) for a in (indptr, indices, weights, h)))
    np.testing.assert_allclose(_np(got), _np(oracle), **F32)


def test_bucketed_spmm_matches_reference_bf16():
    indptr, indices, weights = _heavy_csr(3)
    n = indptr.shape[0] - 1
    h = np.random.default_rng(2).normal(size=(n, 64)).astype(np.float32)
    want = j_bucketed_spmm(j_build_ell(indptr, indices, weights),
                           jnp.asarray(h, jnp.bfloat16))
    got = bucketed_spmm(build_ell(indptr, indices, weights),
                        torch.from_numpy(h).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    # sums of up to 300 terms, each partial sum rounded to bf16 once
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


@pytest.mark.parametrize("n,m,d", [(70, 123, 50), (256, 500, 128)])
def test_lmc_compensate_matches_reference(n, m, d):
    rng = np.random.default_rng(n)
    store = rng.normal(size=(m, d)).astype(np.float32)
    gids = rng.integers(0, m, n).astype(np.int32)
    beta = rng.random(n).astype(np.float32)
    beta[:3] = (0.0, 1.0, 0.5)
    mask = (rng.random(n) > 0.2).astype(np.float32)
    fresh = rng.normal(size=(n, d)).astype(np.float32)
    args = (store, gids, beta, fresh, mask)
    want = j_lmc_compensate(*(jnp.asarray(a) for a in args))
    got = lmc_compensate(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_lmc_compensate_matches_reference_bf16():
    rng = np.random.default_rng(5)
    n, m, d = 40, 90, 128
    store = rng.normal(size=(m, d)).astype(np.float32)
    gids = rng.integers(0, m, n).astype(np.int32)
    beta = rng.random(n).astype(np.float32)
    mask = (rng.random(n) > 0.2).astype(np.float32)
    fresh = rng.normal(size=(n, d)).astype(np.float32)
    want = j_lmc_compensate(jnp.asarray(store, jnp.bfloat16), jnp.asarray(gids),
                            jnp.asarray(beta), jnp.asarray(fresh, jnp.bfloat16),
                            jnp.asarray(mask))
    got = lmc_compensate(torch.from_numpy(store).to(torch.bfloat16),
                         torch.from_numpy(gids), torch.from_numpy(beta),
                         torch.from_numpy(fresh).to(torch.bfloat16),
                         torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


def test_ref_oracles_match_reference():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 30, (20, 6)).astype(np.int32)
    w = rng.random((20, 6)).astype(np.float32)
    h = rng.normal(size=(30, 10)).astype(np.float32)
    np.testing.assert_allclose(
        _np(ref.ell_spmm_ref(*(torch.from_numpy(a) for a in (idx, w, h)))),
        _np(jref.ell_spmm_ref(*(jnp.asarray(a) for a in (idx, w, h)))), **F32)
    gids = rng.integers(0, 30, 20).astype(np.int32)
    beta, mask = rng.random(20).astype(np.float32), np.ones(20, np.float32)
    fresh = rng.normal(size=(20, 10)).astype(np.float32)
    args = (h, gids, beta, fresh, mask)
    np.testing.assert_allclose(
        _np(ref.lmc_compensate_ref(*(torch.from_numpy(a) for a in args))),
        _np(jref.lmc_compensate_ref(*(jnp.asarray(a) for a in args))), **F32)
    # the plain twins agree with the oracles in f32
    np.testing.assert_allclose(
        _np(lmc_compensate_plain(*(torch.from_numpy(a) for a in args))),
        _np(ref.lmc_compensate_ref(*(torch.from_numpy(a) for a in args))),
        **F32)


# ---------------------------------------------------------- wrapper contract
def test_nan_in_padding_slot_propagates():
    """0·NaN = NaN: a poisoned source row poisons rows that only pad to it,
    as the reference's multiply-add does (the serving breaker relies on it)."""
    h = torch.ones((4, 8))
    h[0] = float("nan")
    idx = torch.zeros((2, 8), dtype=torch.int32)
    assert torch.isnan(ell_spmm(idx, torch.zeros((2, 8)), h)).all()
    out = lmc_compensate_kernel(h, torch.zeros(2, dtype=torch.int32),
                                torch.zeros(2), torch.ones((2, 8)),
                                torch.zeros(2))
    assert torch.isnan(out).all()


def test_forward_only_and_stream_knob():
    indptr, indices, weights = _heavy_csr(0)
    g = build_ell(indptr, indices, weights)
    h = torch.ones((indptr.shape[0] - 1, 4), requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        bucketed_spmm(g, h)
    with torch.no_grad():
        bucketed_spmm(g, h)                       # fine without autograd
    with pytest.raises(NotImplementedError, match="queue B"):
        bucketed_spmm(g, h.detach(), stream=False)
    store = torch.ones((5, 4), requires_grad=True)
    args = (torch.zeros(3, dtype=torch.int32), torch.zeros(3),
            torch.ones((3, 4)), torch.ones(3))
    with pytest.raises(RuntimeError, match="forward-only"):
        lmc_compensate(store, *args)
    with pytest.raises(NotImplementedError, match="queue B"):
        lmc_compensate(store.detach(), *args, stream=False)
    agg = ell_aggregate_fn(g)
    assert agg(None, h.detach(), g.num_rows).shape == (g.num_rows, 4)


def test_wrappers_validate_and_never_fall_back():
    """Bad dtypes raise; a tensor on a device without a kernel raises
    instead of running the plain version; CPU calls count no launches."""
    idx = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        ell_spmm(idx.long(), torch.ones((4, 2)), torch.ones((3, 5)))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ell_spmm(idx, torch.ones((4, 2)), torch.ones((3, 5)).double())
    with pytest.raises(ValueError, match="no kernel for device"):
        ell_spmm(idx.to("meta"), torch.ones((4, 2), device="meta"),
                 torch.ones((3, 5), device="meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        lmc_compensate_kernel(*(t.to("meta") for t in (
            torch.ones((3, 5)), torch.zeros(4, dtype=torch.int32),
            torch.ones(4), torch.ones((4, 5)), torch.ones(4))))
    before = (SPMM_MOD.LAUNCHES, COMP_MOD.LAUNCHES)
    ell_spmm(idx, torch.ones((4, 2)), torch.ones((3, 5)))
    lmc_compensate(torch.ones((3, 5)), torch.zeros(4, dtype=torch.int32),
                   torch.ones(4), torch.ones((4, 5)), torch.ones(4))
    assert (SPMM_MOD.LAUNCHES, COMP_MOD.LAUNCHES) == before
