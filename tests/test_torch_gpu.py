"""The CUDA kernels on the card: each against its plain PyTorch twin (the
resident-source kernels also bit for bit against the streaming ones), the
launch counters, the shared-memory cap, NaN propagation, and one training
step on the card against the same step on the CPU. Every test needs an
NVIDIA GPU and skips without one; this file imports no JAX, so it runs where
only the port is installed:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.

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
                                 ell_spmm_resident, lmc_compensate_kernel,
                                 lmc_compensate_resident)
from repro_torch.kernels.compensate import lmc_compensate_plain
from repro_torch.kernels.ell_spmm import ell_spmm_plain
from repro_torch.optim import tree_leaves, tree_map

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


# ------------------------------------------------- resident-source kernels
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,m,d", [(8, 2880, 256), (128, 2880, 256),
                                   (33, 70, 130), (5, 50, 50)])
def test_ell_spmm_resident_matches_plain_and_streaming(cuda, dtype, k, m, d):
    """Bit-equal to the streaming kernel (same fmaf sequence in k order),
    close to the plain twin."""
    g = torch.Generator(device=cuda).manual_seed(k + d + 1)
    idx = torch.randint(0, m, (700, k), generator=g, device=cuda,
                        dtype=torch.int32)
    w = torch.rand((700, k), generator=g, device=cuda).to(dtype)
    h = torch.randn((m, d), generator=g, device=cuda).to(dtype)
    before = (SPMM_MOD.LAUNCHES, SPMM_MOD.LAUNCHES_RESIDENT)
    got = ell_spmm_resident(idx, w, h)
    assert (SPMM_MOD.LAUNCHES, SPMM_MOD.LAUNCHES_RESIDENT) == \
        (before[0], before[1] + 1)
    assert torch.equal(got, ell_spmm(idx, w, h))
    tol = F32 if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got.float(),
                               ell_spmm_plain(idx, w, h).float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,d", [(2304, 4096, 256), (70, 123, 50),
                                   (300, 500, 130)])
def test_lmc_compensate_resident_bit_equal(cuda, dtype, n, m, d):
    g = torch.Generator(device=cuda).manual_seed(n + 1)
    store = torch.randn((m, d), generator=g, device=cuda).to(dtype)
    gids = torch.randint(-3, m + 3, (n,), generator=g, device=cuda,
                         dtype=torch.int32)   # out of range -> clipped
    beta = torch.rand(n, generator=g, device=cuda)
    mask = (torch.rand(n, generator=g, device=cuda) > 0.2).float()
    fresh = torch.randn((n, d), generator=g, device=cuda).to(dtype)
    before = COMP_MOD.LAUNCHES_RESIDENT
    got = lmc_compensate_resident(store, gids, beta, fresh, mask)
    assert COMP_MOD.LAUNCHES_RESIDENT == before + 1
    assert torch.equal(got, lmc_compensate_kernel(store, gids, beta, fresh,
                                                  mask))
    assert torch.equal(got, lmc_compensate_plain(store, gids, beta, fresh,
                                                 mask))


def test_resident_kernels_refuse_a_source_past_the_cap(cuda):
    """One 16-byte vector per row must fit the block's shared memory: past
    that the resident wrappers raise, and never fall back."""
    before = (SPMM_MOD.LAUNCHES, SPMM_MOD.LAUNCHES_RESIDENT,
              COMP_MOD.LAUNCHES, COMP_MOD.LAUNCHES_RESIDENT)
    idx = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    h = torch.zeros((20000, 64), device=cuda)
    with pytest.raises(ValueError, match="M=20000 rows does not fit"):
        ell_spmm_resident(idx, torch.ones((4, 8), device=cuda), h)
    with pytest.raises(ValueError, match="M=20000 rows does not fit"):
        lmc_compensate_resident(h, torch.zeros(4, dtype=torch.int32,
                                               device=cuda),
                                torch.ones(4, device=cuda),
                                torch.ones((4, 64), device=cuda),
                                torch.ones(4, device=cuda))
    assert (SPMM_MOD.LAUNCHES, SPMM_MOD.LAUNCHES_RESIDENT, COMP_MOD.LAUNCHES,
            COMP_MOD.LAUNCHES_RESIDENT) == before


def test_resident_kernels_propagate_nan_through_padding(cuda):
    h = torch.ones((4, 256), device=cuda)
    h[0] = float("nan")
    idx = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    assert torch.isnan(ell_spmm_resident(
        idx, torch.zeros((2, 8), device=cuda), h)).all()
    out = lmc_compensate_resident(
        h, torch.zeros(2, dtype=torch.int32, device=cuda),
        torch.zeros(2, device=cuda), torch.ones((2, 256), device=cuda),
        torch.zeros(2, device=cuda))
    assert torch.isnan(out).all()


@pytest.mark.parametrize("stream", [None, False], ids=["stream", "resident"])
def test_train_step_on_gpu_matches_cpu(cuda, stream):
    """One LMC step on the ell backend on the card (kernels in the forward
    and in the backward) against the same step on the CPU (plain twins)."""
    from repro_torch.convert import state_from_reference
    from repro_torch.core import LMC, commit_rows, from_graph, host_batch
    from repro_torch.core import make_train_step
    from repro_torch.graph import ClusterSampler, make_sbm_dataset
    from repro_torch.models import make_gnn

    graph = make_sbm_dataset("ppi-cpu", seed=3)
    gnn = make_gnn("gcn", graph.feature_dim, 64, graph.num_classes, 3,
                   generator=torch.Generator().manual_seed(0))
    sg = ClusterSampler(graph, 8, 2, seed=0).sample()
    rng = np.random.default_rng(0)
    h0 = rng.normal(size=(3, graph.num_nodes, 64)).astype(np.float32)
    v0 = 1e-3 * rng.normal(size=(2, graph.num_nodes, 64)).astype(np.float32)
    step = make_train_step(gnn, LMC, graph.num_nodes, backend="ell",
                           stream=stream)
    out = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.detach().to(dev), gnn.params())
        data = from_graph(graph, device=dev)
        store = state_from_reference(h0, v0, device=dev)
        batch = host_batch(sg, backend="ell").to(dev)
        counts = (SPMM_MOD.LAUNCHES + SPMM_MOD.LAUNCHES_RESIDENT,
                  COMP_MOD.LAUNCHES + COMP_MOD.LAUNCHES_RESIDENT)
        loss, grads, rows, _ = step(params, store, batch, data.x, data.self_w)
        commit_rows(store, batch, rows, graph.num_nodes)
        launched = (SPMM_MOD.LAUNCHES + SPMM_MOD.LAUNCHES_RESIDENT
                    - counts[0],
                    COMP_MOD.LAUNCHES + COMP_MOD.LAUNCHES_RESIDENT
                    - counts[1])
        out[dev] = (loss, grads, store, launched)
    assert out["cpu"][3] == (0, 0)
    assert out["cuda"][3] == (27, 5)   # 9 forward + 18 over Aᵀ; 3 + 2
    (lc, gc, sc, _), (lg, gg, sg_, _) = out["cpu"], out["cuda"]
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=0)
    for key in ("head", "layers"):
        for a, b in zip(tree_leaves(gg[key]), tree_leaves(gc[key])):
            torch.testing.assert_close(a.cpu(), b, rtol=2e-4, atol=1e-6)
    torch.testing.assert_close(sg_.h.cpu(), sc.h, rtol=2e-4, atol=1e-6)
    torch.testing.assert_close(sg_.v.cpu(), sc.v, rtol=2e-4, atol=1e-6)

