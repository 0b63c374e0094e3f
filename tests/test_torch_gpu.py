"""The CUDA kernels on the card: each against its plain PyTorch twin (the
resident-source kernels also bit for bit against the streaming ones), the
launch counters, the shared-memory cap, NaN propagation, and one training
step on the card against the same step on the CPU. Every test needs an
NVIDIA GPU and skips without one; this file imports no JAX, so it runs where
only the port is installed:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.

Tolerances: f32 rtol = atol = 1e-5 (the same f32 sums in another order;
rows split across pieces combine through atomics in no fixed order, which
the bound covers too); bf16 2e-2 compared in f32 (one bf16 rounding of the
output; the scatter form rounds a split row's merged pieces once where its
twin rounds each); the compensation is bit-equal to its twin. Matmuls in
full f32: TF32 is off.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core.history import stacked
from repro_torch.kernels import (build_ell, bucketed_spmm, ell_from_coo,
                                 ell_spmm, ell_spmm_resident,
                                 ell_spmm_resident_scatter, ell_spmm_scatter,
                                 lmc_compensate_kernel,
                                 lmc_compensate_resident)
from repro_torch.kernels.compensate import lmc_compensate_plain
from repro_torch.kernels.ell_spmm import ell_spmm_plain, ell_spmm_scatter_plain
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


# (store, fresh) dtypes: every combination the kernels take
COMP_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)]
COMP_DTYPE_IDS = ["f32-f32", "bf16-bf16", "f32-bf16", "bf16-f32"]
# N: one row, a ragged warp, the arxiv-cpu halo, the serving halo; D: each
# compile-time vector count (1, 2, 4 vectors of 128 columns, and the loop
# past 512) and the element-wise tail (D % 4 != 0)
COMP_NS = (1, 7, 2304, 3648)
COMP_DS = (50, 128, 130, 256, 520)


def _comp_inputs(cuda, sdt, fdt, n, m, d, seed):
    """Random inputs with out-of-range gids (clipped) and ~20% masked rows;
    row 0 is masked and its store row is NaN: 0·NaN must stay NaN."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    store = torch.randn((m, d), generator=g, device=cuda)
    gids = torch.randint(-3, m + 3, (n,), generator=g, device=cuda,
                         dtype=torch.int32)
    beta = torch.rand(n, generator=g, device=cuda)
    mask = (torch.rand(n, generator=g, device=cuda) > 0.2).float()
    fresh = torch.randn((n, d), generator=g, device=cuda)
    mask[0] = 0.0
    store[int(gids[0].clamp(0, m - 1))] = float("nan")
    return store.to(sdt), gids, beta, fresh.to(fdt), mask


def _assert_bit_equal(got, want):
    """Equal bit for bit where finite-or-inf; NaN at the same places (the
    two may spell a bf16 NaN differently)."""
    nan = want.isnan()
    assert nan.any() and torch.equal(got.isnan(), nan)
    ints = torch.int32 if want.dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(ints)[~nan], want.view(ints)[~nan])


@pytest.mark.parametrize("sdt,fdt", COMP_DTYPES, ids=COMP_DTYPE_IDS)
@pytest.mark.parametrize("n,m,d", [(3648, 169343, 256), (70, 123, 50)]
                         + [(n, 5000, d) for n in COMP_NS for d in COMP_DS])
def test_lmc_compensate_kernel_matches_plain(cuda, sdt, fdt, n, m, d):
    args = _comp_inputs(cuda, sdt, fdt, n, m, d, n + d)
    before = COMP_MOD.LAUNCHES
    got = lmc_compensate_kernel(*args)
    assert COMP_MOD.LAUNCHES == before + 1
    # same casts and operation order, no fused multiply-add: bit-equal
    _assert_bit_equal(got, lmc_compensate_plain(*args))


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


# ------------------------------------------------------ scatter form
def _padded_row0_graph(seed, n=300, pad_edges=40_000):
    """A PaddedSubgraph-like COO: real edges, heavy rows of degree 129, 260
    and 300, and ``pad_edges`` zero-weight edges 0 -> 0, so row 0 holds
    hundreds of all-zero K = 128 pieces (as at full width), with the
    fixed-capacity buckets' padding rows at their tails."""
    r = np.random.default_rng(seed)
    deg = r.integers(0, 40, n)
    deg[1:4] = (129, 260, 300)
    dst = np.repeat(np.arange(n), deg)
    src = r.integers(0, n, dst.shape[0])
    w = r.random(dst.shape[0]).astype(np.float32)
    src = np.concatenate([src, np.zeros(pad_edges, np.int64)])
    dst = np.concatenate([dst, np.zeros(pad_edges, np.int64)])
    w = np.concatenate([w, np.zeros(pad_edges, np.float32)])
    return ell_from_coo(src, dst, w, n, with_transpose=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [256, 130])
@pytest.mark.parametrize("resident", [False, True], ids=["stream", "resident"])
def test_ell_spmm_scatter_matches_plain(cuda, dtype, d, resident):
    """Each bucket's scatter launch into one zeroed output against the plain
    twin (per-bucket result, index_add_, padding rows dropped), with the real
    row counts and without them (the kernel then tests every rid)."""
    g = _padded_row0_graph(d)
    gc = g.to(cuda)
    h = torch.randn((g.num_cols, d), generator=torch.Generator(
        device=cuda).manual_seed(d), device=cuda).to(dtype)
    kernel = ell_spmm_resident_scatter if resident else ell_spmm_scatter
    counter = "LAUNCHES_RESIDENT" if resident else "LAUNCHES"
    # bf16 against the f32 twin: the kernel rounds a row's merged pieces
    # once per run (rows of degree ≤ 300 span ≤ 2 runs) and adds in bf16,
    # 3 roundings of 2^-9 at most, each relative to the row's largest sum
    want = torch.zeros((g.num_rows, d), device=cuda)
    for idx, w, rows in zip(gc.bucket_idx, gc.bucket_w, gc.bucket_rows):
        ell_spmm_scatter_plain(idx, w, rows, h.float(), want)
    scale = 1.0 + want.abs().amax(dim=1, keepdim=True)
    for reals in (gc.bucket_real, (None,) * len(gc.bucket_real)):
        got = torch.zeros((g.num_rows, d), dtype=dtype, device=cuda)
        before = getattr(SPMM_MOD, counter)
        for idx, w, rows, real in zip(gc.bucket_idx, gc.bucket_w,
                                      gc.bucket_rows, reals):
            assert kernel(idx, w.to(dtype), rows, h, got, real) is got
        assert getattr(SPMM_MOD, counter) == before + len(gc.bucket_idx)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, **F32)
        else:
            assert ((got.float() - want).abs() <= 6e-3 * scale).all()


def test_scatter_resident_bit_equal_to_streaming(cuda):
    """Per bucket and for the whole bucketed_spmm: the same fmaf chains,
    the same runs, so the same bits (a heavy row spans at most two runs,
    whose two atomic adds commute; row 0's other runs add zeros)."""
    g = _padded_row0_graph(7).to(cuda)
    h = torch.randn((g.num_cols, 256), device=cuda)
    for idx, w, rows, real in zip(g.bucket_idx, g.bucket_w, g.bucket_rows,
                                  g.bucket_real):
        a = ell_spmm_scatter(idx, w, rows, h, torch.zeros_like(h), real)
        b = ell_spmm_resident_scatter(idx, w, rows, h, torch.zeros_like(h),
                                      real)
        assert torch.equal(a, b)
    assert torch.equal(bucketed_spmm(g, h, stream=False), bucketed_spmm(g, h))


@pytest.mark.parametrize("poison", [float("nan"), float("inf")])
@pytest.mark.parametrize("stream", [None, False], ids=["stream", "resident"])
def test_zero_run_poison_matches_plain(cuda, poison, stream):
    """A NaN (or inf: 0·inf = NaN) at h[0] under zero-weight runs poisons
    exactly the rows the plain twin poisons: row 0 (its all-zero pieces)
    and every real row with a padding slot (idx 0, w 0), no more, no
    fewer."""
    g = _padded_row0_graph(11)
    h = torch.randn((g.num_cols, 256))
    h[0] = poison
    want = bucketed_spmm(g, h)          # CPU: the plain twins
    got = bucketed_spmm(g.to(cuda), h.to(cuda), stream=stream).cpu()
    bad_want, bad_got = ~torch.isfinite(want), ~torch.isfinite(got)
    assert bad_want.any(dim=1)[0] and bad_want.any(dim=1).sum() > 1
    assert torch.equal(bad_got, bad_want)
    ok = ~bad_want
    torch.testing.assert_close(got[ok], want[ok], **F32)


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


@pytest.mark.parametrize("sdt,fdt", COMP_DTYPES, ids=COMP_DTYPE_IDS)
@pytest.mark.parametrize("n,m,d", [(2304, 4096, 256), (70, 123, 50),
                                   (300, 500, 130)]
                         + [(n, m, d) for m in (4096, 14000) for n in COMP_NS
                            for d in COMP_DS])
def test_lmc_compensate_resident_bit_equal(cuda, sdt, fdt, n, m, d):
    """The wrapper's layout and two others (one row share per column tile;
    shares of 7 rows, many blocks, most of them one pass) against the
    streaming kernel and the plain twin, bit for bit. M = 14,000 leaves a
    4-column slab (f32): 64 column tiles, 1-lane groups."""
    args = _comp_inputs(cuda, sdt, fdt, n, m, d, n + d + 1)
    want = lmc_compensate_plain(*args)
    before = COMP_MOD.LAUNCHES_RESIDENT
    got = lmc_compensate_resident(*args)
    assert COMP_MOD.LAUNCHES_RESIDENT == before + 1
    _assert_bit_equal(got, lmc_compensate_kernel(*args))
    _assert_bit_equal(got, want)
    for rows in (n, 7):
        _assert_bit_equal(COMP_MOD._launch(*args, True, block_rows=rows),
                          want)


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



def test_async_checkpoint_of_a_cuda_store_survives_later_writes(cuda,
                                                                tmp_path):
    """A background save snapshots the store to the host before it returns:
    writing the store right after (as the next step's commit does) changes
    nothing in the checkpoint, which verifies and restores the old values."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import init_history
    store = init_history(3, 50_000, 256, device=cuda)
    store.h.normal_(generator=torch.Generator(device=cuda).manual_seed(0))
    want = store.h.cpu()
    cm = CheckpointManager(tmp_path)
    cm.save(1, {"store": (store.h, store.v)}, {}, background=True)
    store.h.fill_(float("nan"))
    store.v.fill_(1.0)
    cm.close()
    assert cm.verify(1)
    tree, _, step = cm.restore({"store": (store.h, store.v)})
    assert step == 1
    assert torch.equal(torch.from_numpy(tree["store"][0]), want)
    assert not tree["store"][1].any()
    assert set(cm.times[-1]) == {"step", "snapshot", "crc32", "np_save"}


@pytest.mark.parametrize("backend", ["segment", "ell"])
def test_pipeline_batch_staged_on_side_stream_equals_sync(cuda, backend):
    """Pinned host batches copied on the side stream (depth 2) equal the
    synchronous copies (depth 0), slot for slot; the compute stream waited
    for each copy, and the pinned bytes were counted."""
    from repro_torch.data import SubgraphPipeline
    from repro_torch.graph import ClusterSampler, make_sbm_dataset
    graph = make_sbm_dataset("ppi-cpu", seed=3)

    from repro_torch import trace

    def stream(depth):
        sampler = ClusterSampler(graph, 8, 2, seed=0)
        with SubgraphPipeline(sampler, backend=backend, depth=depth,
                              workers=2, num_steps=5, device=cuda) as pipe:
            out, slots = [], []
            for b in pipe:
                out.append([t.clone() for t in b.tensors()])
                slots.append(pipe.slot)
            assert pipe.host.batch_gids.is_pinned() == (depth > 0)
            return out, pipe.pinned_peak_bytes, slots

    sync, sync_pinned, sync_slots = stream(0)
    staged, pinned, slots = stream(2)
    assert sync_pinned == 0
    assert all(copy == {} and "pin_ms" not in rec
               for rec, copy in sync_slots)
    assert pinned > 0 and len(slots) == 5
    assert all(rec["pin_ms"] > 0 for rec, _ in slots)
    torch.cuda.synchronize()
    assert all(trace.elapsed_ms(copy)["pipeline.copy"] >= 0
               for _, copy in slots)
    ell = backend == "ell"
    assert all(("pipeline.ell" in copy) == ell for _, copy in slots)
    assert all(rec["ell_launches"] == 4 * ell
               for rec, _ in slots + sync_slots)
    assert len(sync) == len(staged) == 5
    for a, b in zip(sync, staged):
        assert all(x.is_cuda and torch.equal(x, y) for x, y in zip(a, b))


def _bench_batch(preset: str):
    """The first slot of the benchmark's epoch schedule on its graph
    (``perfbench/data/sbm.py`` at seed 0; 32 parts, 4 clusters a batch):
    the padded subgraph the training cells build first."""
    from perfbench.data.sbm import make_sbm
    from repro_torch.graph import ClusterSampler, partition_graph
    from repro_torch.graph.structure import Graph
    graph = Graph(**make_sbm(preset, seed=0), name=preset)
    sampler = ClusterSampler(graph, 32, 4, seed=0,
                             parts=partition_graph(graph, 32, seed=0))
    return sampler.build_batch(sampler.clusters_at(0, mode="epoch"))


def _assert_ell_equal(got, want) -> None:
    assert got.bucket_real == want.bucket_real
    for a, b in zip(got.bucket_idx + got.bucket_w + got.bucket_rows,
                    want.bucket_idx + want.bucket_w + want.bucket_rows,
                    strict=True):
        assert a.is_cuda and a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu(), b)
    assert (got.transpose is None) == (want.transpose is None)
    if want.transpose is not None:
        _assert_ell_equal(got.transpose, want.transpose)


@pytest.mark.parametrize("preset", ["arxiv-like", "ppi-like"])
def test_ell_build_kernel_equals_numpy_at_bench_shapes(cuda, preset):
    """The buckets of A and Aᵀ built on the card from the copied COO equal
    the numpy builder's bit for bit, ``bucket_real`` included, at the
    gcn-arxiv and gcnii-ppi cells' first batch; two launches a direction
    (rows, scatter)."""
    from repro_torch.core import host_batch
    build_mod = importlib.import_module("repro_torch.kernels.ell_build")
    sg = _bench_batch(preset)
    want = ell_from_coo(sg.edge_src, sg.edge_dst, sg.edge_w, sg.n_ext,
                        with_transpose=True)
    before = build_mod.LAUNCHES
    got = host_batch(sg, backend="ell").to(cuda)
    torch.cuda.synchronize()
    assert build_mod.LAUNCHES == before + 4
    _assert_ell_equal(got.ell, want)
    fwd = host_batch(sg, backend="ell", with_transpose=False).to(cuda)
    assert build_mod.LAUNCHES == before + 6
    _assert_ell_equal(fwd.ell, ell_from_coo(sg.edge_src, sg.edge_dst,
                                            sg.edge_w, sg.n_ext))


def test_ell_rows_kernel_matches_plain(cuda):
    """Row starts and per-bucket row counts of sorted keys with empty rows,
    a heavy row (3 × 128 + 5 edges), rows at each width, and keys outside
    [0, n) at both ends, against the plain twin."""
    build_mod = importlib.import_module("repro_torch.kernels.ell_build")
    r = np.random.default_rng(7)
    n = 500
    deg = r.choice([0, 0, 1, 7, 8, 9, 31, 32, 33, 128, 129], size=n)
    deg[3] = 3 * 128 + 5
    key = np.concatenate([[-2, -1], np.repeat(np.arange(n), deg),
                          [n, n + 4]]).astype(np.int32)
    lay = build_mod.Layout.of((8, 32, 128), (1, 1, 1), (0, 0, 0))
    out = {}
    for dev in ("cpu", cuda):
        rowptr = torch.empty(n + 1, dtype=torch.int32, device=dev)
        counts = torch.empty(3 * n, dtype=torch.int32, device=dev)
        before = build_mod.LAUNCHES
        build_mod.ell_rows(torch.from_numpy(key).to(dev), rowptr, counts,
                           lay)
        out[str(dev)] = (rowptr.cpu(), counts.cpu(),
                         build_mod.LAUNCHES - before)
    (rc, cc, lc), (rg, cg, lg) = out["cpu"], out["cuda"]
    assert (lc, lg) == (0, 1)
    assert torch.equal(rg, rc) and torch.equal(cg, cc)
    assert rc[0] == 2 and rc[-1] == key.shape[0] - 2
    assert cc.view(3, n)[:, 3].tolist() == [1, 0, 3]


def _card_pipe(cuda):
    from repro_torch.data import SubgraphPipeline
    from repro_torch.graph import ClusterSampler, make_sbm_dataset
    graph = make_sbm_dataset("ppi-cpu", seed=3)
    return SubgraphPipeline(ClusterSampler(graph, 8, 2, seed=0),
                            backend="ell", depth=2, workers=2, num_steps=4,
                            device=cuda)


def test_staging_a_slot_makes_no_host_sync(cuda):
    """The batch's copy and its ELL build on the side stream, as staged
    for a step, wait on the device nowhere (sync debug mode "error"), and
    give the buckets the numpy builder gives."""
    with _card_pipe(cuda) as pipe:
        hb, rec = pipe._build_host(0, pin=True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            staged = pipe._stage((hb, rec))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    assert rec["ell_launches"] == 4
    assert set(staged.copy) == {"pipeline.copy", "pipeline.ell"}
    b = hb.to("cpu")   # the same plan, built on the CPU
    _assert_ell_equal(staged.batch.ell, b.ell)


def test_build_host_launches_nothing_on_the_card(cuda):
    """A builder thread's share of a slot (sampling, the ELL plan,
    pinning) puts no kernel, copy or fill on the card."""
    from torch.profiler import ProfilerActivity, profile
    build_mod = importlib.import_module("repro_torch.kernels.ell_build")
    with _card_pipe(cuda) as pipe:
        torch.cuda.synchronize()
        before = build_mod.LAUNCHES
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            hb, rec = pipe._build_host(1, pin=True)
            torch.cuda.synchronize()
    assert build_mod.LAUNCHES == before
    assert hb.batch_gids.is_pinned() and not hb.edge_src.is_cuda
    on_card = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert on_card == [], on_card


def _card_trainer(cuda):
    """A GCN 2×32 on ppi-cpu, trained on the card through the pipeline
    (depth 2, pinned batches copied on the side stream)."""
    from repro_torch.core import LMC
    from repro_torch.graph import ClusterSampler, make_sbm_dataset
    from repro_torch.models import make_gnn
    from repro_torch.optim import sgd
    from repro_torch.train import GNNTrainer
    graph = make_sbm_dataset("ppi-cpu", seed=3)
    gnn = make_gnn("gcn", graph.feature_dim, 32, graph.num_classes, 2,
                   generator=torch.Generator().manual_seed(0))
    return GNNTrainer(gnn, LMC, graph, ClusterSampler(graph, 8, 2, seed=0),
                      sgd(lr=0.2), backend="ell", prefetch=2,
                      straggler_deadline=float("inf"), device=cuda)


def _profiled_run(cuda, steps: int):
    """One unprofiled step (kernel builds, the first batch), then ``steps``
    under the profiler; (profiler, the profiled steps' records)."""
    from torch.profiler import ProfilerActivity, profile
    tr = _card_trainer(cuda)
    tr.run(1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.run(steps)
    tr.close()
    return prof, tr.history


def test_profiled_trainer_fills_device_spans(cuda):
    """Under the profiler every step carries the compute stream's ms of
    the optimizer and the store commit, and every slot its side-stream copy
    and ELL build ms and the build's launches; the spans show in the
    trace."""
    prof, hist = _profiled_run(cuda, 4)
    first, recs = hist[0], hist[1:]
    assert "device_ms" not in first and first["slot"]["copy_ms"] > 0
    assert first["slot"]["ell_ms"] > 0 and first["slot"]["ell_launches"] == 4
    assert [r["step"] for r in recs] == [2, 3, 4, 5]
    for r in recs:
        assert set(r["device_ms"]) == {"optimizer", "commit"}, r
        assert all(v > 0 for v in r["device_ms"].values()), r
        assert r["slot"]["copy_ms"] > 0 and r["slot"]["pin_ms"] > 0
        assert r["slot"]["copy_bytes"] > 0
        # A and Aᵀ built on the side stream: rows and scatter each
        assert r["slot"]["ell_ms"] > 0 and r["slot"]["ell_launches"] == 4
    names = {e.name for e in prof.events()}
    assert {"trainer.wait", "step.lmc", "step.optimizer",
            "step.commit"} <= names


SYNCS = ("cudaStreamSynchronize", "cudaEventSynchronize",
         "cudaDeviceSynchronize")


def test_spans_add_no_synchronisation(cuda, monkeypatch):
    """A profiled run with the device spans on makes as many synchronising
    CUDA runtime calls and device-to-host copies as one with them off (the
    program's path without a profiler)."""
    from collections import Counter
    from repro_torch import trace

    def syncs(prof):
        return Counter(e.name for e in prof.events()
                       if e.name in SYNCS or e.name.startswith("Memcpy DtoH"))

    on, hist_on = _profiled_run(cuda, 4)
    with monkeypatch.context() as m:
        m.setattr(trace, "profiling", lambda: False)
        off, hist_off = _profiled_run(cuda, 4)
    assert "device_ms" in hist_on[2] and "device_ms" not in hist_off[2]
    assert syncs(on) == syncs(off), (syncs(on), syncs(off))
    assert syncs(on)["cudaStreamSynchronize"] >= 4


def _norm_rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def _dist_setup(cuda):
    """ppi-cpu, 8 parts, GCN 2×32 on the card (tests/test_distributed.py's
    configuration), random non-zero stores."""
    from repro_torch.core import HistoricalState, from_graph
    from repro_torch.graph import (ClusterSampler, make_sbm_dataset,
                                   partition_graph)
    from repro_torch.models import make_gnn
    graph = make_sbm_dataset("ppi-cpu", seed=3)
    sampler = ClusterSampler(graph, 8, 1, seed=1,
                             parts=partition_graph(graph, 8, seed=0))
    gnn = make_gnn("gcn", graph.feature_dim, 32, graph.num_classes, 2,
                   generator=torch.Generator().manual_seed(0))
    params = tree_map(lambda t: t.detach().to(cuda), gnn.params())
    g = torch.Generator(device=cuda).manual_seed(1)
    n = graph.num_nodes
    store = HistoricalState(
        h=torch.randn((2, n, 32), generator=g, device=cuda),
        v=1e-2 * torch.randn((1, n, 32), generator=g, device=cuda))
    return graph, sampler, gnn, params, from_graph(graph, device=cuda), store


def test_stacked_step_on_gpu_is_the_mean_of_device_steps(cuda):
    """chip_smoke phase 8a at a small size: the flat step over 4 stacked
    clusters on the CUDA kernels against the mean of the 4 per-device steps
    (loss rtol 1e-4; each gradient leaf and the h/v rows in norm, rtol
    2e-4, the bar of the SpMM's atomics)."""
    from repro_torch.core import LMC, host_batch, make_train_step
    from repro_torch.core.distributed import stack_batches
    graph, sampler, gnn, params, data, store = _dist_setup(cuda)
    sgs = [sampler.build_batch(np.array([d])) for d in range(4)]
    step = make_train_step(gnn, LMC, graph.num_nodes, backend="ell")
    before = SPMM_MOD.LAUNCHES, COMP_MOD.LAUNCHES
    loss, grads, rows, _ = step(params, store,
                                stack_batches(sgs, backend="ell").to(cuda),
                                data.x, data.self_w)
    assert SPMM_MOD.LAUNCHES > before[0] and COMP_MOD.LAUNCHES == \
        before[1] + 3   # 2 forward + 1 backward compensation
    per = [step(params, store, host_batch(sg, backend="ell").to(cuda),
                data.x, data.self_w) for sg in sgs]
    torch.testing.assert_close(
        loss.reshape(()), (sum(p[0] for p in per) / 4).reshape(()),
        rtol=1e-4, atol=0)
    mean = tree_map(lambda *g: sum(g) / 4, *(p[1] for p in per))
    for a, b in zip(tree_leaves(grads), tree_leaves(mean), strict=True):
        assert _norm_rel(a, b) <= 2e-4
    nb = sgs[0].n_batch
    for d, p in enumerate(per):
        part = slice(d * nb, (d + 1) * nb)
        assert _norm_rel(stacked(rows.h)[:, part], stacked(p[2].h)) <= 2e-4
        assert _norm_rel(stacked(rows.v)[:, part], stacked(p[2].v)) <= 2e-4


def test_distributed_step_over_nccl_matches_the_plain_step(cuda, tmp_path):
    """chip_smoke phase 8b at a small size: the row-sharded step over an
    NCCL group of one rank (fetch_rows, all-reduce and route_rows on the
    card) against the plain step on the same batch: the committed h and v
    bit for bit, loss and gradients at the SpMM's bar."""
    import torch.distributed as dist
    from repro_torch.core import (LMC, HistoricalState, commit_rows,
                                  host_batch, make_train_step)
    from repro_torch.core.distributed import (commit_owned_rows,
                                              make_distributed_train_step)
    graph, sampler, gnn, params, data, store = _dist_setup(cuda)
    n = graph.num_nodes
    batch = host_batch(sampler.build_batch(np.array([3])),
                       backend="ell").to(cuda)
    plain = HistoricalState(store.h.clone(), store.v.clone())
    l1, g1, rows, _ = make_train_step(gnn, LMC, n, backend="ell")(
        params, plain, batch, data.x, data.self_w)
    commit_rows(plain, batch, rows, n)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'i'}",
                            world_size=1, rank=0)
    try:
        l2, g2, owned, _ = make_distributed_train_step(
            gnn, LMC, n, backend="ell")(params, store, batch, data.x,
                                        data.self_w)
        commit_owned_rows(store, owned, n)
    finally:
        dist.destroy_process_group()
    assert torch.equal(store.h, plain.h) and torch.equal(store.v, plain.v)
    torch.testing.assert_close(l2, l1, rtol=1e-4, atol=0)
    for a, b in zip(tree_leaves(g2), tree_leaves(g1), strict=True):
        assert _norm_rel(a, b) <= 2e-4


def test_resident_kernels_serve_the_streaming_logits(cuda):
    """ServeConfig.stream=False on the card at arxiv-cpu, where the resident
    kernels fit: the exact rung's logits equal stream=True's bit for bit,
    through the resident launches only."""
    from repro_torch.core import HistoricalState, from_graph
    from repro_torch.graph import make_sbm_dataset
    from repro_torch.models import make_gnn
    from repro_torch.serve import GNNServer, ServeConfig, warm_store
    graph = make_sbm_dataset("arxiv-cpu", seed=0)
    gnn = make_gnn("gcn", graph.feature_dim, 256, graph.num_classes, 3,
                   generator=torch.Generator().manual_seed(0)).to(cuda)
    params = gnn.params()
    data = from_graph(graph, device=cuda)
    store = warm_store(gnn, params, data, device=cuda)
    rng = np.random.default_rng(0)
    reqs = [rng.choice(graph.num_nodes, k, replace=False)
            for k in (1, 8, 30, 100, 128)]
    out = {}
    for stream in (True, False):
        srv = GNNServer(gnn, graph, params,
                        store=HistoricalState(store.h.clone()), data=data,
                        config=ServeConfig(backend="ell", stream=stream,
                                           return_logits=True,
                                           default_deadline_s=60.0),
                        device=cuda)
        before = (SPMM_MOD.LAUNCHES_RESIDENT, COMP_MOD.LAUNCHES_RESIDENT)
        try:
            rs = [srv.infer(q) for q in reqs]
        finally:
            assert srv.drain(timeout=60.0)
        assert all(r.status == "ok" and r.mode == "exact" for r in rs)
        resident = (SPMM_MOD.LAUNCHES_RESIDENT - before[0],
                    COMP_MOD.LAUNCHES_RESIDENT - before[1])
        assert (min(resident) > 0) == (stream is False), resident
        out[stream] = [r.logits for r in rs]
    assert all(np.array_equal(a, b) for a, b in zip(out[False], out[True]))


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "zamba2-1.2b"])
def test_lm_train_step_on_gpu_matches_cpu(cuda, name):
    """One ``make_lm_train_step`` step of a reduced arch with its own
    optimizer and microbatches, on the card against the CPU from the same
    bf16 parameters and batch: loss and gradient norm within the family
    tolerance of tests/test_lm_archs.py:14, new parameters finite."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch.steps import make_lm_train_step
    from repro_torch.models.lm import LM
    from repro_torch.models.spec import tree_leaves as lm_leaves
    from repro_torch.optim import make_optimizer
    tol = {"moe": 0.12, "hybrid": 0.05}.get(reduced_config(name).family, 0.02)
    cfg = reduced_config(name)
    cpu = LM(cfg, device="cpu")
    pc = cpu.init_params(torch.Generator().manual_seed(0))
    card = LM(cfg, device=cuda)
    pg = card.load_params(tree_map(lambda t: t.detach().to(cuda), pc))
    b = max(2, cfg.microbatches)
    toks = torch.randint(0, cfg.vocab, (b, 64),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "loss_mask": torch.ones(b, 64)}
    out = []
    for lm, params in ((cpu, pc), (card, pg)):
        opt = make_optimizer(cfg.optimizer)
        out.append(make_lm_train_step(lm, opt)(params, opt.init(params),
                                               batch))
    (_, _, mc), (pn, _, mg) = out
    for k in ("loss", "grad_norm"):
        assert abs(float(mc[k]) - float(mg[k])) <= tol * abs(float(mc[k])), k
    assert all(t.device.type == card.device.type and
               bool(torch.isfinite(t).all())
               for _, t in lm_leaves(pn))


def test_moe_block_backward_is_deterministic_on_gpu(cuda):
    """The MoE data path moves rows by gathers only, forward and backward
    (the reference's custom VJPs), so two backward passes of a full-width
    dispatch give equal bits on the card; the embedding's scatter-add is
    the one backward with atomics, and it is not in this block."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import blocks as TB
    from repro_torch.models.spec import materialize
    cfg = get_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=16))
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = materialize(TB.moe_spec(cfg), gen, cuda)
    h = torch.randn((4, 256, cfg.d_model), generator=gen,
                    device=cuda).to(torch.bfloat16)
    ct = torch.randn(h.shape, generator=gen, device=cuda).to(torch.bfloat16)
    grads = []
    for _ in range(2):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        x = h.detach().requires_grad_(True)
        out = TB.moe_apply(leaves, x, cfg)
        grads.append(torch.autograd.grad(out, [x, *leaves.values()], ct))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
