"""Port parity, host side: graphs, subgraphs, presets and ELL bucket arrays.

The numpy modules of ``repro_torch`` are copies of the reference's, and the
ELL construction must produce bucket arrays that *equal* the reference's exactly
(no tolerance: same integers, same float32 bits).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import graph as jgraph
from repro.checkpoint import crc32_array as j_crc32
from repro.core import methods as jmethods
from repro.kernels import build_ell as j_build_ell
from repro.kernels import ell_from_coo as j_ell_from_coo
from repro.kernels.ops import _build_ell_loop as j_build_ell_loop

from repro_torch import graph as tgraph
from repro_torch.checkpoint import crc32_array as t_crc32
from repro_torch.core import methods as tmethods
from repro_torch.kernels import (ELLCapacityError, ELLGraph, build_ell,
                                 bucketed_spmm, ell_from_coo)
from repro_torch.kernels.ops import _build_ell_loop


def _random_csr(seed, n_max=60, heavy=True):
    """Random CSR with deg-0 rows and (optionally) heavy rows > max bucket."""
    r = np.random.default_rng(seed)
    n = int(r.integers(5, n_max))
    choices = [0, 1, 3, 7, 8, 20] + ([130, 300] if heavy else [])
    deg = r.choice(choices, size=n)
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    nnz = int(indptr[-1])
    indices = r.integers(0, n, nnz).astype(np.int32)
    weights = r.random(nnz).astype(np.float32)
    return indptr, indices, weights


def _arrays(g):
    return [np.asarray(a) for a in g.bucket_idx + g.bucket_w + g.bucket_rows]


def _arrays_t(g):
    return g.bucket_idx + g.bucket_w + g.bucket_rows


def _assert_ell_equal(g_port, g_ref):
    """Bucket arrays (and the transpose's) equal exactly, shapes included."""
    assert (g_port.num_rows, g_port.num_cols) == (g_ref.num_rows,
                                                  g_ref.num_cols)
    for a, b in zip(_arrays(g_port), _arrays(g_ref), strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (g_port.transpose is None) == (g_ref.transpose is None)
    if g_ref.transpose is not None:
        _assert_ell_equal(g_port.transpose, g_ref.transpose)


# ------------------------------------------------------------ graph copies
@pytest.mark.parametrize("preset,seed", [("ppi-cpu", 3), ("arxiv-cpu", 0),
                                         ("flickr-cpu", 7)])
def test_sbm_dataset_identical(preset, seed):
    """Both packages build the same graph for a seed, array for array."""
    a = jgraph.make_sbm_dataset(preset, seed=seed)
    b = tgraph.make_sbm_dataset(preset, seed=seed)
    for f in ("indptr", "indices", "x", "y", "train_mask", "val_mask",
              "test_mask"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert a.name == b.name
    assert tgraph.DATASET_PRESETS == jgraph.DATASET_PRESETS


@pytest.mark.parametrize("kw", [
    {},
    {"include_halo": False, "edge_weight_mode": "local"},
    {"beta_spec": ("x2", 0.5)},
])
def test_build_subgraph_identical(small_graph, kw):
    g_port = tgraph.make_sbm_dataset("ppi-cpu", seed=3)
    rng = np.random.default_rng(0)
    nodes = np.sort(rng.choice(small_graph.num_nodes, 40, replace=False))
    pads = dict(pad_batch=64, pad_halo=1024, pad_edges=16384, num_parts=16,
                clusters_in_batch=2)
    a = jgraph.build_subgraph(small_graph, nodes, **pads, **kw)
    b = tgraph.build_subgraph(g_port, nodes, **pads, **kw)
    for f in dataclasses.fields(a):
        x, y = np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name))
        assert x.dtype == y.dtype, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.mark.parametrize("score", ["x2", "2x-x2", "x", "1", "sin"])
def test_beta_score_identical(score):
    from repro.graph.structure import beta_score as j_beta
    r = np.random.default_rng(1)
    local = r.integers(0, 20, 50)
    glob = local + r.integers(0, 20, 50)
    np.testing.assert_array_equal(tgraph.beta_score(local, glob, score, 0.7),
                                  j_beta(local, glob, score, 0.7))
    assert tgraph.TI_SCALE_CLIP == jgraph.structure.TI_SCALE_CLIP


def test_methods_and_crc_identical():
    assert tmethods.RHO_BUDGET_DEFAULT == jmethods.RHO_BUDGET_DEFAULT
    assert set(tmethods.METHODS) == set(jmethods.METHODS)
    for name, m in jmethods.METHODS.items():
        assert dataclasses.asdict(tmethods.METHODS[name]) == \
            dataclasses.asdict(m)
    arr = np.random.default_rng(0).normal(size=(7, 5)).astype(np.float32)
    assert t_crc32(arr) == j_crc32(arr)
    assert t_crc32(arr[:, 1]) == j_crc32(arr[:, 1])   # non-contiguous view


# ------------------------------------------------------ ELL construction
@pytest.mark.parametrize("seed", range(6))
def test_build_ell_matches_reference(seed):
    """Vectorised construction == the reference's, transpose included, and
    == the port's own per-node loop."""
    indptr, indices, weights = _random_csr(seed)
    g = build_ell(indptr, indices, weights, with_transpose=True)
    assert all(isinstance(a, torch.Tensor) for a in _arrays_t(g))
    _assert_ell_equal(g, j_build_ell(indptr, indices, weights))
    g_loop = _build_ell_loop(indptr, indices, weights)
    _assert_ell_equal(build_ell(indptr, indices, weights,
                                with_transpose=False), g_loop)
    _assert_ell_equal(g_loop, j_build_ell_loop(indptr, indices, weights))


def test_build_ell_numpy_output():
    indptr, indices, weights = _random_csr(1)
    g = build_ell(indptr, indices, weights, with_transpose=True,
                  as_torch=False)
    assert all(isinstance(a, np.ndarray) for a in _arrays_t(g))
    _assert_ell_equal(g, j_build_ell(indptr, indices, weights, as_jax=False))


def test_build_ell_edgeless_graph():
    """Zero edges: all-padding deg-0 rows, equal to the per-node loop and the
    reference, and the SpMM gives exactly 0."""
    n = 10
    indptr = np.zeros(n + 1, np.int64)
    empty_i, empty_w = np.zeros(0, np.int32), np.zeros(0, np.float32)
    g = build_ell(indptr, empty_i, empty_w, with_transpose=True)
    _assert_ell_equal(g, j_build_ell(indptr, empty_i, empty_w))
    _assert_ell_equal(build_ell(indptr, empty_i, empty_w,
                                with_transpose=False),
                      _build_ell_loop(indptr, empty_i, empty_w))
    out = bucketed_spmm(g, torch.ones((n, 8)))
    assert torch.equal(out, torch.zeros((n, 8)))


def test_build_ell_transpose_is_adjoint():
    """⟨A h, y⟩ == ⟨h, Aᵀ y⟩, both sides through bucketed_spmm (rtol 1e-5:
    f32 sums of ~1e3 terms in two different orders)."""
    indptr, indices, weights = _random_csr(7)
    n = indptr.shape[0] - 1
    g = build_ell(indptr, indices, weights, block_rows=64,
                  with_transpose=True)
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.normal(size=(n, 24)))
    y = torch.from_numpy(rng.normal(size=(n, 24)))
    h32, y32 = h.float(), y.float()
    lhs = torch.vdot(bucketed_spmm(g, h32).reshape(-1).double(),
                     y.reshape(-1))
    rhs = torch.vdot(h.reshape(-1),
                     bucketed_spmm(g.transpose, y32).reshape(-1).double())
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-5)


def test_build_ell_exactly_at_capacity():
    """rows == capacity is legal: no padding rows, exact aggregation."""
    n = 8
    r = np.random.default_rng(0)
    deg = np.arange(1, n + 1)
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = r.integers(0, n, int(indptr[-1])).astype(np.int32)
    weights = r.random(int(indptr[-1])).astype(np.float32)
    g = build_ell(indptr, indices, weights, row_capacity=(8, 8, 8),
                  with_transpose=True)
    _assert_ell_equal(g, j_build_ell(indptr, indices, weights,
                                     row_capacity=(8, 8, 8)))
    assert g.bucket_idx[0].shape[0] == 8
    h = r.normal(size=(n, 8)).astype(np.float32)
    out = bucketed_spmm(g, torch.from_numpy(h)).numpy()
    ref = np.zeros((n, 8), np.float32)
    np.add.at(ref, np.repeat(np.arange(n), deg), weights[:, None] * h[indices])
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_build_ell_overflow_raises_named_error():
    n = 9
    indptr = np.arange(n + 1, dtype=np.int64)
    with pytest.raises(ELLCapacityError, match="bucket 0 .*9 rows exceed"):
        build_ell(indptr, np.zeros(n, np.int32), np.ones(n, np.float32),
                  row_capacity=(8, 8, 8))
    assert issubclass(ELLCapacityError, ValueError)


@pytest.mark.parametrize("seed", range(4))
def test_ell_from_coo_matches_reference_and_never_overflows(seed):
    """Fixed capacities hold for a heavy hub row; arrays equal the
    reference's; aggregation equals a float64 scatter-add oracle."""
    r = np.random.default_rng(seed)
    n, e = 48, 600
    hub = int(r.integers(0, n))
    dst = np.where(r.random(e) < 0.5, hub, r.integers(0, n, e))
    src = r.integers(0, n, e)
    w = r.random(e).astype(np.float32)
    g = ell_from_coo(src, dst, w, n, with_transpose=True)
    _assert_ell_equal(g, j_ell_from_coo(src, dst, w, n))
    h = r.normal(size=(n, 8)).astype(np.float32)
    out = bucketed_spmm(g, torch.from_numpy(h)).numpy()
    ref = np.zeros((n, 8))
    np.add.at(ref, dst, w[:, None].astype(np.float64) * h[src])
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_ell_from_coo_forward_path_skips_transpose():
    """Without ``with_transpose`` (the serving path) only A is bucketed, and
    its arrays still equal the reference's."""
    r = np.random.default_rng(5)
    n, e = 40, 300
    src, dst = r.integers(0, n, e), r.integers(0, n, e)
    w = r.random(e).astype(np.float32)
    g = ell_from_coo(src, dst, w, n)
    assert g.transpose is None and g.to("meta").transpose is None
    g_ref = j_ell_from_coo(src, dst, w, n)
    for a, b in zip(_arrays(g), _arrays(g_ref), strict=True):
        np.testing.assert_array_equal(a, b)


def test_ellgraph_to_moves_transpose():
    indptr, indices, weights = _random_csr(2)
    g = build_ell(indptr, indices, weights, with_transpose=True).to("meta")
    assert isinstance(g, ELLGraph)
    for t in _arrays_t(g) + _arrays_t(g.transpose):
        assert t.device.type == "meta"
    g_np = build_ell(indptr, indices, weights, with_transpose=True,
                     as_torch=False).to("cpu")
    _assert_ell_equal(g_np, j_build_ell(indptr, indices, weights))
