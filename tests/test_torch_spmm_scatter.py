"""Port parity, the SpMM's scatter form: ``bucketed_spmm`` adds every bucket
straight into one (n, D) output and skips the padding rows. Its CPU path (the
scatter twin) against the reference's ``bucketed_spmm`` (Pallas bodies in
interpret mode), forward and vjp, both ``stream`` settings, on heavy rows
(degree > 128), fixed-capacity padding rows, and a padded subgraph whose row
0 holds over a thousand all-zero pieces; and each bucket's real row count
against its destination rows. The kernels themselves: test_torch_gpu.py.

Tolerance: f32 rtol = atol = 1e-5 (sums of ≤ 300 f32 products in another
order; a split row's pieces add in another order).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bucketed_spmm as j_bucketed_spmm
from repro.kernels import ell_from_coo as j_ell_from_coo

from repro_torch.graph import build_subgraph, make_sbm_dataset
from repro_torch.kernels import (build_ell, bucketed_spmm, ell_from_coo,
                                 ell_spmm_resident_scatter, ell_spmm_scatter)
from repro_torch.kernels.ell_spmm import ell_spmm_plain, ell_spmm_scatter_plain

F32 = dict(rtol=1e-5, atol=1e-5)
SPMM_MOD = importlib.import_module("repro_torch.kernels.ell_spmm")
PAD_EXTRA = 150_000     # zero-weight edges 0 -> 0: ~1,170 K = 128 pieces


@pytest.fixture(scope="module")
def padded_subgraph():
    """A PaddedSubgraph of ppi-cpu with far more edge padding than edges."""
    graph = make_sbm_dataset("ppi-cpu", seed=1)
    batch = np.arange(0, graph.num_nodes, 3)
    probe = build_subgraph(graph, batch, pad_batch=batch.shape[0],
                           pad_halo=graph.num_nodes, pad_edges=10**7,
                           num_parts=3, clusters_in_batch=1)
    sg = build_subgraph(graph, batch, pad_batch=batch.shape[0],
                        pad_halo=graph.num_nodes,
                        pad_edges=probe.n_edges_real + PAD_EXTRA,
                        num_parts=3, clusters_in_batch=1)
    assert (sg.edge_w[sg.n_edges_real:] == 0).all()
    assert (sg.edge_dst[sg.n_edges_real:] == 0).all()
    return sg


def _heavy_csr(seed, n=40):
    """CSR with deg-0 rows and rows of degree 130, 300 and 1000."""
    r = np.random.default_rng(seed)
    deg = r.choice([0, 1, 3, 7, 8, 20, 130, 300], size=n)
    deg[:3] = (130, 300, 1000)
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    nnz = int(indptr[-1])
    return (indptr, r.integers(0, n, nnz).astype(np.int32),
            r.random(nnz).astype(np.float32))


def _assert_real_counts(g):
    """Every bucket: rows [0, real) are real (rid < n), the rest padding."""
    assert g.bucket_real is not None
    assert all(isinstance(r, int) for r in g.bucket_real)
    for rows, real in zip(g.bucket_rows, g.bucket_real, strict=True):
        rows = torch.as_tensor(rows)
        assert 0 <= real <= rows.shape[0]
        assert (rows[:real] < g.num_rows).all()
        assert (rows[real:] == g.num_rows).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_real_row_counts_match_rid(seed):
    """``bucket_real`` against the destination rows, for unfixed and fixed
    capacities, A and Aᵀ, numpy and torch arrays, and after ``to``."""
    indptr, indices, weights = _heavy_csr(seed)
    n = indptr.shape[0] - 1
    for g in (build_ell(indptr, indices, weights, with_transpose=True),
              build_ell(indptr, indices, weights, as_torch=False,
                        row_capacity=(512, 512, 512), with_transpose=True)):
        _assert_real_counts(g)
        _assert_real_counts(g.transpose)
        moved = g.to("cpu")
        assert moved.bucket_real == g.bucket_real
        assert moved.transpose.bucket_real == g.transpose.bucket_real
    # deg-0 rows are real rows too: every output row appears in a bucket
    assert sum(g.bucket_real) >= n


def test_real_row_counts_of_a_padded_subgraph(padded_subgraph):
    sg = padded_subgraph
    g = ell_from_coo(sg.edge_src, sg.edge_dst, sg.edge_w, sg.n_ext,
                     with_transpose=True)
    _assert_real_counts(g)
    _assert_real_counts(g.transpose)
    # row 0's zero pieces are real rows of the last bucket, in one run
    rows0 = torch.nonzero(g.bucket_rows[-1] == 0).flatten()
    assert rows0.numel() > 1000
    assert torch.equal(rows0, torch.arange(int(rows0[0]),
                                           int(rows0[0]) + rows0.numel()))


@pytest.mark.parametrize("d", [8, 50])
def test_scatter_twin_matches_per_bucket_plain(d):
    """The scatter twin equals the per-bucket plain result added by
    ``index_add_`` with padding rows dropped, with or without the real row
    count; the wrappers on CPU tensors run it and count no launch."""
    indptr, indices, weights = _heavy_csr(d)
    g = build_ell(indptr, indices, weights, row_capacity=(256, 256, 256))
    h = torch.from_numpy(np.random.default_rng(d).normal(
        size=(g.num_cols, d)).astype(np.float32))
    want = torch.zeros((g.num_rows + 1, d))
    for idx, w, rows in zip(g.bucket_idx, g.bucket_w, g.bucket_rows):
        want.index_add_(0, rows.long(), ell_spmm_plain(idx, w, h))
    before = (SPMM_MOD.LAUNCHES, SPMM_MOD.LAUNCHES_RESIDENT)
    for fn in (ell_spmm_scatter_plain, ell_spmm_scatter,
               ell_spmm_resident_scatter):
        for real in (g.bucket_real, (None,) * 3):
            out = torch.zeros((g.num_rows, d))
            for idx, w, rows, r in zip(g.bucket_idx, g.bucket_w,
                                       g.bucket_rows, real):
                assert fn(idx, w, rows, h, out, r) is out
            torch.testing.assert_close(out, want[:-1], rtol=0, atol=0)
    assert (SPMM_MOD.LAUNCHES, SPMM_MOD.LAUNCHES_RESIDENT) == before


def test_scatter_wrappers_validate():
    idx = torch.zeros((4, 2), dtype=torch.int32)
    w, h = torch.ones((4, 2)), torch.ones((3, 5))
    rows = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="rows must be int32"):
        ell_spmm_scatter(idx, w, rows.long(), h, torch.zeros((3, 5)))
    with pytest.raises(ValueError, match="must be \\(n, 5\\)"):
        ell_spmm_scatter(idx, w, rows, h, torch.zeros((3, 4)))
    with pytest.raises(ValueError, match="in h's dtype"):
        ell_spmm_resident_scatter(idx, w, rows, h,
                                  torch.zeros((3, 5), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="real_rows=5 outside"):
        ell_spmm_scatter(idx, w, rows, h, torch.zeros((3, 5)), 5)
    with pytest.raises(ValueError, match="no kernel for device"):
        ell_spmm_scatter(*(t.to("meta") for t in (idx, w, rows, h)),
                         torch.zeros((3, 5), device="meta"))


def _vjp_against_reference(tg, jg, h, ct, stream):
    def jfn(h_, ws):
        g = dataclasses.replace(jg, bucket_w=ws)
        return j_bucketed_spmm(g, h_, stream=stream is not False)

    j_out, jvjp = jax.vjp(jfn, jnp.asarray(h), jg.bucket_w)
    j_dh, j_dws = jvjp(jnp.asarray(ct))
    ws = [w.clone().requires_grad_() for w in tg.bucket_w]
    th = torch.from_numpy(h).requires_grad_()
    out = bucketed_spmm(dataclasses.replace(tg, bucket_w=tuple(ws)), th,
                        stream=stream)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **F32)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(j_dh), **F32)
    for w, jw in zip(ws, j_dws, strict=True):
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(jw), **F32)


@pytest.mark.parametrize("stream", [None, False], ids=["stream", "resident"])
def test_heavy_and_padding_rows_match_reference(stream):
    """Degree 130, 300 and 1000 rows split into up to 8 pieces, fixed
    capacities leave padding rows at every bucket's tail: forward, dh and
    d(bucket_w) against ``jax.vjp`` of the reference."""
    indptr, indices, weights = _heavy_csr(5)
    n = indptr.shape[0] - 1
    src = indices.astype(np.int64)
    dst = np.repeat(np.arange(n), np.diff(indptr))
    rng = np.random.default_rng(6)
    h = rng.normal(size=(n, 24)).astype(np.float32)
    ct = rng.normal(size=(n, 24)).astype(np.float32)
    tg = ell_from_coo(src, dst, weights, n, with_transpose=True)
    assert any(int(rows.shape[0]) > r for rows, r in
               zip(tg.bucket_rows, tg.bucket_real))   # padding rows exist
    _vjp_against_reference(tg, j_ell_from_coo(src, dst, weights, n), h, ct,
                           stream)


@pytest.mark.parametrize("stream", [None, False], ids=["stream", "resident"])
def test_padded_row0_pieces_match_reference(padded_subgraph, stream):
    """A padded subgraph whose row 0 holds ~1,170 all-zero K = 128 pieces
    (in A, and in Aᵀ as well): forward and vjp against the reference."""
    sg = padded_subgraph
    rng = np.random.default_rng(7)
    h = rng.normal(size=(sg.n_ext, 8)).astype(np.float32)
    ct = rng.normal(size=(sg.n_ext, 8)).astype(np.float32)
    tg = ell_from_coo(sg.edge_src, sg.edge_dst, sg.edge_w, sg.n_ext,
                      with_transpose=True)
    jg = j_ell_from_coo(sg.edge_src, sg.edge_dst, sg.edge_w, sg.n_ext)
    _vjp_against_reference(tg, jg, h, ct, stream)
