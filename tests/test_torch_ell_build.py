"""The batch's ELL built on its device (``kernels/ell_build.py``) against the
numpy builder ``ell_from_coo``, which stays the oracle: the card's algorithm
with the plain twins of the CUDA kernels (``ELLPlan.build_torch`` on CPU
tensors) and the CPU's build, and every bucket array, every real row count
and the transpose's must be equal (``torch.equal``: same integers, same
float32 values, same shapes and dtypes). The host half (``plan_ell``) raises
a capacity overflow before anything is built. Imports no JAX."""
import numpy as np
import pytest
import torch

from repro_torch.core import Batch, host_batch
from repro_torch.graph import ClusterSampler
from repro_torch.kernels import (ELLCapacityError, ELLGraph, ELLPlan,
                                 ell_from_coo, plan_ell)
from repro_torch.kernels import ell_build
from repro_torch import graph as tgraph

from _torch_port import PARTS, tiny_graph, tiny_parts


def _random(seed: int):
    """Random COO over 60 rows, a third of them with no in-edge."""
    r = np.random.default_rng(seed)
    n, e = 60, 700
    rows = r.choice(np.arange(n)[r.random(n) < 0.66], e)
    return r.integers(0, n, e), rows, r.random(e), n


def _exact(_seed: int):
    """Rows of degree exactly 8, 32, 128 and 129 (and 0 and 1): each
    piece at a bucket's edge, and 129 split into 128 + 1."""
    degs = [8, 32, 128, 129, 0, 1, 129, 8]
    dst = np.repeat(np.arange(len(degs)), degs)
    r = np.random.default_rng(1)
    return r.integers(0, len(degs), dst.shape[0]), dst, \
        r.random(dst.shape[0]), len(degs)


def _padded(seed: int):
    """A sampled subgraph as ``build_subgraph`` pads it: row 0 carries the
    padded zero-weight edges."""
    g = tiny_graph(tgraph)
    sg = ClusterSampler(g, PARTS, 2, parts=tiny_parts(), seed=seed).sample()
    pad = sg.edge_w.shape[0] - sg.n_edges_real
    assert pad > 128 and not sg.edge_w[sg.n_edges_real:].any()
    assert (sg.edge_dst[sg.n_edges_real:] == 0).all()
    return sg.edge_src, sg.edge_dst, sg.edge_w, sg.n_ext


def _edgeless(_seed: int):
    return np.zeros(0, np.int32), np.zeros(0, np.int32), \
        np.zeros(0, np.float32), 17


def _heavy_row(seed: int):
    """One row of 3 · 128 + 77 edges (four pieces: three full, one in the
    widest bucket) among degree-0 rows, and one source heavy in Aᵀ."""
    r = np.random.default_rng(seed)
    n = 40
    dst = np.full(3 * 128 + 77, 5)
    src = np.where(r.random(dst.shape[0]) < 0.5, 11, r.integers(0, n,
                                                                dst.shape[0]))
    return src, dst, r.random(dst.shape[0]), n


def _duplicates(seed: int):
    """The same (src, dst) pair many times with distinct weights: the
    order inside a row is the stable sorts' and no other."""
    r = np.random.default_rng(seed)
    n, e = 12, 400
    return r.integers(0, 3, e), r.integers(0, 3, e), \
        (np.arange(e) + 1) / e, n


def _wide_random(seed: int):
    """200 rows whose degrees span every bucket, and rows past the widest
    (skewed, as a power-law graph's hubs are)."""
    r = np.random.default_rng(seed)
    n = 200
    deg = np.minimum(r.zipf(1.6, n), 600)
    dst = np.repeat(np.arange(n), deg)
    return r.integers(0, n, dst.shape[0]), dst, r.random(dst.shape[0]), n


def _last_row_only(_seed: int):
    """Every edge into the last row, every other row degree 0."""
    n = 33
    dst = np.full(50, n - 1)
    return np.arange(50) % n, dst, np.linspace(0.5, 1.5, 50), n


CASES = {"random_deg0": _random, "exact_degrees": _exact,
         "padded_row0": _padded, "edgeless": _edgeless,
         "heavy_row": _heavy_row, "duplicate_edges": _duplicates,
         "wide_random": _wide_random, "last_row_only": _last_row_only}


def _assert_equal(got: ELLGraph, want: ELLGraph) -> None:
    assert got.bucket_real == want.bucket_real
    assert (got.num_rows, got.num_cols) == (want.num_rows, want.num_cols)
    for a, b in zip(got.bucket_idx + got.bucket_w + got.bucket_rows,
                    want.bucket_idx + want.bucket_w + want.bucket_rows,
                    strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert (got.transpose is None) == (want.transpose is None)
    if want.transpose is not None:
        _assert_equal(got.transpose, want.transpose)


@pytest.mark.parametrize("path", ["build_torch", "build"])
@pytest.mark.parametrize("with_transpose", [True, False],
                         ids=["transpose", "forward"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_device_build_equals_numpy_builder(case, with_transpose, path):
    """``build_torch`` runs the card's algorithm with the kernels' plain
    twins; ``build`` on CPU tensors the numpy builder at the plan's
    capacities (the fixed ones, as ``ell_from_coo``'s default)."""
    src, dst, w, n = CASES[case](3)
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    w = np.asarray(w, np.float32)
    want = ell_from_coo(src, dst, w, n, with_transpose=with_transpose)
    plan = plan_ell(src, dst, n, with_transpose=with_transpose)
    assert plan.real == want.bucket_real
    launches = ell_build.LAUNCHES
    got = getattr(plan, path)(*(torch.from_numpy(a) for a in (src, dst, w)))
    assert ell_build.LAUNCHES == launches   # the twins are no launch
    _assert_equal(got, want)


def test_device_build_with_four_buckets():
    """Any ascending bucket widths up to four, the kernel's slots."""
    src, dst, w, n = _exact(0)
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    w = np.asarray(w, np.float32)
    ks = (4, 16, 64, 256)
    want = ell_from_coo(src, dst, w, n, buckets=ks, with_transpose=True)
    plan = plan_ell(src, dst, n, buckets=ks, with_transpose=True)
    for build in (plan.build_torch, plan.build):
        _assert_equal(build(*(torch.from_numpy(a) for a in (src, dst, w))),
                      want)


def test_host_batch_carries_a_plan_and_to_builds_it():
    """``host_batch`` keeps no bucket array (its tensors, and so its bytes
    and its pinning, are the COO's and the rest); ``to`` builds the graph
    ``ell_from_coo`` gives, and a built batch builds nothing again."""
    sg = ClusterSampler(tiny_graph(tgraph), PARTS, 2, parts=tiny_parts(),
                        seed=0).sample()
    hb = host_batch(sg, backend="ell")
    assert isinstance(hb.ell, ELLPlan)
    assert len(hb.tensors()) == len(Batch._fields) - 2   # no ell, ti_scale
    assert hb.copy_to("cpu").ell is hb.ell
    built = hb.to("cpu")
    _assert_equal(built.ell, ell_from_coo(sg.edge_src, sg.edge_dst,
                                          sg.edge_w, sg.n_ext,
                                          with_transpose=True))
    assert built.bucketed() is built
    assert len(built.tensors()) == len(hb.tensors()) + 2 * 3 * 3


def test_capacity_overflow_raises_on_the_host(monkeypatch):
    """A bucket past its capacity raises ELLCapacityError from
    ``host_batch``, before any tensor is built."""
    sg = ClusterSampler(tiny_graph(tgraph), PARTS, 2, parts=tiny_parts(),
                        seed=0).sample()
    monkeypatch.setattr(ell_build, "fixed_row_capacity",
                        lambda *a, **k: (8, 8, 8))
    with pytest.raises(ELLCapacityError, match="exceed capacity"):
        host_batch(sg, backend="ell")


def test_plan_and_scatter_refuse_bad_inputs():
    with pytest.raises(ValueError, match="outside"):
        plan_ell(np.array([0, 1]), np.array([0, 5]), 3)
    with pytest.raises(ValueError, match="ascending"):
        plan_ell(np.array([0]), np.array([0]), 3, buckets=(32, 8))
    key = torch.zeros(3, dtype=torch.int32)
    lay = ell_build.Layout.of((8,), (1,), (1,))
    rowptr, counts = torch.zeros(2, dtype=torch.int32), \
        torch.zeros(1, dtype=torch.int32)
    ell_build.ell_rows(key, rowptr, counts, lay)   # row 0: three edges
    assert rowptr.tolist() == [0, 3] and counts.tolist() == [1]
    ok = dict(key=key, col=key + 1, w=torch.ones(3), rowptr=rowptr,
              counts=counts, incl=counts.cumsum(0, dtype=torch.int32),
              idx=torch.zeros(8, dtype=torch.int32), wout=torch.zeros(8),
              rid=torch.zeros(1, dtype=torch.int32), layout=lay)
    with pytest.raises(TypeError, match="key"):
        ell_build.ell_scatter(**{**ok, "key": key.long()})
    with pytest.raises(TypeError, match="wout"):
        ell_build.ell_scatter(**{**ok, "wout": torch.zeros(8).double()})
    with pytest.raises(ValueError, match="do not fit"):
        ell_build.ell_scatter(**{**ok, "incl": torch.zeros(
            2, dtype=torch.int32)})
    with pytest.raises(ValueError, match="do not fit"):
        ell_build.ell_scatter(**{**ok, "rid": torch.zeros(
            0, dtype=torch.int32)})
    with pytest.raises(ValueError, match="contiguous"):
        ell_build.ell_scatter(**{**ok, "idx": torch.zeros(
            16, dtype=torch.int32)[::2]})
    with pytest.raises(ValueError, match="1 to 4"):
        ell_build.ell_rows(key, rowptr, counts,
                           ell_build.Layout.of((1,) * 5, (1,) * 5, (1,) * 5))
    with pytest.raises(ValueError, match="counts"):
        ell_build.ell_rows(key, rowptr, torch.zeros(2, dtype=torch.int32),
                           lay)
    ell_build.ell_scatter(**ok)   # three edges of row 0 in bucket 0
    assert ok["idx"].tolist() == [1] * 3 + [0] * 5
    assert ok["wout"].tolist() == [1.0] * 3 + [0.0] * 5
    assert ok["rid"].tolist() == [0]


def test_scatter_skips_rows_past_the_plan():
    """A plan that does not match its COO (a bucket with fewer rows than
    the edges need) writes nothing outside the bucket's capacity."""
    dst = np.repeat(np.arange(4), 3).astype(np.int32)   # four rows of 3
    src, w = np.zeros_like(dst), np.ones(dst.shape[0], np.float32)
    plan = plan_ell(src, dst, 4, buckets=(8,))
    small = ELLPlan(4, (8,), (2,), (2,))   # room and count for two rows
    got = small.build_torch(*(torch.from_numpy(a) for a in (src, dst, w)))
    want = plan.build_torch(*(torch.from_numpy(a) for a in (src, dst, w)))
    assert torch.equal(got.bucket_idx[0], want.bucket_idx[0][:2])
    assert got.bucket_rows[0].tolist() == [0, 1]
