"""Port parity, models and core: the four GNN families, exact layer values
and the serving infer step, against the reference with its own parameters
loaded leaf for leaf (``params_from_reference``).

Tolerances: rtol = atol = 1e-5 in f32 (the same sums in another order).
Matmuls run in full f32 (TF32 off, as set below).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import graph as jgraph
from repro.core import exact as jexact
from repro.core.history import HistoricalState as JState
from repro.core.lmc import make_infer_step as j_make_infer_step
from repro.models import make_gnn as j_make_gnn
from repro.models.gnn import LayerAux as JAux
from repro.serve.gateway import StoreGateway as JGateway

from repro_torch import graph as tgraph
from repro_torch.convert import params_from_reference
from repro_torch.core import exact as texact
from repro_torch.core.history import HistoricalState
from repro_torch.core.lmc import commit_rows, make_infer_step
from repro_torch.models import make_gnn
from repro_torch.models.gnn import LayerAux
from repro_torch.serve.gateway import StoreGateway

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["gcn", "gcnii", "sage", "gin"]


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else x)


def _pair(arch, g, hidden=16, layers=2, seed=0):
    """(reference gnn, its params, port gnn, converted params)."""
    jg = j_make_gnn(arch, g.feature_dim, hidden, g.num_classes, layers)
    jp = jg.init_params(jax.random.key(seed))
    tg = make_gnn(arch, g.feature_dim, hidden, g.num_classes, layers)
    tp = params_from_reference(tg, jax.tree.map(np.asarray, jp))
    return jg, jp, tg, tp


@pytest.fixture(scope="module")
def graphs(small_graph):
    return small_graph, tgraph.make_sbm_dataset("ppi-cpu", seed=3)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_forward_matches_reference(graphs, arch):
    jgr, tgr = graphs
    jg, jp, tg, tp = _pair(arch, jgr)
    jd, td = jexact.from_graph(jgr), texact.from_graph(tgr, device="cpu")
    want = jg.full_forward(jp, jd.x, jd.edges, jd.self_w)
    got = tg.full_forward(tp, td.x, td.edges, td.self_w)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(tg(td.x, td.edges, td.self_w)),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_apply_matches_reference(graphs, arch):
    """Layer 1 on a random input (gcnii also reads h0)."""
    jgr, tgr = graphs
    jg, jp, tg, tp = _pair(arch, jgr)
    jd, td = jexact.from_graph(jgr), texact.from_graph(tgr, device="cpu")
    rng = np.random.default_rng(1)
    h = rng.normal(size=(jgr.num_nodes, 16)).astype(np.float32)
    h0 = rng.normal(size=(jgr.num_nodes, 16)).astype(np.float32)
    want = jg.layer_apply(jg.layer_params(jp, 1), 1, jnp.asarray(h),
                          JAux(jd.edges, jd.x, jnp.asarray(h0), jd.self_w))
    got = tg.layer_apply(tg.layer_params(tp, 1), 1, torch.from_numpy(h),
                         LayerAux(td.edges, td.x, torch.from_numpy(h0),
                                  td.self_w))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_params_from_reference_rejects_mismatch(small_graph):
    jg = j_make_gnn("gcn", small_graph.feature_dim, 16,
                    small_graph.num_classes, 2)
    tree = jax.tree.map(np.asarray, jg.init_params(jax.random.key(0)))
    tg = make_gnn("gcn", small_graph.feature_dim, 16,
                  small_graph.num_classes, 2)
    before = [p.clone() for p in tg.parameters()]
    missing = {**tree, "head": {"w": tree["head"]["w"]}}
    with pytest.raises(ValueError, match="missing"):
        params_from_reference(tg, missing)
    extra = {**tree, "head": {**tree["head"], "scale": np.ones(3)}}
    with pytest.raises(ValueError, match="left over"):
        params_from_reference(tg, extra)
    bad = {**tree, "head": {**tree["head"], "b": np.zeros(7, np.float32)}}
    with pytest.raises(ValueError, match="shape"):
        params_from_reference(tg, bad)
    # nothing was copied by a rejected conversion
    assert all(torch.equal(a, b) for a, b in zip(before, tg.parameters()))


@pytest.mark.parametrize("arch", ["gcn", "gcnii"])
def test_exact_values_loss_accuracy_match_reference(graphs, arch):
    jgr, tgr = graphs
    jg, jp, tg, tp = _pair(arch, jgr, layers=3)
    jd, td = jexact.from_graph(jgr), texact.from_graph(tgr, device="cpu")
    jhs, jvs = jexact.exact_layer_values(jg, jp, jd)
    ths, tvs = texact.exact_layer_values(tg, tp, td)
    for a, b in zip(ths, jhs, strict=True):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)
    # V^l = ∇_{H^l} L carries the 1/|V_L| factor: compare relative to scale
    for a, b in zip(tvs, jvs, strict=True):
        scale = float(np.abs(np.asarray(b)).max())
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5 * scale)
    np.testing.assert_allclose(float(texact.full_loss(tg, tp, td).detach()),
                               float(jexact.full_loss(jg, jp, jd)), **TOL)
    mask = jgr.val_mask.astype(np.float32)
    np.testing.assert_allclose(
        float(texact.accuracy(tg, tp, td, torch.from_numpy(mask))),
        float(jexact.accuracy(jg, jp, jd, jnp.asarray(mask))), **TOL)


def _tiny_graph(lib):
    """A 300-node graph (mean degree ~8) built identically by both packages;
    small enough for the reference's interpret-mode kernels."""
    r = np.random.default_rng(11)
    n, e = 300, 1200
    src, dst = r.integers(0, n, e), r.integers(0, n, e)
    x = r.normal(size=(n, 12)).astype(np.float32)
    y = r.integers(0, 5, n).astype(np.int32)
    masks = [r.random(n) < 0.5 for _ in range(3)]
    return lib.Graph.from_edges(n, src, dst, x, y, *masks, name="tiny")


@pytest.mark.parametrize("refresh", [True, False])
@pytest.mark.parametrize("compensation,fwd_mode",
                         [("store", "historical"), ("store", "lmc"),
                          ("ti", "lmc")])
@pytest.mark.parametrize("backend", ["segment", "ell"])
def test_infer_step_matches_reference(backend, compensation, fwd_mode,
                                      refresh):
    """Identical gateway batches through both infer steps: same logits, and
    the port's deferred store writes reproduce the reference's new store."""
    jgr, tgr = _tiny_graph(jgraph), _tiny_graph(tgraph)
    jg, jp, tg, tp = _pair("gcn", jgr, hidden=16, layers=3)
    jd, td = jexact.from_graph(jgr), texact.from_graph(tgr, device="cpu")
    rng = np.random.default_rng(2)
    h0 = rng.normal(size=(3, jgr.num_nodes, 16)).astype(np.float32)
    v0 = np.zeros((2, jgr.num_nodes, 16), np.float32)
    targets = np.sort(rng.choice(jgr.num_nodes, 6, replace=False))
    kind = "ell" if backend == "ell" else "segment"
    _, jb = JGateway(jgr, agg_backend=kind).build(targets)
    _, tb = StoreGateway(tgr, agg_backend=kind).build(targets)
    for a, b in zip(jb, tb, strict=True):
        if a is not None and not hasattr(a, "bucket_idx"):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())

    kw = dict(backend=backend, fwd_mode=fwd_mode, compensation=compensation,
              refresh=refresh)
    j_logits, j_store = j_make_infer_step(jg, jgr.num_nodes, **kw)(
        jp, JState(jnp.asarray(h0), jnp.asarray(v0)), jax.device_put(jb),
        jd.x, jd.self_w)
    store = HistoricalState(torch.from_numpy(h0.copy()),
                            torch.from_numpy(v0.copy()))
    t_logits, rows = make_infer_step(tg, tgr.num_nodes, **kw)(
        tp, store, tb, td.x, td.self_w)
    np.testing.assert_allclose(_np(t_logits), np.asarray(j_logits), **TOL)
    # the step itself never writes the store
    assert torch.equal(store.h, torch.from_numpy(h0))
    if refresh:
        commit_rows(store, tb, rows, tgr.num_nodes)
    else:
        assert rows is None
    np.testing.assert_allclose(_np(store.h), np.asarray(j_store.h), **TOL)
