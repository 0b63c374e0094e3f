"""Port parity, serving: the port's GNNServer on the CPU against the
reference's full-graph forward, and the serving fault paths that depend on
the port's deferred store writes.

Tolerance: exact-rung logits within atol 1e-4 of the reference's
``full_forward`` (the bar of the reference's own serving test).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.exact import from_graph as j_from_graph
from repro.models import make_gnn as j_make_gnn
from repro.serve.gateway import StoreGateway as JGateway

from repro_torch import graph as tgraph
from repro_torch.convert import params_from_reference
from repro_torch.core import HistoricalState, from_graph
from repro_torch.models import make_gnn
from repro_torch.serve import (CircuitBreaker, GNNServer, ServeConfig,
                               StoreGateway, StoreIntegrity, warm_store)
from repro_torch.train.health import FaultPlan

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ATOL = 1e-4


@pytest.fixture(scope="module")
def setup(small_graph):
    """Reference logits plus the port's graph, gnn, params, data and an
    exact store built on the CPU from the reference's parameters."""
    jg = j_make_gnn("gcn", small_graph.feature_dim, 32,
                    small_graph.num_classes, 3)
    jp = jg.init_params(jax.random.key(0))
    jd = j_from_graph(small_graph)
    full = np.asarray(jg.full_forward(jp, jd.x, jd.edges, jd.self_w))
    g = tgraph.make_sbm_dataset("ppi-cpu", seed=3)
    gnn = make_gnn("gcn", g.feature_dim, 32, g.num_classes, 3)
    params = params_from_reference(gnn, jax.tree.map(np.asarray, jp))
    data = from_graph(g, device="cpu")
    store = warm_store(gnn, params, data, device="cpu")
    return full, g, gnn, params, data, store


def _server(setup, **cfg_kw):
    """A CPU server on a private copy of the exact store (servers write their
    store in place)."""
    _, g, gnn, params, data, store = setup
    plan = cfg_kw.pop("fault_plan", None)
    cfg = ServeConfig(**{"default_deadline_s": 30.0, **cfg_kw})
    own = HistoricalState(store.h.clone())
    return GNNServer(gnn, g, params, store=own, config=cfg, fault_plan=plan,
                     data=data, device="cpu")


@pytest.mark.parametrize("kind", ["segment", "ell"])
def test_gateway_batches_match_reference(small_graph, setup, kind):
    g = setup[1]
    targets = np.array([3, 77, 500, 1999, 42, 1024, 7, 8, 9])
    _, jb = JGateway(small_graph, agg_backend=kind).build(targets)
    _, tb = StoreGateway(g, agg_backend=kind).build(targets)
    tb = tb.to("cpu")   # the host batch's ELL plan, built on the CPU
    for name, a, b in zip(jb._fields, jb, tb, strict=True):
        if name == "ell":
            assert (a is None) == (b is None)
            if a is not None:
                assert b.transpose is None   # forward only: no Aᵀ bucketing
                for x, y in zip(a.bucket_idx + a.bucket_w + a.bucket_rows,
                                b.bucket_idx + b.bucket_w + b.bucket_rows,
                                strict=True):
                    np.testing.assert_array_equal(np.asarray(x), y.numpy())
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=name)


@pytest.mark.parametrize("backend", ["segment", "ell"])
def test_exact_rung_matches_reference_full_forward(setup, backend):
    full = setup[0]
    s = _server(setup, backend=backend, return_logits=True)
    try:
        for nodes in (np.array([0, 17, 999, 2047, 512]), np.arange(100, 130)):
            r = s.infer(nodes)
            assert r.status == "ok" and r.mode == "exact"
            np.testing.assert_allclose(r.logits, full[nodes], rtol=0,
                                       atol=ATOL)
            np.testing.assert_array_equal(r.classes, full[nodes].argmax(-1))
        assert s._guard.staleness[:, nodes].max() == 0
    finally:
        assert s.drain(timeout=60.0)


def test_discarded_exact_batch_writes_nothing(setup):
    """Poison drill with crc checks and repair off: the poisoned rows reach
    the exact forward, its output is non-finite, the batch is discarded and
    re-served store-free — and afterwards the only non-finite store rows are
    exactly the injected ones (the discarded batch committed nothing)."""
    plan = FaultPlan(serve_poison_at=(2,))
    s = _server(setup, verify_rows=False, repair=False, fault_plan=plan)
    try:
        nodes = np.array([4, 5, 6])
        assert s.infer(nodes).status == "ok"             # seq 1
        r = s.infer(nodes)                               # seq 2: poisoned
        assert r.status == "degraded" and r.degraded_reason == "nan-circuit"
        assert np.isfinite(np.asarray(r.classes)).all()
        ev = [e for e in s.events if e["kind"] == "poisoned"]
        assert len(ev) == 1
        injected = {int(v) for v in
                    ev[0]["detail"].removeprefix("rows ").strip("[]").split(",")}
        h = s.store.h.numpy()
        bad_rows = set(np.flatnonzero(~np.isfinite(h).all(axis=(0, 2))))
        assert bad_rows == injected
        assert not set(nodes) & bad_rows
    finally:
        s.close(drain=False)


def test_poisoned_rows_detected_and_repaired(setup):
    plan = FaultPlan(serve_poison_at=(2,))
    s = _server(setup, fault_plan=plan)
    try:
        nodes = np.array([7, 8, 9])
        assert s.infer(nodes).status == "ok"
        r = s.infer(nodes)                               # seq 2: poisoned
        assert r.status == "degraded" and "store-corrupt" in r.degraded_reason
        assert np.isfinite(np.asarray(r.classes)).all()
        assert s.infer(nodes).status == "ok"             # healed
        assert any(e["kind"] == "repair" for e in s.events)
        assert torch.isfinite(s.store.h).all()
    finally:
        s.close(drain=False)


def test_forced_ti_worker_crash_and_drain(setup):
    plan = FaultPlan(serve_crash_at=(1,))
    s = _server(setup, backend="ell", fault_plan=plan)
    h_before = s.store.h.clone()
    r = s.infer(np.array([12, 13]))
    assert r.status == "ok" and r.attempts == 2
    assert s.stats()["worker_restarts"] == 1
    s.config.force_mode = "ti"
    r = s.infer(np.array([30, 31, 32]))
    assert r.status == "degraded" and r.mode == "ti"
    futs = [s.submit(np.array([i, i + 100])) for i in range(6)]
    assert s.drain(timeout=60.0)
    assert all(f.result(timeout=1.0).status == "degraded" for f in futs)
    assert s.stats()["pending"] == 0
    # the ti rung never writes the store; the exact batch refreshed its rows
    # with values equal to the exact ones already there
    torch.testing.assert_close(s.store.h, h_before, rtol=1e-5, atol=1e-5)


def test_stale_halo_rows_degrade_then_heal(setup):
    """Rows aged past the ρ-budget (notify_update, the trainer's hook)
    degrade the batch to ti and are repaired; the next serve is exact."""
    s = _server(setup, rho_budget=2)
    try:
        nodes = np.array([20, 21, 22])
        assert s.infer(nodes).status == "ok"
        s.notify_update(5)
        r = s.infer(nodes)
        assert r.status == "degraded"
        assert r.degraded_reason == "staleness 5 > rho budget 2"
        r = s.infer(nodes)    # the worker repairs before it takes this one
        assert r.status == "ok" and r.mode == "exact"
        assert any(e["kind"] == "repair" for e in s.events)
    finally:
        s.close(drain=False)


def test_policy_pieces_and_validation(setup):
    br = CircuitBreaker(heal_after=2, cooldown=2)
    br.record_failure(5)
    assert not br.allow_exact(7) and br.allow_exact(8)
    br.record_success()
    br.record_success()
    assert br.state == "closed"
    rows = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    ledger = StoreIntegrity(2, 64)
    ledger.record(np.array([10, 20, 30]), rows)
    bad = rows.copy()
    bad[1, 2, 0] += 1.0
    np.testing.assert_array_equal(ledger.verify(np.array([10, 20, 30]), bad),
                                  [30])
    with pytest.raises(ValueError):
        ServeConfig(backend="coo").validate()
    s = _server(setup)
    try:
        assert s.infer(np.array([], dtype=np.int64)).status == "error"
        assert s.infer(np.arange(129)).status == "too-large"
    finally:
        s.close(drain=False)


def test_resident_kernels_serve_the_same_logits(setup):
    """``ServeConfig.stream=False`` serves through the resident-source
    kernels (here their plain twins): the exact rung's logits equal the
    streaming setting's, and both the reference's full forward."""
    full = setup[0]
    nodes = np.array([0, 17, 999, 2047, 512, 3, 3])
    logits = {}
    for stream in (True, False):
        s = _server(setup, backend="ell", stream=stream, return_logits=True)
        try:
            r = s.infer(nodes)
            assert r.status == "ok" and r.mode == "exact"
            logits[stream] = r.logits
        finally:
            assert s.drain(timeout=60.0)
    np.testing.assert_array_equal(logits[False], logits[True])
    np.testing.assert_allclose(logits[False], full[nodes], rtol=0, atol=ATOL)
