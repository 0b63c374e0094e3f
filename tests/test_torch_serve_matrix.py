"""Port parity, the serving fault matrix: each reference serving test of
tests/test_serve.py that tests/test_torch_serve.py has no counterpart for,
run on the reference's ``GNNServer`` and the port's (on the CPU) with the
same requests, configuration and fault plan.

Each scenario returns a record of what a client and an operator see: the
responses' statuses, modes, ``degraded_reason``s and attempts, the server's
event kinds and its ``stats()`` counters. The two records must be equal,
and each must pass the reference test's own assertions. Where an answer is
exact, the port's logits must lie within 1e-4 of the reference's
``full_forward`` (the reference test's bar), and every answer with logits
(exact, degraded, or exact over rows a repair rewrote) within 1e-4 of the
reference server's answer to the same request. Where timing makes an outcome a
range (a burst shed by a full queue, a close racing the worker), both
servers must fall in the reference test's range.

Graph and model: ``ppi-cpu`` (seed 3), GCN 3×32 with the reference's
parameters (``jax.random.key(0)``), an exact store on each side.
"""
import time

import jax
import numpy as np
import pytest
import torch

from repro.core import RHO_BUDGET_DEFAULT
from repro.core.exact import from_graph as j_from_graph
from repro.models import make_gnn as j_make_gnn
from repro.serve import GNNServer as JServer
from repro.serve import ServeConfig as JConfig
from repro.serve import warm_store as j_warm_store
from repro.train.health import FaultPlan as JPlan

from repro_torch import graph as tgraph
from repro_torch.convert import params_from_reference
from repro_torch.core import HistoricalState, from_graph
from repro_torch.models import make_gnn
from repro_torch.serve import GNNServer, ServeConfig, warm_store
from repro_torch.train.health import FaultPlan

torch.backends.cuda.matmul.allow_tf32 = False
ATOL = 1e-4


@pytest.fixture(scope="module")
def sides(small_graph):
    """Per package: a factory of servers over one exact store; and the
    reference's full-graph logits."""
    jg = j_make_gnn("gcn", small_graph.feature_dim, 32,
                    small_graph.num_classes, 3)
    jp = jg.init_params(jax.random.key(0))
    jd = j_from_graph(small_graph)
    jstore = j_warm_store(jg, jp, jd)
    full = np.asarray(jg.full_forward(jp, jd.x, jd.edges, jd.self_w))
    g = tgraph.make_sbm_dataset("ppi-cpu", seed=3)
    gnn = make_gnn("gcn", g.feature_dim, 32, g.num_classes, 3)
    params = params_from_reference(gnn, jax.tree.map(np.asarray, jp))
    data = from_graph(g, device="cpu")
    store = warm_store(gnn, params, data, device="cpu")

    def ref(plan=None, **cfg):
        return JServer(jg, small_graph, jp, store=jstore,
                       config=JConfig(**cfg), data=jd,
                       fault_plan=None if plan is None else JPlan(**plan))

    def port(plan=None, **cfg):   # a private store: the port writes in place
        return GNNServer(gnn, g, params, store=HistoricalState(store.h.clone()),
                         config=ServeConfig(**cfg), data=data, device="cpu",
                         fault_plan=None if plan is None else FaultPlan(**plan))

    return {"ref": ref, "port": port}, full


def _record(responses, s, *, stats=True) -> dict:
    return {"status": [r.status for r in responses],
            "mode": [r.mode for r in responses],
            "reason": [r.degraded_reason for r in responses],
            "attempts": [r.attempts for r in responses],
            "events": [e["kind"] for e in s.events],
            "stats": s.stats() if stats else None}


def _both(sides, scenario, *, plan=None, close=True, **cfg):
    """``scenario(server)`` on a reference and a port server of one
    configuration; returns {"ref": record, "port": record} after checking
    every exact answer against the reference's full forward."""
    make, full = sides
    cfg = {"default_deadline_s": 30.0, "return_logits": True, **cfg}
    out, logits = {}, {}
    for side in ("ref", "port"):
        s = make[side](plan, **cfg)
        try:
            responses, nodes, rec = scenario(s)
        finally:
            if close:
                s.close(drain=False, timeout=60.0)
        for r, q in zip(responses, nodes, strict=True):
            if q is not None and r.status == "ok" and r.mode == "exact":
                np.testing.assert_allclose(r.logits, full[q], rtol=0,
                                           atol=ATOL, err_msg=side)
        out[side] = rec
        logits[side] = [r.logits for r in responses]
    # every answer either rung gave (exact, ti, or exact over repaired
    # rows) is the reference's answer
    for a, b in zip(logits["port"], logits["ref"], strict=True):
        if a is not None and b is not None:
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    return out


def test_submit_rejects_malformed_and_oversize(small_graph, sides):
    n = small_graph.num_nodes

    def scenario(s):
        reqs = [np.array([], dtype=np.int64), np.array([-1]), np.array([n]),
                np.arange(129)]
        rs = [s.infer(q) for q in reqs]
        with pytest.raises(Exception):
            rs[3].raise_for_status()
        return rs, reqs, _record(rs, s)

    rec = _both(sides, scenario)
    assert rec["port"] == rec["ref"]
    assert rec["port"]["status"] == ["error"] * 3 + ["too-large"]


def test_duplicate_targets_align(sides):
    def scenario(s):
        q = np.array([5, 5, 9])
        r = s.infer(q)
        assert r.status == "ok" and r.classes.shape == (3,)
        assert r.classes[0] == r.classes[1]
        return [r], [q], _record([r], s)

    rec = _both(sides, scenario)
    assert rec["port"] == rec["ref"]


def test_exact_serve_refreshes_staleness(sides):
    def scenario(s):
        s.notify_update(3)             # the trainer moved params 3 steps
        q = np.array([1, 2, 3])
        r = s.infer(q)
        assert r.status == "ok"
        assert s._guard.staleness[:, q].max() == 0     # refreshed
        assert s._guard.staleness[:, 2000].max() == 3  # untouched rows age
        return [r], [q], {**_record([r], s),
                          "staleness": s._guard.staleness.copy()}

    rec = _both(sides, scenario)
    assert np.array_equal(rec["port"].pop("staleness"),
                          rec["ref"].pop("staleness"))
    assert rec["port"] == rec["ref"]


def test_staleness_degrades_then_repair_heals(sides):
    """Every row over the shared ρ budget: the batch degrades to ti and its
    halo rows are repaired, so the same request is then exact again."""
    def scenario(s):
        s.notify_update(RHO_BUDGET_DEFAULT + 1)
        q = np.array([10, 11])
        r = s.infer(q)
        assert r.status == "degraded" and r.mode == "ti"
        assert "staleness" in r.degraded_reason
        r2 = s.infer(q)    # the worker repairs before it takes this one
        assert r2.status == "ok" and r2.mode == "exact"
        assert any(e["kind"] == "repair" for e in s.events)
        return [r, r2], [None, None], _record([r, r2], s)

    # the exact answer after the repair reads repaired (ti-grade) rows, so
    # it is held to the reference's answer, not to the full forward (None)
    rec = _both(sides, scenario)
    assert rec["port"] == rec["ref"]
    assert rec["port"]["stats"]["repaired_rows"] > 0


def test_drain_completes_inflight(sides):
    def scenario(s):
        qs = [np.array([i, i + 100]) for i in range(10)]
        futs = [s.submit(q) for q in qs]
        assert s.drain(timeout=120.0)
        rs = [f.result(timeout=1.0) for f in futs]   # already resolved
        assert s.stats()["pending"] == 0
        # how requests coalesce into batches depends on timing
        return rs, qs, _record(rs, s, stats=False)

    rec = _both(sides, scenario, close=False)
    assert rec["port"] == rec["ref"]
    assert rec["port"]["status"] == ["ok"] * 10


def test_close_without_drain_resolves_everything(sides):
    def scenario(s):
        qs = [np.array([i]) for i in range(20)]
        futs = [s.submit(q) for q in qs]
        assert s.close(drain=False, timeout=120.0)
        rs = [f.result(timeout=1.0) for f in futs]
        assert set(r.status for r in rs) <= {"ok", "closed"}
        assert s.stats()["pending"] == 0
        late = s.submit(np.array([0])).result(timeout=1.0)
        assert late.status == "closed"
        return rs, qs, {"late": late.status,
                        "statuses": set(r.status for r in rs)}

    rec = _both(sides, scenario, close=False)
    for side in ("ref", "port"):
        assert rec[side]["statuses"] <= {"ok", "closed"}
        assert rec[side]["late"] == "closed"


def test_breaker_trips_on_nan_and_heals(sides):
    """verify_rows off: poisoned rows reach the exact forward, the NaN
    output trips the breaker, repair and one clean probe close it."""
    def scenario(s):
        q = np.array([4, 5, 6])
        rs = [s.infer(q)]                               # seq 1
        rs.append(s.infer(q))                           # seq 2: poisoned
        assert rs[1].status == "degraded"
        assert rs[1].degraded_reason == "nan-circuit"
        assert np.isfinite(np.asarray(rs[1].classes)).all()
        assert s.stats()["breaker"] == "open"
        rs.append(s.infer(q))                           # seq 3: cooling
        assert rs[2].degraded_reason == "nan-circuit-open"
        rs.append(s.infer(q))                           # seq 4: probe heals
        assert rs[3].status == "ok" and s.stats()["breaker"] == "closed"
        kinds = [e["kind"] for e in s.events]
        assert {"breaker-open", "breaker-closed", "repair"} <= set(kinds)
        # seq 4 reads the repaired (ti-grade) rows: held to the reference's
        # answer, not to the full forward; seq 1 read an exact store
        return rs, [q, None, None, None], _record(rs, s)

    rec = _both(sides, scenario, plan=dict(serve_poison_at=(2,)),
                verify_rows=False, breaker_cooldown=1, breaker_heal_after=1)
    assert rec["port"] == rec["ref"]


def test_matrix_serve_hung_batch(sides):
    """A stalled batch becomes a typed timeout, never a hang; the next
    request is served normally."""
    def scenario(s):
        qs = [np.array([1]), np.array([2]), np.array([3])]
        rs = [s.infer(qs[0]), s.infer(qs[1], deadline_s=0.3),  # seq 2 stalls
              s.infer(qs[2])]
        assert [r.status for r in rs] == ["ok", "timeout", "ok"]
        st = s.stats()
        assert st["pending"] == 0 and st["breaker"] == "closed"
        return rs, qs, _record(rs, s)

    rec = _both(sides, scenario,
                plan=dict(serve_slow_at=(2,), serve_slow_s=0.6))
    assert rec["port"] == rec["ref"]
    assert "slow-batch" in rec["port"]["events"]


def test_matrix_serve_worker_crash(sides):
    """A crash retries in place within the attempt budget and still
    answers; it shows in the counters, not to the caller."""
    def scenario(s):
        qs = [np.array([12, 13]), np.array([14])]
        rs = [s.infer(q) for q in qs]
        assert rs[0].status == "ok" and rs[0].attempts == 2
        assert rs[1].status == "ok"
        return rs, qs, _record(rs, s)

    rec = _both(sides, scenario, plan=dict(serve_crash_at=(1,)))
    assert rec["port"] == rec["ref"]
    assert rec["port"]["stats"]["worker_restarts"] == 1


def test_matrix_serve_worker_crash_budget_exhausted(sides):
    """Crashes past the retry budget end in a typed error, and the worker
    survives to serve the next request."""
    def scenario(s):
        qs = [np.array([20]), np.array([21]), np.array([22])]
        rs = [s.infer(q) for q in qs]
        assert rs[0].status == "error" and "retry budget" in rs[0].detail
        assert [r.status for r in rs] == ["error", "error", "ok"]
        assert s.stats()["pending"] == 0
        return rs, qs, _record(rs, s)

    rec = _both(sides, scenario, plan=dict(serve_crash_at=(1, 2)),
                max_attempts=1)
    assert rec["port"] == rec["ref"]


def test_matrix_serve_queue_overflow_burst(sides):
    """A burst past queue_depth sheds with typed overloaded responses: the
    queue is bounded, admission never blocks, nothing is dropped."""
    def scenario(s):
        qs = [np.array([1])]
        first = s.infer(qs[0])                          # warm
        futs = [s.submit(np.array([2]))]                # seq 2: stalls
        time.sleep(0.1)                                 # worker in the stall
        futs += [s.submit(np.array([i])) for i in range(3, 33)]
        rs = [first] + [f.result(timeout=120.0) for f in futs]
        qs += [np.array([i]) for i in range(2, 33)]
        last = s.infer(np.array([40]))
        assert last.status == "ok" and s.stats()["pending"] == 0
        return rs + [last], qs + [np.array([40])], {
            "statuses": [r.status for r in rs[1:]],
            "shed": s.stats()["shed"]}

    rec = _both(sides, scenario,
                plan=dict(serve_slow_at=(2,), serve_slow_s=0.5),
                queue_depth=4)
    for side in ("ref", "port"):
        statuses = rec[side]["statuses"]
        assert statuses.count("overloaded") >= 1, side   # the burst was shed
        assert statuses.count("ok") >= 1, side           # queued ones served
        assert set(statuses) <= {"ok", "overloaded"}, side
        assert rec[side]["shed"] == statuses.count("overloaded"), side
