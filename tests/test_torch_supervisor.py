"""The port's training supervisor: health guard, fault plan, recovery loop,
checkpointed resume and elastic rescale (mirrors tests/test_supervisor.py and
tests/test_fault_tolerance.py), then the port's trainer beside the
reference's under the same fault plans.

Port-only runs compare against the port's own uninterrupted run: exactly for
preemption, pipeline and checkpoint faults, rtol 1e-6 for a NaN rollback (as
the reference's own tests hold it). Side by side with the reference, from the
same parameters: the same history events at the same steps, losses within
rtol 1e-5. Every exact comparison turns the straggler rule off
(``straggler_deadline=inf``), which would otherwise make the stream depend on
wall-clock time. Everything runs on the CPU.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import graph as jgraph
from repro.core import LMC as J_LMC
from repro.models import make_gnn as j_make_gnn
from repro.optim import sgd as j_sgd
from repro.train import FaultPlan as JFaultPlan
from repro.train import GNNTrainer as JTrainer
from repro.train import HealthConfig as JHealthConfig
from repro.train.health import CheckpointWriteFault as JCheckpointWriteFault

from repro_torch import graph as tgraph
from repro_torch.train import (FailureInjector, FaultPlan, HealthConfig,
                               HealthGuard, StalenessBudgetError,
                               TrainingDivergedError, rescale_lmc_state)
from repro_torch.train.health import CheckpointWriteFault

from _torch_port import (NO_STRAGGLERS, PARTS, events, losses, port_trainer,
                         tiny_graph, tiny_parts)

LOSS = dict(rtol=1e-5, atol=0)


@pytest.fixture(scope="module")
def tg():
    return tiny_graph(tgraph)


@pytest.fixture(scope="module")
def parts():
    return tiny_parts()


@pytest.fixture(scope="module")
def clean_runs(tg, parts, tmp_path_factory):
    """Uninterrupted baselines: the synchronous and the pipelined stream."""
    base = tmp_path_factory.mktemp("clean")
    t_sync = port_trainer(tg, parts, str(base / "sync"))
    t_sync.run(40)
    t_pipe = port_trainer(tg, parts, str(base / "pipe"), prefetch=2)
    t_pipe.run(30)
    t_pipe.close()
    return {"sync": losses(t_sync), "pipe": losses(t_pipe)}


def _same_stream(got: dict, ref: dict, **tol):
    assert sorted(got) == sorted(ref)
    a, b = [got[s] for s in sorted(got)], [ref[s] for s in sorted(ref)]
    if tol:
        np.testing.assert_allclose(a, b, **tol)
    else:
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ fault matrix
def test_matrix_preemption(tg, parts, tmp_path, clean_runs):
    tr = port_trainer(tg, parts, str(tmp_path),
                      failure_injector=FaultPlan(preempt_at=(25,)))
    tr.run(40)
    evs = events(tr, "preemption")
    assert len(evs) == 1 and evs[0]["restored"] and evs[0]["step"] == 20
    _same_stream(losses(tr), clean_runs["sync"])


def test_matrix_pipeline_worker_crash(tg, parts, tmp_path, clean_runs):
    tr = port_trainer(tg, parts, str(tmp_path), prefetch=2,
                      failure_injector=FaultPlan(pipeline_at=(13,)))
    tr.run(30)
    tr.close()
    assert [e["step"] for e in events(tr, "pipeline-fault")] == [13]
    _same_stream(losses(tr), clean_runs["pipe"])


def test_matrix_ckpt_write_failure(tg, parts, tmp_path, clean_runs):
    tr = port_trainer(tg, parts, str(tmp_path),
                      failure_injector=FaultPlan(ckpt_write_at=(30,)))
    tr.run(40)
    assert len(events(tr, "ckpt-write-failed")) == 1
    # the aborted save left no partial/tmp state and older steps survive
    assert 30 not in tr.ckpt.all_steps()
    assert not list(Path(tmp_path).glob("*.tmp.*"))
    assert tr.ckpt.latest_step() == 40
    _same_stream(losses(tr), clean_runs["sync"])


def test_matrix_nan_batch_rollback(tg, parts, tmp_path, clean_runs):
    """Injected NaN gradients -> health rollback -> stream-deterministic
    replay (rtol 1e-6, as the reference holds it)."""
    tr = port_trainer(tg, parts, str(tmp_path), health=HealthConfig(),
                      failure_injector=FaultPlan(nan_batch_at=(25,)))
    tr.run(40)
    evs = events(tr, "health-rollback")
    assert len(evs) == 1 and "non-finite" in evs[0]["reason"]
    _same_stream(losses(tr), clean_runs["sync"], rtol=1e-6, atol=0)


# ---------------------------------------------------------- health policies
def test_nan_skip_batch_policy(tg, parts, tmp_path, clean_runs):
    tr = port_trainer(tg, parts, str(tmp_path),
                      health=HealthConfig(policy="skip-batch"),
                      failure_injector=FaultPlan(nan_batch_at=(15,)))
    tr.run(30)
    assert len(events(tr, "health-skip-batch")) == 1
    got = losses(tr)
    assert 16 not in got          # the poisoned step was skipped, not applied
    assert all(np.isfinite(v) for v in got.values())
    ref = clean_runs["sync"]
    assert [got[s] for s in range(1, 16)] == [ref[s] for s in range(1, 16)]
    assert max(got) == 30


def test_rollback_without_checkpoint_degrades_to_skip(tg, parts):
    tr = port_trainer(tg, parts, None, health=HealthConfig(),
                      failure_injector=FaultPlan(nan_batch_at=(5,)))
    tr.run(12)
    evs = events(tr, "health-skip-batch")
    assert len(evs) == 1 and evs[0]["policy"] == "rollback"
    assert all(np.isfinite(v) for v in losses(tr).values())


def test_retry_budget_exhausts(tg, parts):
    """Persistent divergence without recovery aborts instead of
    live-locking."""
    tr = port_trainer(tg, parts, None, health=HealthConfig(), max_retries=2,
                      failure_injector=FaultPlan(nan_batch_at=(3, 4, 5, 6,
                                                               7)))
    with pytest.raises(TrainingDivergedError, match="budget exhausted"):
        tr.run(20)


def test_lr_backoff_on_rollback(tg, parts, tmp_path):
    tr = port_trainer(tg, parts, str(tmp_path),
                      health=HealthConfig(lr_backoff=0.5),
                      failure_injector=FaultPlan(nan_batch_at=(15,)))
    tr.run(25)
    assert len(events(tr, "health-rollback")) == 1
    assert tr.lr == pytest.approx(0.15)   # 0.3 * 0.5
    assert all(np.isfinite(v) for v in losses(tr).values())


def test_invalid_options_rejected(tg, parts):
    with pytest.raises(ValueError, match="recycle"):
        port_trainer(tg, parts, recycle=0)
    with pytest.raises(ValueError, match="max_retries"):
        port_trainer(tg, parts, max_retries=0)
    with pytest.raises(ValueError, match="policy"):
        port_trainer(tg, parts, health=HealthConfig(policy="ignore"))


# ---------------------------------------------------------- guard units
def test_guard_spike_detection():
    g = HealthGuard(HealthConfig(spike_factor=10.0, warmup=4), 2, 8)
    for _ in range(6):
        assert g.check_step(1.0, 0.5) is None
        g.observe(1.0)
    assert g.check_step(1.5, 0.5) is None         # normal fluctuation
    reason = g.check_step(50.0, 0.5)              # 50x the median baseline
    assert reason is not None and "spike" in reason
    assert g.check_step(float("nan"), 0.5) is not None
    assert g.check_step(1.0, float("inf")) is not None
    assert g.num_incidents == 3


def test_guard_grad_norm_limit():
    g = HealthGuard(HealthConfig(grad_norm_limit=10.0), 2, 8)
    assert g.check_step(1.0, 9.0) is None
    assert "exceeds limit" in g.check_step(1.0, 11.0)


def test_guard_staleness_counters():
    g = HealthGuard(HealthConfig(), num_layers=2, num_nodes=6)
    gids, mask = np.array([0, 1, 2]), np.ones(3)
    g.tick(gids, mask, store_updated=True)
    assert g.staleness[:, :3].max() == 0 and g.staleness[:, 3:].min() == 1
    g.tick(gids, mask, store_updated=False)       # skip-store straggler step
    assert g.staleness[:, :3].min() == 1 and g.staleness[:, 3:].min() == 2
    halo = np.array([3, 4])
    assert g.halo_staleness(halo, np.ones(2)) == 2
    assert g.halo_staleness(halo, np.zeros(2)) == 0   # fully masked halo
    g.reset_staleness()
    assert g.staleness.max() == 0


def test_guard_rho_budget():
    g = HealthGuard(HealthConfig(rho_budget=3), 1, 4)
    assert g.check_rho_budget(3) is None
    assert "rho budget" in g.check_rho_budget(4)
    strict = HealthGuard(HealthConfig(rho_budget=3, rho_strict=True), 1, 4)
    with pytest.raises(StalenessBudgetError):
        strict.check_rho_budget(4)


def test_guard_store_check_due():
    g = HealthGuard(HealthConfig(store_check_every=5), 1, 4)
    assert [s for s in range(12) if g.store_check_due(s)] == [0, 5, 10]
    off = HealthGuard(HealthConfig(store_check_every=0), 1, 4)
    assert not any(off.store_check_due(s) for s in range(12))


def test_guard_check_store_sees_the_store_with_the_rows_written():
    """The trainer commits rows after the gate, so the check reads the store
    as it would be with them: a NaN row the batch overwrites with finite
    values passes, a NaN returned row fails, padded rows are dropped, and h
    and v are named apart."""
    from repro_torch.core import HistoricalState
    from repro_torch.core.lmc import Batch
    g = HealthGuard(HealthConfig(), 2, 6)
    store = HistoricalState(torch.zeros(2, 6, 3), torch.zeros(1, 6, 3))
    gids = torch.tensor([1, 4, 0], dtype=torch.int32)
    mask = torch.tensor([1.0, 1.0, 0.0])   # gid 0 rides as padding
    batch = Batch(*([gids, None, mask] + [None] * 9))
    rows = HistoricalState(torch.ones(2, 3, 3), torch.ones(1, 3, 3))
    assert g.check_store(store) is None
    store.h[1, 4, 2] = float("nan")        # overwritten by the batch
    assert g.check_store(store, batch, rows) is None
    assert "(h)" in g.check_store(store)   # as the store stands now
    rows.h[0, 2] = float("nan")            # a padded row: dropped
    assert g.check_store(store, batch, rows) is None
    rows.v[0, 1] = float("inf")            # a real returned row
    assert "(v)" in g.check_store(store, batch, rows)
    store.h[0, 5, 0] = float("nan")        # not in the batch
    assert "(h)" in g.check_store(store, batch, rows)
    assert g.num_incidents == 3


def test_staleness_recorded_in_history(tg, parts, tmp_path):
    tr = port_trainer(tg, parts, str(tmp_path), health=HealthConfig())
    tr.run(15)
    recs = [h for h in tr.history if "loss" in h]
    assert all("halo_staleness" in h for h in recs)
    assert max(h["halo_staleness"] for h in recs) >= 1   # rows age


def test_rho_budget_violation_recorded_or_raised(tg, parts):
    tr = port_trainer(tg, parts, None, health=HealthConfig(rho_budget=0))
    tr.run(6)
    assert any("staleness_violation" in h for h in tr.history)
    strict = port_trainer(tg, parts, None,
                          health=HealthConfig(rho_budget=0, rho_strict=True))
    with pytest.raises(StalenessBudgetError):
        strict.run(6)


# ------------------------------------------------- checkpointed resume
def test_preemption_recovery_with_failure_injector(tg, parts, tmp_path,
                                                  clean_runs):
    tr = port_trainer(tg, parts, str(tmp_path),
                      failure_injector=FailureInjector(fail_at_steps=(33,)))
    hist = tr.run(40)
    evs = [h for h in hist if h.get("event") == "preemption"]
    assert len(evs) == 1 and evs[0]["restored"] and evs[0]["step"] == 30
    assert tr.step_num == 40
    _same_stream(losses(tr), clean_runs["sync"])


@pytest.mark.parametrize("async_ckpt", [False, True], ids=["sync", "async"])
def test_resume_is_deterministic(tg, parts, tmp_path, async_ckpt):
    """Restore + continue == uninterrupted run (same sampler state), from a
    synchronous or a background-written checkpoint."""
    t1 = port_trainer(tg, parts, str(tmp_path), async_ckpt=async_ckpt)
    t1.run(20)
    t1.save()
    t1.run(5)
    cont = [h["loss"] for h in t1.history if "loss" in h][-5:]
    t1.close()
    t2 = port_trainer(tg, parts, str(tmp_path))
    assert t2.restore() and t2.step_num == 20
    t2.run(5)
    np.testing.assert_array_equal(
        cont, [h["loss"] for h in t2.history if "loss" in h][-5:])


def test_trainer_restores_from_corrupt_latest(tg, parts, tmp_path):
    t1 = port_trainer(tg, parts, str(tmp_path))
    t1.run(30)                                     # checkpoints at 10, 20, 30
    latest = Path(tmp_path) / "step_0000000030" / "arr_0.npy"
    latest.write_bytes(latest.read_bytes()[:64])
    t2 = port_trainer(tg, parts, str(tmp_path))
    assert t2.restore() and t2.step_num == 20
    hist = t2.run(10)
    assert np.isfinite([h["loss"] for h in hist if "loss" in h][-1])


def test_async_snapshot_is_a_copy(tg, parts, tmp_path):
    """The store changes in place at every commit: a background save must
    publish the values of the step it was taken at, verifiably."""
    tr = port_trainer(tg, parts, str(tmp_path), async_ckpt=True)
    tr.run(10)                                     # async save at step 10
    want = tr.store.h.clone()
    tr.run(3)
    tr.close()
    assert not torch.equal(tr.store.h, want)
    assert tr.ckpt.verify(10)
    tree, _, step = tr.ckpt.restore(tr._state_tree(), step=10)
    assert step == 10
    np.testing.assert_array_equal(tree["store"][0], want.numpy())


def test_restore_resets_staleness_and_pipeline(tg, parts, tmp_path):
    tr = port_trainer(tg, parts, str(tmp_path), prefetch=2,
                      health=HealthConfig())
    tr.run(12)
    assert tr.guard.staleness.max() > 0 and tr._pipeline is not None
    assert tr.restore() and tr.step_num == 10
    assert tr.guard.staleness.max() == 0 and tr._pipeline is None
    tr.close()


def test_straggler_skip_store(tg, parts, tmp_path, clean_runs):
    tr = port_trainer(tg, parts, str(tmp_path), straggler_deadline=0.0)
    hist = tr.run(15)          # every step after warm-up is late
    recs = [h for h in hist if "loss" in h]
    assert [h["straggler"] for h in recs] == [False] * 8 + [True] * 7
    # the first late step still applies its update, only the store misses
    # its rows; the next step reads the older store and so departs
    ref = clean_runs["sync"]
    assert [h["loss"] for h in recs[:9]] == [ref[s] for s in range(1, 10)]
    assert recs[9]["loss"] != ref[10]
    assert all(np.isfinite(h["loss"]) for h in recs)


@pytest.mark.parametrize("reuse", [True, False], ids=["reuse", "reinit"])
def test_elastic_rescale(tg, parts, tmp_path, reuse):
    tr = port_trainer(tg, parts, str(tmp_path), health=HealthConfig())
    tr.run(10)
    before = tr.store.h.clone()
    sampler2, store2 = rescale_lmc_state(
        tg, tr.store, old_num_parts=PARTS, new_num_parts=2, seed=1,
        reuse_store=reuse, guard=tr.guard)
    assert sampler2.num_parts == 2
    if reuse:
        assert torch.equal(store2.h, before) and tr.guard.staleness.max() > 0
    else:
        assert store2.h.device == before.device
        assert not store2.h.any() and not store2.v.any()
        assert tr.guard.staleness.max() == 0
    tr.sampler, tr.store = sampler2, store2
    hist = tr.run(5)
    assert np.isfinite([h["loss"] for h in hist if "loss" in h][-1])


# -------------------------------------- side by side with the reference
@pytest.fixture(scope="module")
def jg():
    return tiny_graph(jgraph)


def _pair(jg, tg, parts, tmp_path, plan_kw: dict, *, arch="gcn",
          backend="segment", health=None, ckpt_every=5, **kw):
    """(reference trainer, port trainer) from the reference's initial
    parameters, each with its own FaultPlan(**plan_kw) and checkpoints."""
    gnn = j_make_gnn(arch, jg.feature_dim, 16, jg.num_classes, 2)
    params = jax.tree.map(np.asarray, gnn.init_params(jax.random.key(0)))
    common = dict(ckpt_every=ckpt_every, backend=backend,
                  straggler_deadline=NO_STRAGGLERS, **kw)
    jt = JTrainer(gnn, J_LMC, jg,
                  jgraph.ClusterSampler(jg, PARTS, 1, parts=parts, seed=1),
                  j_sgd(lr=0.2), seed=0, ckpt_dir=str(tmp_path / "ref"),
                  failure_injector=JFaultPlan(**plan_kw),
                  health=None if health is None else JHealthConfig(**health),
                  **common)
    tt = port_trainer(tg, parts, str(tmp_path / "port"), arch=arch, lr=0.2,
                      params=params, failure_injector=FaultPlan(**plan_kw),
                      health=None if health is None else HealthConfig(**health),
                      **common)
    return jt, tt


def _assert_same_supervision(jt, tt):
    def evs(h):
        return [(r["step"], r["event"]) for r in h if "event" in r]
    assert evs(tt.history) == evs(jt.history)
    got, want = losses(tt), losses(jt)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose([got[s] for s in sorted(got)],
                               [want[s] for s in sorted(want)], **LOSS)


@pytest.mark.parametrize("plan_kw,kw", [
    (dict(preempt_at=(12,)), {}),
    (dict(pipeline_at=(7,)), dict(prefetch=2)),
    (dict(ckpt_write_at=(10,)), {}),
    (dict(nan_batch_at=(8,)), dict(health=dict(store_check_every=2))),
    (dict(nan_batch_at=(8,)), dict(health=dict(policy="skip-batch"))),
    (dict(preempt_at=(13,), pipeline_at=(3,)), dict(prefetch=2, recycle=2)),
], ids=["preempt", "pipeline", "ckpt-write", "nan-rollback", "nan-skip",
        "recycled"])
def test_fault_plan_matches_reference(jg, tg, parts, tmp_path, plan_kw, kw):
    jt, tt = _pair(jg, tg, parts, tmp_path, plan_kw, **kw)
    try:
        jt.run(20)
        tt.run(20)
    finally:
        jt.close()
        tt.close()
    _assert_same_supervision(jt, tt)
    assert tt.history and len(tt.history) == len(jt.history)


@pytest.mark.parametrize("arch,backend,diverges", [
    ("gcn", "ell", False), ("sage", "ell", True), ("gcn", "segment", True)])
def test_corrupt_batch_matches_reference(jg, tg, parts, tmp_path, arch,
                                         backend, diverges):
    """``corrupt_batch`` poisons ``edge_w`` only: on ell, GCN never reads it
    (its aggregation runs on the ELL weights), GraphSAGE does (its degree),
    and segment aggregation does for every architecture."""
    jt, tt = _pair(jg, tg, parts, tmp_path, dict(nan_batch_at=(1,)),
                   arch=arch, backend=backend,
                   health=dict(policy="skip-batch"))
    jt.run(3)
    tt.run(3)
    assert len(events(tt, "health-skip-batch")) == int(diverges)
    _assert_same_supervision(jt, tt)


def _first_batch_gids(graph, parts, lib) -> np.ndarray:
    sg = lib.ClusterSampler(graph, PARTS, 1, parts=parts, seed=1).sample()
    return np.asarray(sg.batch_gids)[np.asarray(sg.batch_mask) > 0]


@pytest.mark.parametrize("in_batch", [True, False],
                         ids=["overwritten", "kept"])
def test_check_store_matches_reference(jg, tg, parts, tmp_path, in_batch):
    """A NaN store row: the step's rows overwrite it (both packages pass the
    check) or not (both reject the step). Row 0 is avoided: padded halo rows
    gather it, and 0·NaN would poison the loss itself."""
    batch = _first_batch_gids(tg, parts, tgraph)
    others = np.setdiff1d(np.arange(1, tg.num_nodes),
                          _halo_and_batch(tg, parts))
    gid = int(batch[batch != 0][0] if in_batch else others[0])
    jt, tt = _pair(jg, tg, parts, tmp_path, {},
                   health=dict(store_check_every=1, policy="skip-batch"))
    jt.store = jt.store._replace(h=jt.store.h.at[0, gid].set(jnp.nan))
    tt.store.h[0, gid] = float("nan")
    jt.run(1)
    tt.run(1)
    assert len(events(tt, "health-skip-batch")) == int(not in_batch)
    _assert_same_supervision(jt, tt)


def _halo_and_batch(graph, parts) -> np.ndarray:
    sg = tgraph.ClusterSampler(graph, PARTS, 1, parts=parts, seed=1).sample()
    return np.concatenate([sg.batch_gids[sg.batch_mask > 0],
                           sg.halo_gids[sg.halo_mask > 0]])


def test_async_write_failure_then_preemption_aborts_in_both(jg, tg, parts,
                                                            tmp_path):
    """A reference fault the port keeps: a failed background write re-raises
    from the next manager call; when that is the restore after a preemption,
    ``run`` lets it out."""
    jt, tt = _pair(jg, tg, parts, tmp_path,
                   dict(ckpt_write_at=(4,), preempt_at=(5,)), ckpt_every=2,
                   async_ckpt=True)
    with pytest.raises(JCheckpointWriteFault, match="at step 4 \\(leaf_1\\)"):
        jt.run(8)
    with pytest.raises(CheckpointWriteFault, match="at step 4 \\(leaf_1\\)"):
        tt.run(8)
