"""Fault-tolerant, health-supervised LMC training loop (Algorithm 1) on one
device.

:class:`GNNTrainer` samples a c-cluster batch on the host, builds its tensors
(and, for ``backend="ell"|"ti"``, the bucketed ELL adjacency with its
transpose), runs the train step on the device, applies the optimizer, and
then commits the step's refreshed store rows in place. Around that:

  * periodic atomic checkpoints of (params, opt state, historical stores,
    sampler RNG state, lr, step counter) in the reference's format 2 —
    synchronous or, with ``async_ckpt=True``, written on a background
    thread (the hot path pays the device→host snapshot);
  * crash/preemption recovery: on failure the loop restores the newest
    *verifiable* checkpoint and continues;
  * numerical-health supervision (``health=HealthConfig(...)``): every step
    is checked for NaN/Inf loss/grad-norm and loss spikes, and periodically
    the store as it would be with the step's rows, *before* anything is
    applied (params, optimizer state and store rows are adopted only after
    the gate); a divergent step triggers rollback (bounded by
    ``max_retries``, optional lr-backoff) or skip-batch, and per-layer
    staleness counters enforce Thm 2's ρ-budget (DESIGN.md §10);
  * layered fault injection (``train.health.FaultPlan``): preemptions,
    pipeline-worker crashes, mid-save checkpoint failures and NaN-poisoned
    batches all recover to a stream-deterministic resume;
  * straggler mitigation: a step slower than ``straggler_deadline`` × the
    running median drops its store update (``straggler_policy=
    "skip-store"``), which Thm 2's staleness term tolerates, by simply not
    committing the rows;
  * ``prefetch``/``recycle`` route batch construction through the async
    ``SubgraphPipeline`` (data/prefetch.py): sampling + ELL bucketing on
    background threads into pinned memory, the copy to the card on a side
    stream behind the step, each subgraph optionally reused for ρ steps.
    The stream is a pure function of (sampler seed, step index), so resume
    stays deterministic. ``prefetch=None, recycle=1`` keeps the synchronous
    stateful-RNG path.

The initial parameters are the ``GNN``'s own (copied to ``device``), where
the reference draws them from a seed.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch import trace
from repro_torch.checkpoint import CheckpointError, CheckpointManager
from repro_torch.core import (HistoricalState, MBMethod, accuracy,
                              commit_rows, from_graph, host_batch,
                              init_history, make_train_step)
from repro_torch.data.prefetch import SubgraphPipeline
from repro_torch.device import resolve_device
from repro_torch.graph.sampler import ClusterSampler
from repro_torch.kernels import gat_attention
from repro_torch.models.gnn import GNN
from repro_torch.optim.optimizers import Optimizer, tree_map
from repro_torch.train.health import (FaultPlan, HealthConfig, HealthGuard,
                                      PipelineFault, SimulatedPreemption,
                                      TrainingDivergedError)

# running-median straggler baseline, bounded so the median stays O(1)
_STEP_TIME_WINDOW = 512


class _Divergence(RuntimeError):
    """Internal: a step failed its health check before being applied."""


class GNNTrainer:
    """Orchestrates sampling, the LMC step, optimizer updates, store commits,
    checkpointing, health supervision and fault handling for one run on one
    device.

    The trained parameters are ``self.params``, in the layout of
    ``GNN.params()``. ``device=None`` means the CUDA card and raises without
    one. Not thread-safe: one trainer per training thread; background work
    (batch construction, async checkpoint writes) is delegated to
    ``SubgraphPipeline`` workers / the ``CheckpointManager`` writer thread.
    Call :meth:`close` to stop those workers.
    """

    def __init__(self, gnn: GNN, method: MBMethod, graph,
                 sampler: ClusterSampler, optimizer: Optimizer, *,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 failure_injector: Optional[FaultPlan] = None,
                 health: Optional[HealthConfig] = None,
                 max_retries: int = 3,
                 async_ckpt: bool = False,
                 straggler_deadline: float = 4.0,
                 straggler_policy: str = "skip-store",
                 backend: str = "segment",
                 stream: Optional[bool] = None,
                 prefetch: Optional[int] = None,
                 recycle: int = 1,
                 pipeline_workers: int = 2,
                 pipeline_mode: str = "uniform",
                 device=None):
        """Set up the step, the stores on ``device`` and (lazily) the batch
        pipeline.

        Args:
            gnn / method / graph / sampler / optimizer: the model (whose
                parameters are the initial ones), the mini-batch method
                config (LMC/GAS/...), the host graph, its cluster sampler
                and the optimizer.
            ckpt_dir / ckpt_every: enable periodic atomic checkpoints.
            failure_injector: a ``train.health.FaultPlan`` scheduling any
                mix of injected faults; ``FailureInjector`` is a
                preemption-only FaultPlan.
            health: enable the numerical-health guard with this config
                (``HealthConfig()`` for defaults); None disables all
                health checks.
            max_retries: recovery budget — consecutive recovery actions
                (rollbacks / skipped batches / pipeline rebuilds) allowed
                without an intervening healthy step before the run aborts
                with ``TrainingDivergedError``.
            async_ckpt: write checkpoints on a background thread (the hot
                path only pays the device→host snapshot; files are
                byte-identical to synchronous saves).
            straggler_deadline / straggler_policy: per-step deadline as a
                multiple of the running-median step time; ``"skip-store"``
                drops a straggler step's store update (Thm 2-safe).
            backend: aggregation/compensation hot path, ``"segment"`` |
                ``"ell"`` (the CUDA kernels) | ``"ti"`` (store-free).
            stream: ``False`` runs the resident-source kernels (small
                graphs only); None or True the streaming ones.
            prefetch: queue depth of the async batch pipeline. ``None``
                keeps the synchronous stateful-RNG path; ``0`` uses the
                pipeline's schedule-indexed stream but builds synchronously;
                ``>= 1`` builds ahead on background threads with the copy
                to the card on a side stream.
            recycle: reuse each sampled subgraph for this many consecutive
                steps (ρ; implies the pipeline path when > 1).
            pipeline_workers: builder threads when prefetching.
            pipeline_mode: schedule of the pipeline path — ``"uniform"``
                or ``"epoch"``.
            device: where the step runs (None: the CUDA card).
        """
        if recycle < 1:
            raise ValueError(f"recycle must be >= 1, got {recycle}")
        if max_retries < 1:
            raise ValueError(f"max_retries must be >= 1, got {max_retries}")
        self.gnn = gnn
        self.method = method
        self.graph = graph
        self.sampler = sampler
        self.opt = optimizer
        self.failure_injector = failure_injector
        self.straggler_deadline = straggler_deadline
        self.straggler_policy = straggler_policy
        self.backend = backend
        self.stream = stream
        self.prefetch = prefetch
        self.recycle = int(recycle)
        self.pipeline_workers = int(pipeline_workers)
        self.pipeline_mode = pipeline_mode
        # pipeline path whenever asked for (prefetch set) or needed (ρ > 1);
        # built lazily so it always starts at the current step (resume-safe)
        self._use_pipeline = prefetch is not None or self.recycle > 1
        self._pipeline: Optional[SubgraphPipeline] = None

        self.device = resolve_device(device)
        self.data = from_graph(graph, device=self.device)
        self.params = tree_map(lambda p: p.detach().to(self.device, copy=True),
                               gnn.params())
        self.opt_state = optimizer.init(self.params)
        self.store = init_history(gnn.num_layers, graph.num_nodes,
                                  gnn.store_widths(), device=self.device)
        self.step_num = 0
        self.lr = float(optimizer.lr)   # mutable: rollback lr-backoff
        self._step = make_train_step(gnn, method, graph.num_nodes,
                                     backend=backend, stream=stream)
        fault_hook = (failure_injector.ckpt_hook
                      if isinstance(failure_injector, FaultPlan) else None)
        self.ckpt = (CheckpointManager(ckpt_dir, fault_hook=fault_hook)
                     if ckpt_dir else None)
        self.ckpt_every = ckpt_every
        self.async_ckpt = bool(async_ckpt)
        self.health = health
        self.guard = (HealthGuard(health, gnn.num_layers, graph.num_nodes)
                      if health is not None else None)
        self.max_retries = int(max_retries)
        self._retries_left = self.max_retries
        self._step_times: deque = deque(maxlen=_STEP_TIME_WINDOW)
        self.history: list = []

    # ----------------------------------------------------------------- state
    def _state_tree(self) -> dict:
        return {"params": self.params, "opt": self.opt_state,
                "store": (self.store.h, self.store.v)}

    def save(self) -> None:
        """Write an atomic checkpoint (params/opt/stores/sampler RNG/lr/step).

        With ``async_ckpt`` the write happens on the manager's background
        thread; this call only pays the device→host snapshot, which is a
        copy finished before it returns (the next step writes the store in
        place). A failed write (injected or real) surfaces as OSError here
        or, for a background write, at the next manager call.
        """
        if self.ckpt is None:
            return
        extras = {"step": self.step_num, "lr": self.lr,
                  "sampler": _jsonable(self.sampler.state_dict())}
        self.ckpt.save(self.step_num, self._state_tree(), extras,
                       background=self.async_ckpt)

    def restore(self) -> bool:
        """Restore the newest verifiable checkpoint; False when none exists.

        Corrupt/truncated checkpoints are skipped (the manager walks
        newest-first with per-leaf checksum verification). Also discards
        any in-flight batch pipeline: the stream is a pure function of the
        step index, so rebuilding it at the restored step replays exactly
        the batches the uninterrupted run would have seen.
        """
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        try:
            tree, extras, step = self.ckpt.restore(self._state_tree())
        except CheckpointError as e:
            # no verifiable checkpoint at all: report and start clean
            self.history.append({"step": self.step_num,
                                 "event": "restore-failed", "error": str(e)})
            return False
        tree = tree_map(lambda a: torch.from_numpy(a).to(self.device), tree)
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        self.store = HistoricalState(*tree["store"])
        self.step_num = extras["step"]
        self.lr = float(extras.get("lr", self.lr))
        self.sampler.load_state_dict(_from_jsonable(extras["sampler"]))
        if self.guard is not None:
            # counters don't ride the checkpoint: restart conservative (all
            # rows fresh-at-restore; true staleness is ≤ checkpoint interval)
            self.guard.reset_staleness()
        self._reset_pipeline()
        return True

    # ------------------------------------------------------------- pipeline
    def _batch_pipeline(self) -> SubgraphPipeline:
        """The async batch source, (re)built lazily at the current step."""
        if self._pipeline is None:
            hook = (self.failure_injector.pipeline_hook
                    if isinstance(self.failure_injector, FaultPlan) else None)
            self._pipeline = SubgraphPipeline(
                self.sampler, backend=self.backend,
                depth=self.prefetch if self.prefetch is not None else 0,
                workers=self.pipeline_workers, recycle=self.recycle,
                mode=self.pipeline_mode, start_step=self.step_num,
                build_hook=hook, device=self.device)
        return self._pipeline

    def _reset_pipeline(self) -> None:
        """Close the pipeline; the next step rebuilds it at ``step_num``."""
        if self._pipeline is not None:
            self._pipeline.close()
            self._pipeline = None

    def close(self) -> None:
        """Stop background pipeline workers + checkpoint writer (idempotent)."""
        self._reset_pipeline()
        if self.ckpt is not None:
            self.ckpt.close()

    # ------------------------------------------------------------------ run
    def run(self, num_steps: int, *, eval_every: int = 0) -> list:
        """Train for ``num_steps`` more steps; returns the history list.

        Each step appends ``{"step", "loss", "train_acc", "grad_norm",
        "time_s", "host_s", "straggler", "attn_launches", "t_ns"}`` (with
        health on, also
        ``"halo_staleness"`` and, past the ρ budget,
        ``"staleness_violation"``): ``time_s`` is the whole step on the host
        clock but its store commit, ``host_s`` the part spent obtaining
        the batch (sampling and building it, or waiting on the pipeline:
        the span ``trainer.wait``), ``t_ns`` the step's start and end on the
        profiler's clock (``time.time_ns()``), ``attn_launches`` the GAT
        attention kernels the step launched (``kernels.gat_attention``'s
        counter: 0 for every other arch, and where the step ran the plain
        twins). ``time_s`` and ``host_s``
        stay on ``perf_counter``, which no clock adjustment can step, since
        their ratio is a metric; ``t_ns`` only places the step on a trace.
        On the pipeline path, the
        first step that consumes a slot also carries ``"slot"``: the slot's
        build record (``{"index", "t_ns", "sample_ms", "bucket_ms",
        "copy_bytes", "ell_launches"}``, ``"pin_ms"`` where pinned,
        ``"copy_ms"`` where a side stream copied it and ``"ell_ms"`` where
        it built the ELL buckets there; ``SubgraphPipeline._build_host``
        and ``_stage``). While a
        torch profiler records on a CUDA device, ``"device_ms"`` holds the
        compute stream's ms of ``"optimizer"`` and ``"commit"`` (the store
        rows; absent where the step kept them out), and the spans
        ``trainer.wait``, ``step.lmc``, ``step.optimizer`` and
        ``step.commit`` show in the trace, with ``gat.attention`` and
        ``gat.attention.vjp`` around each attention call. Every ``eval_every`` steps a
        ``{"step", "val_acc"}`` record follows.

        The supervisor loop: every fault class recovers here without
        operator intervention —

        * simulated preemption → restore the newest verifiable checkpoint
          and continue (the batch pipeline is rebuilt at the restored step,
          so the resumed stream is identical to an uninterrupted run);
        * pipeline-worker crash → rebuild the pipeline at the current step
          and retry the same slot;
        * divergent step (NaN/Inf/spike, from the health guard) → policy
          ``"rollback"`` (restore + optional lr-backoff) or ``"skip-batch"``
          (drop the poisoned update, advance);
        * checkpoint-write failure → record and continue; the previous
          checkpoint is still intact (atomic publication).

        Consecutive recoveries are bounded by ``max_retries`` — when the
        budget is exhausted without a healthy step in between, the run
        aborts with :class:`TrainingDivergedError` rather than live-locking.
        """
        target = self.step_num + num_steps
        while self.step_num < target:
            try:
                self._one_step()
                self._retries_left = self.max_retries  # healthy step: reset
            except SimulatedPreemption:
                # crash recovery: restore last checkpoint and continue; a
                # failed restore still discards the pipeline so the aborted
                # step's already-consumed batch is re-fetched, not skipped
                restored = self.restore()
                if not restored:
                    self._reset_pipeline()
                self.history.append({"step": self.step_num,
                                     "event": "preemption",
                                     "restored": restored})
                continue
            except PipelineFault as e:
                self._spend_retry(f"pipeline fault: {e}")
                self._reset_pipeline()   # rebuild at step_num: same slot
                self.history.append({"step": self.step_num,
                                     "event": "pipeline-fault",
                                     "error": str(e)})
                continue
            except _Divergence as e:
                self._spend_retry(f"divergence: {e}")
                self._recover_divergence(str(e))
                continue
            if self.ckpt and self.step_num % self.ckpt_every == 0:
                try:
                    self.save()
                except OSError as e:   # includes injected CheckpointWriteFault
                    self.history.append({"step": self.step_num,
                                         "event": "ckpt-write-failed",
                                         "error": str(e)})
            if eval_every and self.step_num % eval_every == 0:
                self.history.append({"step": self.step_num,
                                     "val_acc": self.eval("val")})
        return self.history

    def _spend_retry(self, reason: str) -> None:
        """Consume one unit of the recovery budget or abort the run."""
        self._retries_left -= 1
        if self._retries_left < 0:
            raise TrainingDivergedError(
                f"recovery budget exhausted ({self.max_retries} retries) "
                f"at step {self.step_num}; last incident: {reason}")

    def _recover_divergence(self, reason: str) -> None:
        """Execute the health policy for a rejected (never-applied) step."""
        policy = self.health.policy if self.health else "skip-batch"
        if policy == "rollback":
            restored = self.restore()
            if restored:
                if self.health.lr_backoff < 1.0:
                    self.lr *= self.health.lr_backoff
                self.history.append({"step": self.step_num,
                                     "event": "health-rollback",
                                     "reason": reason, "lr": self.lr})
                return
            # nothing verifiable to roll back to: degrade to skip-batch
        # skip-batch: the poisoned update was never applied; advance past
        # the consumed batch (synchronous path: the sampler RNG already moved)
        self.step_num += 1
        if self.guard is not None:
            # the store kept its old rows — every row ages one step
            self.guard.staleness += 1
        self.history.append({"step": self.step_num,
                             "event": "health-skip-batch", "reason": reason,
                             "policy": policy})

    def _one_step(self) -> None:
        t0, t0_ns = time.perf_counter(), time.time_ns()
        dev, fresh = {}, None   # device event pairs, the new slot's record
        with trace.span("trainer.wait"):
            if self._use_pipeline:
                pipe = self._batch_pipeline()
                batch = next(pipe)             # may raise PipelineFault
                hb, fresh = pipe.host, pipe.slot
            else:
                hb = host_batch(self.sampler.sample(), backend=self.backend)
        host_s = time.perf_counter() - t0
        if not self._use_pipeline:
            batch = hb.to(self.device)
        if fresh is not None:
            dev.update(fresh[1])
        if self.failure_injector is not None:
            self.failure_injector.maybe_fail(self.step_num)
            if isinstance(self.failure_injector, FaultPlan):
                batch = self.failure_injector.corrupt_batch(self.step_num,
                                                            batch)
        launches = gat_attention.LAUNCHES
        with trace.span("step.lmc"):
            loss, grads, rows, metrics = self._step(
                self.params, self.store, batch, self.data.x, self.data.self_w)
        launches = gat_attention.LAUNCHES - launches
        with (trace.span("step.optimizer"),
              trace.device_span("step.optimizer", dev, self.device)):
            new_params, new_opt, gnorm = self.opt.update(
                grads, self.opt_state, self.params, self.lr)
        if self._use_pipeline:   # the next slot's copy, behind this step
            pipe.stage_next()
        lossf, gnormf = float(loss), float(gnorm)

        # ---- health gate: nothing below is applied if this step diverged
        if self.guard is not None:
            reason = self.guard.check_step(lossf, gnormf)
            if reason is None and self.guard.store_check_due(self.step_num):
                reason = self.guard.check_store(self.store, batch, rows)
            if reason is not None:
                raise _Divergence(reason)

        self.params, self.opt_state = new_params, new_opt
        dt = time.perf_counter() - t0
        # straggler mitigation: drop the (stale-tolerant) store update when
        # this step blew its deadline, so the next step isn't gated on it
        med = float(np.median(self._step_times)) if self._step_times else dt
        is_straggler = (len(self._step_times) >= 8
                        and dt > self.straggler_deadline * med)
        store_updated = not (is_straggler
                             and self.straggler_policy == "skip-store")
        if store_updated and rows is not None:
            with (trace.span("step.commit"),
                  trace.device_span("step.commit", dev, self.device)):
                commit_rows(self.store, batch, rows, self.graph.num_nodes)
        acc = float(metrics["train_acc"])
        # reading acc waited for the compute stream, which had waited for
        # the batch's copy: every event in ``dev`` has passed
        dev_ms = trace.elapsed_ms(dev)
        rec = {"step": self.step_num + 1, "loss": lossf, "train_acc": acc,
               "grad_norm": gnormf, "time_s": dt, "host_s": host_s,
               "straggler": bool(is_straggler), "attn_launches": launches}
        if fresh is not None:
            rec["slot"] = fresh[0]
            for name in fresh[1]:   # pipeline.copy, pipeline.ell
                rec["slot"][name.split(".")[1] + "_ms"] = dev_ms.pop(name)
        if dev_ms:
            rec["device_ms"] = {k.split(".")[1]: v for k, v in dev_ms.items()}
        if self.guard is not None:
            self.guard.observe(lossf)
            # the host batch holds the same gids and masks: no device sync
            halo_stale = self.guard.halo_staleness(hb.halo_gids.numpy(),
                                                   hb.halo_mask.numpy())
            self.guard.tick(hb.batch_gids.numpy(), hb.batch_mask.numpy(),
                            store_updated)
            rec["halo_staleness"] = halo_stale
            rho_msg = self.guard.check_rho_budget(halo_stale)
            if rho_msg is not None:
                rec["staleness_violation"] = rho_msg
        self._step_times.append(dt)
        self.step_num += 1
        rec["t_ns"] = (t0_ns, time.time_ns())
        self.history.append(rec)

    # ----------------------------------------------------------------- eval
    def eval(self, split: str = "val") -> float:
        """Full-graph accuracy on the given split ("train"|"val"|"test")."""
        mask = {"val": self.graph.val_mask, "test": self.graph.test_mask,
                "train": self.graph.train_mask}[split]
        with torch.no_grad():
            return float(accuracy(
                self.gnn, self.params, self.data,
                torch.from_numpy(mask.astype(np.float32)).to(self.device)))


def _jsonable(state: dict):
    """``state`` through JSON, numpy scalars and arrays encoded as the
    reference encodes them, so the checkpoint ``extras`` are the same."""
    return json.loads(json.dumps(state, default=_np_default))


def _np_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return {"__nd__": o.tolist(), "dtype": str(o.dtype)}
    raise TypeError(type(o))


def _from_jsonable(state):
    def conv(x):
        if isinstance(x, dict):
            if "__nd__" in x:
                return np.asarray(x["__nd__"], dtype=x["dtype"])
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        return x
    return conv(state)
