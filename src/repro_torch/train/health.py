"""Numerical-health supervision + layered fault injection (DESIGN.md §10).

LMC's convergence guarantee (Thm 2) only holds while (a) the iterates stay
finite and (b) the historical-store staleness stays within the ρ-budget the
theorem's geometric bias term assumes. Two pieces live here:

* :class:`HealthGuard` — per-step numerical-health checks (NaN/Inf in
  loss / grad-norm / store, loss-spike anomalies against a rolling-median
  baseline) plus per-layer store-staleness counters, so the ρ-budget is an
  enforced invariant rather than a docstring comment. The guard only
  *detects*; the recovery policy (rollback-to-checkpoint with bounded
  retries and optional lr-backoff, or skip-batch) is executed by
  ``GNNTrainer.run``, which is where the checkpoint and the pipeline live.

* :class:`FaultPlan` — the layered fault-injection framework generalizing
  the old single-class ``FailureInjector``. One plan schedules any mix of
  fault classes, each firing exactly once (so a recovered retry of the same
  step/slot is clean, keeping the post-recovery stream deterministic):

    preemption   — raises :class:`SimulatedPreemption` at step start
                   (crash/SIGTERM; recovery = restore latest checkpoint);
    pipeline     — raises :class:`PipelineFault` inside a pipeline worker
                   building the scheduled slot (recovery = rebuild the
                   pipeline at the current step; the stream is a pure
                   function of the step index so the retry is identical);
    ckpt-write   — raises :class:`CheckpointWriteFault` mid-save, between
                   leaf writes (recovery = none needed: the atomic tmp-dir
                   protocol leaves the previous checkpoint intact);
    nan-batch    — poisons the scheduled step's batch with NaN edge
                   weights, driving loss and gradients NaN (recovery =
                   the HealthGuard policy above). Only ``edge_w`` is
                   poisoned, as in the reference: the ELL adjacency keeps
                   its own weights, so on ``backend="ell"|"ti"`` only
                   GraphSAGE (whose degree reads ``edge_w``) diverges.

Both classes are host-side Python. The one device operation is
``HealthGuard.check_store``: one reduction over the store and one sync.
Cheap recovery is sound because store staleness bias decays geometrically
(Thm 2; also the follow-up arXiv 2303.11081) — rolling back or even
resetting the store costs only a transient bias spike.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

# One shared ρ-budget definition (core/methods.py, next to MBMethod) so the
# training tier's enforcement here and the serving tier's degradation policy
# (serve/policy.py) cannot drift apart. Re-exported for callers that
# configure HealthConfig.rho_budget.
from repro_torch.core.methods import RHO_BUDGET_DEFAULT

__all__ = [
    "RHO_BUDGET_DEFAULT", "SimulatedPreemption", "PipelineFault",
    "CheckpointWriteFault", "TrainingDivergedError", "StalenessBudgetError",
    "ServeWorkerFault", "FaultPlan", "FailureInjector", "HealthConfig",
    "HealthGuard",
]


# ----------------------------------------------------------------- fault types
class SimulatedPreemption(RuntimeError):
    """Injected crash/preemption (the old FailureInjector's fault class)."""


class PipelineFault(RuntimeError):
    """Injected batch-pipeline worker crash (fires while building a slot)."""


class CheckpointWriteFault(OSError):
    """Injected checkpoint-write failure (fires mid-save, between leaves)."""


class TrainingDivergedError(RuntimeError):
    """Recovery budget (``max_retries``) exhausted without a healthy step."""


class StalenessBudgetError(RuntimeError):
    """Strict ρ-budget enforcement: halo staleness exceeded ``rho_budget``."""


class ServeWorkerFault(RuntimeError):
    """Injected serving-worker crash (fires inside a batch execution)."""


# ------------------------------------------------------------------ FaultPlan
class FaultPlan:
    """Deterministic, one-shot schedule of injected faults (tests/drills).

    Each fault is keyed by (kind, index) and fires at most once: after the
    trainer recovers and retries the same step/slot, the retry runs clean,
    which is what makes every fault class resumable to a stream-identical
    run. Thread-safe — ``pipeline`` faults fire on pipeline worker threads
    and ``ckpt-write`` faults may fire on the background checkpoint writer.
    """

    def __init__(self, *, preempt_at: tuple = (), pipeline_at: tuple = (),
                 ckpt_write_at: tuple = (), nan_batch_at: tuple = (),
                 serve_slow_at: tuple = (), serve_poison_at: tuple = (),
                 serve_crash_at: tuple = (), serve_burst_at: tuple = (),
                 serve_slow_s: float = 0.25, serve_burst_n: int = 32):
        """Schedule faults by global step index (``pipeline_at``: by slot;
        ``serve_*_at``: by the server's batch sequence number, except
        ``serve_burst_at`` which is keyed by the load generator's request
        index).

        Args:
            preempt_at: steps at which a SimulatedPreemption is raised.
            pipeline_at: schedule *slots* whose worker build raises
                PipelineFault (slot == step when ``recycle == 1``).
            ckpt_write_at: steps whose checkpoint save fails mid-write.
            nan_batch_at: steps whose batch is poisoned with NaN weights.
            serve_slow_at: serving batches stalled for ``serve_slow_s``
                before execution (hung-batch drill; recovery = per-request
                deadlines turn the stall into typed timeout responses).
            serve_poison_at: serving batches whose historical-store halo
                rows are NaN-poisoned right before the batch reads them
                (recovery = crc/NaN detection degrades to the ti path and
                repairs the rows).
            serve_crash_at: serving batches whose execution raises
                :class:`ServeWorkerFault` (recovery = bounded in-place
                retry, the serving analogue of a worker respawn).
            serve_burst_at: request indices at which the *load generator*
                should inject a burst of ``serve_burst_n`` extra requests
                (queue-overflow drill; recovery = typed Overloaded
                load-shedding, never unbounded blocking).
            serve_slow_s: stall duration for ``serve_slow_at`` batches.
            serve_burst_n: burst size for ``serve_burst_at`` indices.
        """
        self._at = {"preempt": set(preempt_at), "pipeline": set(pipeline_at),
                    "ckpt": set(ckpt_write_at), "nan": set(nan_batch_at),
                    "serve-slow": set(serve_slow_at),
                    "serve-poison": set(serve_poison_at),
                    "serve-crash": set(serve_crash_at),
                    "serve-burst": set(serve_burst_at)}
        self.serve_slow_s = float(serve_slow_s)
        self.serve_burst_n = int(serve_burst_n)
        self.fired: set = set()
        self._lock = threading.Lock()

    def _fire(self, kind: str, key: int) -> bool:
        """Check-and-mark: True exactly once per scheduled (kind, key)."""
        with self._lock:
            if key in self._at[kind] and (kind, key) not in self.fired:
                self.fired.add((kind, key))
                return True
        return False

    # ------------------------------------------------------------ injection
    def maybe_fail(self, step: int) -> None:
        """Raise SimulatedPreemption if one is scheduled for ``step``."""
        if self._fire("preempt", step):
            raise SimulatedPreemption(f"simulated preemption at step {step}")

    def pipeline_hook(self, slot: int) -> None:
        """Worker-side build hook: raise PipelineFault at a scheduled slot."""
        if self._fire("pipeline", slot):
            raise PipelineFault(f"injected pipeline-worker crash at slot {slot}")

    def ckpt_hook(self, step: int, phase: str) -> None:
        """CheckpointManager write hook: fail a scheduled step's save.

        ``phase`` is ``"leaf_<i>"`` before each leaf write or ``"manifest"``
        before publication; the injection fires once partway through the
        leaf writes so the tmp dir is non-trivially populated when it dies.
        """
        if phase.startswith("leaf_") and phase != "leaf_0":
            if self._fire("ckpt", step):
                raise CheckpointWriteFault(
                    f"injected checkpoint-write failure at step {step} "
                    f"({phase})")

    def corrupt_batch(self, step: int, batch):
        """Return ``batch`` poisoned with NaN edge weights at a scheduled
        step (loss and gradients go NaN downstream), else unchanged."""
        if self._fire("nan", step):
            return batch._replace(edge_w=batch.edge_w * float("nan"))
        return batch

    # ------------------------------------------------- serving fault classes
    def serve_delay(self, seq: int) -> float:
        """Stall duration (s) for serving batch ``seq`` (0.0 = no fault).

        The server sleeps this long before executing the batch — the
        slow/hung-batch drill. Per-request deadlines must convert the stall
        into typed timeout responses, never a hang.
        """
        return self.serve_slow_s if self._fire("serve-slow", seq) else 0.0

    def serve_poison(self, seq: int) -> bool:
        """Whether serving batch ``seq``'s store halo rows get NaN-poisoned.

        The server owns the store, so it applies the poison itself (the plan
        only schedules it); crc verification or the NaN circuit breaker must
        then degrade the batch to the store-free ti path and repair the rows.
        """
        return self._fire("serve-poison", seq)

    def serve_crash_hook(self, seq: int) -> None:
        """Raise :class:`ServeWorkerFault` inside serving batch ``seq``'s
        execution (worker-crash drill; recovery = bounded in-place retry)."""
        if self._fire("serve-crash", seq):
            raise ServeWorkerFault(
                f"injected serving-worker crash at batch {seq}")

    def serve_burst(self, request_idx: int) -> int:
        """Extra requests the load generator should inject at ``request_idx``
        (queue-overflow drill), or 0. The admission queue must shed the
        overflow with typed Overloaded responses."""
        return self.serve_burst_n if self._fire("serve-burst", request_idx) \
            else 0


class FailureInjector(FaultPlan):
    """Back-compat shim: the original preemption-only injector."""

    def __init__(self, fail_at_steps: tuple = ()):
        """Schedule preemptions at the given global step indices."""
        super().__init__(preempt_at=fail_at_steps)


# ---------------------------------------------------------------- HealthGuard
@dataclass
class HealthConfig:
    """Knobs for :class:`HealthGuard` + the trainer's recovery policy.

    Attributes:
        policy: recovery action on a divergent step — ``"rollback"``
            (restore the newest verifiable checkpoint, bounded by the
            trainer's ``max_retries``, optionally backing off the lr) or
            ``"skip-batch"`` (drop the poisoned update and move on).
        spike_factor: a step whose loss exceeds ``spike_factor`` × the
            rolling-median baseline is flagged as a divergence anomaly.
        window: rolling-baseline length (recent accepted-step losses).
        warmup: accepted steps before spike detection arms (the baseline
            median is meaningless while the window is nearly empty).
        lr_backoff: multiply the trainer's lr by this on every rollback
            (1.0 = keep lr; rollback then replays an identical stream).
        grad_norm_limit: optional hard bound on the clipped global grad
            norm (NaN/Inf is always flagged; this catches finite blowups).
        store_check_every: sweep the historical store for NaN/Inf every k
            accepted steps (0 disables; one device reduction and one
            sync per sweep).
        rho_budget: max tolerated staleness (in steps) of any historical
            row *read* this step (the batch's halo rows — exactly the rows
            whose staleness drives Thm 2's bias term). ``None`` records
            the counters without enforcing a bound; the standard budget is
            :data:`repro_torch.core.methods.RHO_BUDGET_DEFAULT`, the one shared
            definition the serving tier's degradation policy also reads.
        rho_strict: raise :class:`StalenessBudgetError` on a budget
            violation instead of recording a history event.
    """

    policy: str = "rollback"
    spike_factor: float = 25.0
    window: int = 64
    warmup: int = 16
    lr_backoff: float = 1.0
    grad_norm_limit: Optional[float] = None
    store_check_every: int = 25
    rho_budget: Optional[int] = None
    rho_strict: bool = False

    def validate(self) -> None:
        """Fail fast on out-of-range knobs."""
        if self.policy not in ("rollback", "skip-batch"):
            raise ValueError(f"unknown health policy {self.policy!r}")
        if self.spike_factor <= 1.0:
            raise ValueError("spike_factor must be > 1")
        if not 0.0 < self.lr_backoff <= 1.0:
            raise ValueError("lr_backoff must be in (0, 1]")


class HealthGuard:
    """Per-step numerical-health checks + per-layer store-staleness counters.

    Pure detector: ``check_step`` / ``check_store`` return a reason string
    (or None) and mutate nothing but the guard's own counters; the trainer
    decides what to do. Counters are host-side numpy — ``staleness[l, i]``
    is the number of accepted steps since store row (layer l, node i) was
    last rewritten, so ``staleness.max()`` is the realized ρ of Thm 2's
    bias bound and skip-store straggler steps / recycling show up directly.
    """

    def __init__(self, config: HealthConfig, num_layers: int, num_nodes: int):
        """Allocate the rolling loss baseline and (L, n) staleness counters."""
        config.validate()
        self.config = config
        self.losses: deque = deque(maxlen=config.window)
        self.staleness = np.zeros((num_layers, num_nodes), np.int32)
        self.num_incidents = 0   # divergent steps detected (for reporting)

    # ------------------------------------------------------------- detection
    def check_step(self, loss: float, grad_norm: float) -> Optional[str]:
        """NaN/Inf + loss-spike check for one step; reason or None.

        Call *before* applying the update, with the candidate step's host
        loss/grad-norm floats (the trainer already pays these syncs for its
        history record, so the check adds no extra device round-trip).
        """
        cfg = self.config
        if not math.isfinite(loss):
            self.num_incidents += 1
            return f"non-finite loss ({loss})"
        if not math.isfinite(grad_norm):
            self.num_incidents += 1
            return f"non-finite grad norm ({grad_norm})"
        if cfg.grad_norm_limit is not None and grad_norm > cfg.grad_norm_limit:
            self.num_incidents += 1
            return (f"grad norm {grad_norm:.3g} exceeds limit "
                    f"{cfg.grad_norm_limit:.3g}")
        if len(self.losses) >= self.config.warmup:
            base = float(np.median(self.losses))
            if loss > cfg.spike_factor * max(base, 1e-12):
                self.num_incidents += 1
                return (f"loss spike {loss:.4g} > {cfg.spike_factor:g}x "
                        f"rolling median {base:.4g}")
        return None

    def check_store(self, store, batch=None, rows=None) -> Optional[str]:
        """NaN/Inf sweep over the historical store (one device reduction,
        one sync).

        The trainer writes a step's rows only after this gate, so with
        ``batch`` and ``rows`` (a train step's ``HistoricalState`` of batch
        rows) it checks the store *as it would be with those rows written*,
        the reference's post-update store: a non-finite store row that the
        batch overwrites passes, a non-finite returned row fails. Padded
        rows (mask 0) are dropped, as ``commit_rows`` drops them.
        """
        flags = []
        for buf, new in ((store.h, None if rows is None else rows.h),
                         (store.v, None if rows is None else rows.v)):
            if buf is None:
                flags.append(torch.ones((), dtype=torch.bool,
                                        device=store.h[0].device))
                continue
            ok = []
            for l in range(len(buf)):
                row_ok = torch.isfinite(buf[l]).all(dim=-1)      # (n,)
                if new is not None and l < len(new):
                    # padded rows go to a spare entry n, as True: no
                    # boolean indexing, so no sync before the one below
                    n = row_ok.shape[0]
                    gids = batch.batch_gids.long()
                    keep = (batch.batch_mask > 0) & (gids >= 0) & (gids < n)
                    row_ok = torch.cat([row_ok, row_ok.new_ones(1)])
                    row_ok[torch.where(keep, gids, n)] = (
                        torch.isfinite(new[l]).all(dim=-1) | ~keep)
                ok.append(row_ok.all())
            flags.append(torch.stack(ok).all())
        h_ok, v_ok = torch.stack(flags).tolist()
        if not h_ok:
            self.num_incidents += 1
            return "non-finite values in historical embedding store (h)"
        if not v_ok:
            self.num_incidents += 1
            return "non-finite values in historical auxiliary store (v)"
        return None

    def store_check_due(self, step: int) -> bool:
        """Whether the periodic store sweep fires on this step index."""
        k = self.config.store_check_every
        return bool(k) and step % k == 0

    # ------------------------------------------------------------- baseline
    def observe(self, loss: float) -> None:
        """Push an *accepted* step's loss into the rolling baseline.

        Rejected (divergent) losses must never enter the window — a NaN or
        spike would poison the median the next checks compare against.
        """
        self.losses.append(float(loss))

    # ------------------------------------------------------------ staleness
    def halo_staleness(self, halo_gids: np.ndarray,
                       halo_mask: np.ndarray) -> int:
        """Max staleness (steps) over the historical rows read this step.

        These are the batch's (masked) halo rows — the rows whose age feeds
        Thm 2's ρ bias term — so this is the quantity ``rho_budget`` bounds.
        """
        gids = np.asarray(halo_gids)[np.asarray(halo_mask) > 0]
        if gids.size == 0:
            return 0
        return int(self.staleness[:, gids].max())

    def tick(self, batch_gids: np.ndarray, batch_mask: np.ndarray,
             store_updated: bool) -> None:
        """Advance the counters for one accepted step.

        Every row ages one step; the batch rows reset to zero iff the step's
        store update was applied (a skip-store straggler step ages them
        instead — exactly the extra staleness the Thm-2 budget must absorb).
        """
        self.staleness += 1
        if store_updated:
            gids = np.asarray(batch_gids)[np.asarray(batch_mask) > 0]
            self.staleness[:, gids] = 0

    def check_rho_budget(self, halo_staleness: int) -> Optional[str]:
        """Enforce ``rho_budget`` against this step's realized halo
        staleness; returns the violation reason (or raises when strict)."""
        budget = self.config.rho_budget
        if budget is None or halo_staleness <= budget:
            return None
        msg = (f"store staleness {halo_staleness} exceeds the rho budget "
               f"{budget} (Thm 2)")
        if self.config.rho_strict:
            raise StalenessBudgetError(msg)
        return msg

    def reset_staleness(self) -> None:
        """Zero the counters (store reinit / elastic rescale / restore)."""
        self.staleness[:] = 0
