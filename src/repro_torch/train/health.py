"""Store-staleness counters + serving fault injection (DESIGN.md §10).

LMC's convergence guarantee (Thm 2) only holds while the historical-store
staleness stays within the ρ-budget the theorem's geometric bias term
assumes. The serving half of the reference module lives here:

* :class:`HealthGuard` — per-layer store-staleness counters, so the
  ρ-budget is an enforced invariant rather than a docstring comment. The
  serving tier's degradation policy reads them.

* :class:`FaultPlan` — the server-side fault classes of the layered
  fault-injection framework (slow batch, store poison, worker crash), each
  firing exactly once.

The training half (numerical-health checks, loss-spike baseline, the
staleness tick and strict ρ check, the preemption / pipeline /
checkpoint-write / NaN-batch faults) comes with the training step, and the
client-side burst drill with a serving benchmark. Everything here is
host-side numpy.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np

# One shared ρ-budget definition (core/methods.py, next to MBMethod) so the
# training tier's enforcement here and the serving tier's degradation policy
# (serve/policy.py) cannot drift apart. Re-exported for callers that
# configure HealthConfig.rho_budget.
from repro_torch.core.methods import RHO_BUDGET_DEFAULT

__all__ = [
    "RHO_BUDGET_DEFAULT", "ServeWorkerFault", "FaultPlan", "HealthConfig",
    "HealthGuard",
]


class ServeWorkerFault(RuntimeError):
    """Injected serving-worker crash (fires inside a batch execution)."""


# ------------------------------------------------------------------ FaultPlan
class FaultPlan:
    """Deterministic, one-shot schedule of injected serving faults.

    Each fault is keyed by (kind, index) and fires at most once, so a retry
    of the same batch runs clean. Thread-safe.
    """

    def __init__(self, *, serve_slow_at: tuple = (),
                 serve_poison_at: tuple = (), serve_crash_at: tuple = (),
                 serve_slow_s: float = 0.25):
        """Schedule faults by the server's batch sequence number.

        Args:
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
            serve_slow_s: stall duration for ``serve_slow_at`` batches.
        """
        self._at = {"serve-slow": set(serve_slow_at),
                    "serve-poison": set(serve_poison_at),
                    "serve-crash": set(serve_crash_at)}
        self.serve_slow_s = float(serve_slow_s)
        self.fired: set = set()
        self._lock = threading.Lock()

    def _fire(self, kind: str, key: int) -> bool:
        """Check-and-mark: True exactly once per scheduled (kind, key)."""
        with self._lock:
            if key in self._at[kind] and (kind, key) not in self.fired:
                self.fired.add((kind, key))
                return True
        return False

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


# ---------------------------------------------------------------- HealthGuard
@dataclass
class HealthConfig:
    """Knobs for :class:`HealthGuard`.

    Attributes:
        rho_budget: max tolerated staleness (in steps) of any historical
            row *read* this step (the batch's halo rows — exactly the rows
            whose staleness drives Thm 2's bias term). ``None`` records
            the counters without enforcing a bound; the standard budget is
            :data:`repro_torch.core.methods.RHO_BUDGET_DEFAULT`, the one shared
            definition the serving tier's degradation policy also reads.
    """

    rho_budget: Optional[int] = None


class HealthGuard:
    """Per-layer store-staleness counters.

    Counters are host-side numpy — ``staleness[l, i]`` is the number of
    accepted steps since store row (layer l, node i) was last rewritten, so
    ``staleness.max()`` is the realized ρ of Thm 2's bias bound.
    """

    def __init__(self, config: HealthConfig, num_layers: int, num_nodes: int):
        """Allocate the (L, n) staleness counters."""
        self.config = config
        self.staleness = np.zeros((num_layers, num_nodes), np.int32)
