"""Serving degradation policy: when to stop trusting the historical store.

The degradation ladder (DESIGN.md §12) has exactly two rungs:

  exact — halo rows gathered from the historical store; with an exact store
          this answers identically to the full-graph forward.
  ti    — the store-free message-invariance estimate (DESIGN.md §11);
          bounded bias, zero store reads, immune to store corruption.

Three independent detectors can drop a batch one rung, checked in order:

  1. :class:`CircuitBreaker` — trips open on NaN/Inf *output* of the exact
     path, serves ti-only for a cooldown, then probes exact again and closes
     after ``heal_after`` consecutive clean probes.
  2. ρ-staleness — per-row store-staleness counters (the same
     ``HealthGuard.staleness`` accounting the trainer uses) against the one
     shared budget ``repro_torch.core.methods.RHO_BUDGET_DEFAULT``; rows past the
     budget are outside Thm 2's bias bound and cannot be served as "exact".
  3. :class:`StoreIntegrity` — per-row crc32 ledger in the checkpoint
     manifest idiom (``repro_torch.checkpoint.crc32_array``); a cached row whose
     bytes changed without a recorded refresh is corrupt.

Detection is separated from recovery: the policy only *decides*; the server
answers from ti and schedules the offending rows for repair (a store-free
recompute that overwrites them).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.checkpoint import crc32_array
from repro_torch.core.methods import RHO_BUDGET_DEFAULT

MODE_EXACT = "exact"
MODE_TI = "ti"


@dataclasses.dataclass
class ServeConfig:
    """Knobs for :class:`repro_torch.serve.GNNServer`.

    Attributes:
        buckets: target-count pad buckets; each is one fixed batch shape.
        queue_depth: admission-queue bound; a full queue sheds with a typed
            Overloaded response instead of blocking the caller.
        batch_window_s: how long the batcher waits to coalesce queued
            requests into one bucket batch (0 = no coalescing delay).
        default_deadline_s: per-request deadline when the request names none.
        max_attempts: bounded retry budget per batch for transient failures
            (worker crash, unexpected exceptions).
        backoff_s: sleep between retry attempts.
        rho_budget: staleness budget (steps) for store rows read by the
            exact path — the shared Thm-2 constant from core/methods.py.
        verify_rows: crc-verify the store rows a batch is about to read
            (detection rung 3); disable to lean on the NaN breaker only.
        repair: recompute over-budget/corrupt rows via the store-free path
            and write them back (heals the store instead of degrading
            forever).
        breaker_heal_after: consecutive clean exact probes that close a
            tripped circuit breaker.
        breaker_cooldown: batches served ti-only before the first probe.
        backend: aggregation backend for the serving forward ("segment" |
            "ell" — the bucketed CUDA ELL SpMM); degradation swaps the
            *compensation*, never the aggregation, so both modes share the
            batch shape.
        stream: kernel variant of ``backend="ell"``: ``None``/``True`` run
            the streaming kernels; ``False`` runs the resident-source
            kernels, which stage the whole gather source (the batch's rows,
            or the store for the compensation) in shared memory and so serve
            graphs under ~14.5k gathered rows only (else ``ValueError``).
        ti_fwd_mode: Eq.-9 mode of the degraded path ("lmc" blends the α
            estimate with β·fresh; "historical" serves
            the raw α ⊙ fresh invariance transform).
        force_mode: pin every batch to one rung ("exact" | "ti"); bench and
            debugging only — bypasses all three detectors.
        return_logits: attach raw logits to responses (off: argmax only).
        ell_buckets: row-capacity buckets of the ELL layout (backend="ell").
        warmup: build the CUDA kernels and run every (bucket, mode) pair once
            at server start, so no request pays the kernel build or lazy
            CUDA initialisation (servers that care about p99 want it,
            throwaway test servers don't).
    """

    buckets: tuple = (8, 32, 128)
    queue_depth: int = 64
    batch_window_s: float = 0.002
    default_deadline_s: float = 2.0
    max_attempts: int = 2
    backoff_s: float = 0.02
    rho_budget: int = RHO_BUDGET_DEFAULT
    verify_rows: bool = True
    repair: bool = True
    breaker_heal_after: int = 3
    breaker_cooldown: int = 2
    backend: str = "segment"
    stream: Optional[bool] = None
    ti_fwd_mode: str = "lmc"
    force_mode: Optional[str] = None
    return_logits: bool = False
    ell_buckets: tuple = (8, 32, 128)
    warmup: bool = False

    def validate(self) -> None:
        """Fail fast on out-of-range knobs."""
        if not self.buckets or list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"buckets must be sorted unique: {self.buckets}")
        if self.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backend not in ("segment", "ell"):
            raise ValueError(f"unknown serving backend {self.backend!r}")
        if self.ti_fwd_mode not in ("lmc", "historical"):
            raise ValueError(f"unknown ti_fwd_mode {self.ti_fwd_mode!r}")
        if self.force_mode not in (None, MODE_EXACT, MODE_TI):
            raise ValueError(f"unknown force_mode {self.force_mode!r}")
        if self.rho_budget < 1:
            raise ValueError("rho_budget must be >= 1")


class CircuitBreaker:
    """NaN/Inf-output circuit breaker over the exact serving path.

    closed --(non-finite exact output)--> open --(cooldown batches)-->
    half-open --(heal_after clean probes)--> closed; any failure while
    probing re-opens. State transitions are driven by the server's batch
    sequence numbers, so "cooldown" is measured in served batches.
    """

    def __init__(self, heal_after: int = 3, cooldown: int = 2):
        self.heal_after = int(heal_after)
        self.cooldown = int(cooldown)
        self._state = "closed"
        self._opened_at = -1
        self._clean = 0

    @property
    def state(self) -> str:
        """"closed" | "open" | "half-open"."""
        return self._state

    def allow_exact(self, seq: int) -> bool:
        """Whether batch ``seq`` may try the exact path (probes included)."""
        if self._state == "closed":
            return True
        if seq - self._opened_at <= self.cooldown:
            return False
        self._state = "half-open"
        return True

    def record_failure(self, seq: int) -> None:
        """Exact path produced non-finite output at batch ``seq``: trip."""
        self._state = "open"
        self._opened_at = seq
        self._clean = 0

    def record_success(self) -> None:
        """A clean exact batch; closes the breaker after ``heal_after``
        consecutive clean probes."""
        if self._state == "half-open":
            self._clean += 1
            if self._clean >= self.heal_after:
                self._state = "closed"
                self._clean = 0


class StoreIntegrity:
    """Per-row crc32 ledger over the serving store's embedding cache.

    The checkpoint manifest idiom (checkpoint/manager.py) applied at row
    granularity: every legitimate write records ``crc32_array`` of the row's
    bytes, and ``verify`` flags rows whose bytes no longer match — bitrot or
    out-of-band writes the serving tier must not trust.
    """

    def __init__(self, num_layers: int, num_nodes: int):
        self._crc = np.zeros((num_layers, num_nodes), dtype=np.uint32)

    def record(self, gids: np.ndarray, rows: np.ndarray) -> None:
        """Record crcs for store rows: ``rows[l, j]`` is (layer l, gids[j])."""
        gids = np.asarray(gids)
        for l in range(rows.shape[0]):
            for j, g in enumerate(gids):
                self._crc[l, g] = crc32_array(rows[l, j])

    def verify(self, gids: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Gids (subset of ``gids``) whose current bytes mismatch the ledger."""
        gids = np.asarray(gids)
        bad = np.zeros(gids.shape[0], dtype=bool)
        for l in range(rows.shape[0]):
            for j, g in enumerate(gids):
                if self._crc[l, g] != crc32_array(rows[l, j]):
                    bad[j] = True
        return gids[bad]


class DegradationPolicy:
    """Per-batch mode decision: exact unless a detector says otherwise.

    Returns ``(mode, reason, bad_gids)`` where ``bad_gids`` (possibly empty)
    are the store rows to schedule for repair. Pure decision logic — the
    server owns all mutation (store commits, repairs, breaker bookkeeping).
    """

    def __init__(self, config: ServeConfig, guard, integrity: StoreIntegrity,
                 breaker: CircuitBreaker):
        self.config = config
        self.guard = guard          # HealthGuard: shares trainer accounting
        self.integrity = integrity
        self.breaker = breaker

    def decide(self, seq: int, halo_gids: np.ndarray, halo_mask: np.ndarray,
               store_rows: Optional[np.ndarray]
               ) -> tuple[str, Optional[str], np.ndarray]:
        """Pick the rung for batch ``seq`` reading the given store rows.

        ``store_rows`` is the host copy of ``store.h[:, halo_gids]`` (None
        skips the crc/finite checks, e.g. when ``verify_rows`` is off).
        """
        cfg = self.config
        none = np.zeros(0, dtype=np.int64)
        if cfg.force_mode is not None:
            return cfg.force_mode, "forced", none
        if not self.breaker.allow_exact(seq):
            return MODE_TI, "nan-circuit-open", none
        gids = np.asarray(halo_gids)[np.asarray(halo_mask) > 0]
        if gids.size == 0:
            return MODE_EXACT, None, none
        stale = self.guard.staleness[:, gids].max(axis=0) > cfg.rho_budget
        if stale.any():
            worst = int(self.guard.staleness[:, gids].max())
            return (MODE_TI,
                    f"staleness {worst} > rho budget {cfg.rho_budget}",
                    gids[stale].astype(np.int64))
        if cfg.verify_rows and store_rows is not None:
            k = gids.size
            corrupt = self.integrity.verify(gids, store_rows[:, :k])
            if corrupt.size:
                return (MODE_TI, f"store-corrupt ({corrupt.size} rows)",
                        corrupt.astype(np.int64))
        return MODE_EXACT, None, none
