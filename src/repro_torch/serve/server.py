"""GNNServer: batched, fault-tolerant inference over the historical store.

The serving insight (DESIGN.md §12): LMC's historical store is a full-graph
embedding cache, so answering "classify nodes T" does not need T's exponential
receptive field — gather the cached layer values for T's 1-hop halo, run only
the mini-batch forward (``core.lmc.make_infer_step``), and refresh the touched
rows. With an exact store the answer *equals* the full-graph forward (to
float rounding).

One worker thread owns the store and drains a bounded admission queue;
requests are coalesced for ``batch_window_s`` and padded into one of a few
fixed-shape buckets (gateway.py). The robustness ladder around that hot
path:

  admission   — ``queue.Queue(maxsize=queue_depth)`` + ``put_nowait``: a full
                queue sheds with a typed Overloaded response, never blocks;
  deadlines   — per-request budgets checked before, during (injected stalls)
                and after execution → typed timeout responses;
  degradation — policy.py decides exact vs store-free ti per batch (breaker,
                ρ-staleness vs the shared Thm-2 budget, per-row crc32);
  breaker     — non-finite exact output trips to ti-only, heals after N clean
                probes (policy.CircuitBreaker);
  repair      — offending rows are recomputed store-free and written back,
                so degradation is transient, not sticky;
  retry       — transient execution failures (injected worker crashes) get
                ``max_attempts`` in-place retries with backoff;
  drain       — close() stops admission, completes everything in flight, and
                resolves any racing submissions with a typed closed response:
                every accepted future is always resolved.

Everything here is host-side threading; the device work is the infer steps,
which run on ``device`` (the CUDA card unless the caller passes "cpu"; with
``backend="ell"`` they launch the CUDA SpMM and compensation kernels). A step
returns the rows it would refresh instead of writing them, and the worker
commits them in place under ``_mu`` only once the batch's output is finite,
so a discarded batch writes nothing. FaultPlan (train/health.py) injects the
serving fault classes.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core.exact import (FullGraphData, exact_layer_values,
                                    from_graph)
from repro_torch.core.history import HistoricalState
from repro_torch.core.lmc import commit_rows, make_infer_step
from repro_torch.device import resolve_device
from repro_torch.graph.structure import Graph
from repro_torch.kernels import build_kernels
from repro_torch.models.gnn import GNN
from repro_torch.serve.gateway import StoreGateway
from repro_torch.serve.policy import (MODE_EXACT, MODE_TI, CircuitBreaker,
                                      DegradationPolicy, ServeConfig,
                                      StoreIntegrity)
from repro_torch.serve.types import (STATUS_CLOSED, STATUS_DEGRADED,
                                     STATUS_ERROR, STATUS_OK,
                                     STATUS_OVERLOADED, STATUS_TIMEOUT,
                                     STATUS_TOO_LARGE, ServeResponse)
from repro_torch.train.health import (FaultPlan, HealthConfig, HealthGuard,
                                      ServeWorkerFault)

_POLL_S = 0.02   # worker idle poll; get() returns immediately on arrival


class _NonFinite(Exception):
    """Internal: batch output contained NaN/Inf (circuit-breaker trigger)."""


@dataclass
class _Pending:
    """An admitted request riding through the worker."""

    nodes: np.ndarray
    request_id: str
    deadline: Optional[float]      # absolute time.time() bound, or None
    t_submit: float
    future: Future = field(default_factory=Future)


def _params_to(params, device):
    """The nested parameter dict with every tensor detached on ``device``."""
    if isinstance(params, dict):
        return {k: _params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [_params_to(v, device) for v in params]
    return params.detach().to(device)


def warm_store(gnn: GNN, params: dict, data: FullGraphData,
               device=None) -> HistoricalState:
    """Exact-layer-value store (core/exact.py): the healthy serving state.

    ``store.h[l]`` holds the exact output of layer ``l`` for every node, so
    the exact serving path reproduces the full-graph forward. ``v`` (backward
    aux) is unused by inference and not allocated. Built on ``device``
    (None: the card), where ``params`` and ``data`` are moved first.
    """
    dev = resolve_device(device)
    hs, _ = exact_layer_values(gnn, _params_to(params, dev), data.to(dev))
    return HistoricalState(h=torch.stack(hs))


class GNNServer:
    """Batched GNN inference server over the LMC historical store."""

    def __init__(self, gnn: GNN, graph: Graph, params: dict, *,
                 store: Optional[HistoricalState] = None,
                 config: Optional[ServeConfig] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 data: Optional[FullGraphData] = None, device=None):
        """Start the server (one worker thread; returns ready to accept).

        Runs on ``device`` (None: the CUDA card; raises if there is none).
        ``store=None`` warms an exact store from ``params`` (one full-graph
        forward). ``data`` may share a prebuilt FullGraphData; ``data`` and
        ``store`` must already live on ``device``. The server serves from
        ``store`` and updates it in place.
        """
        self.device = resolve_device(device)
        self.config = config or ServeConfig()
        self.config.validate()
        self.gnn, self.graph = gnn, graph
        self.params = _params_to(params, self.device)
        self.fault_plan = fault_plan
        self.data = data if data is not None \
            else from_graph(graph, device=self.device)
        self._x, self._self_w = self.data.x, self.data.self_w
        n, L = graph.num_nodes, gnn.num_layers
        self._store = store if store is not None \
            else warm_store(gnn, self.params, self.data, device=self.device)

        cfg = self.config
        self.gateway = StoreGateway(graph, buckets=cfg.buckets,
                                    agg_backend=cfg.backend,
                                    ell_buckets=cfg.ell_buckets)
        self._guard = HealthGuard(HealthConfig(rho_budget=cfg.rho_budget),
                                  L, n)
        self._integrity = StoreIntegrity(L, n)
        self._integrity.record(np.arange(n), self._store.h.cpu().numpy())
        self._breaker = CircuitBreaker(heal_after=cfg.breaker_heal_after,
                                       cooldown=cfg.breaker_cooldown)
        self._policy = DegradationPolicy(cfg, self._guard, self._integrity,
                                         self._breaker)
        self._steps = {
            MODE_EXACT: make_infer_step(
                gnn, n, backend=cfg.backend, fwd_mode="historical",
                compensation="store", refresh=True, stream=cfg.stream),
            MODE_TI: make_infer_step(
                gnn, n, backend=cfg.backend, fwd_mode=cfg.ti_fwd_mode,
                compensation="ti", refresh=False, stream=cfg.stream),
            "repair": make_infer_step(
                gnn, n, backend=cfg.backend, fwd_mode=cfg.ti_fwd_mode,
                compensation="ti", refresh=True, stream=cfg.stream),
        }

        if cfg.warmup:
            self.warm_traces()

        self._q: queue.Queue = queue.Queue(maxsize=cfg.queue_depth)
        self._carry: Optional[_Pending] = None
        self._closing = threading.Event()
        self._abort = threading.Event()
        self._mu = threading.Lock()        # store/staleness/integrity commits
        self._stat_mu = threading.Lock()   # counters (worker + submitters)
        self._counts: dict = {}
        self._seq = 0
        self.events: list = []
        self._worker = threading.Thread(target=self._worker_main,
                                        name="gnn-serve-worker", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- client API
    def submit(self, nodes, *, deadline_s: Optional[float] = None,
               request_id: str = "") -> Future:
        """Enqueue a request; returns a Future[ServeResponse].

        Never blocks and never raises: admission failures (queue full,
        oversized or malformed request, closing server) resolve the future
        immediately with the matching typed status.
        """
        now = time.time()
        budget = self.config.default_deadline_s if deadline_s is None \
            else deadline_s
        nodes = np.atleast_1d(np.asarray(nodes, dtype=np.int64))
        p = _Pending(nodes=nodes, request_id=request_id,
                     deadline=now + budget, t_submit=now)
        self._count("submitted")
        if self._closing.is_set():
            self._finish(p, STATUS_CLOSED, detail="server is shutting down")
        elif nodes.ndim != 1 or nodes.size == 0 \
                or nodes.min() < 0 or nodes.max() >= self.graph.num_nodes:
            self._finish(p, STATUS_ERROR,
                         detail="nodes must be a non-empty 1-d array of "
                                "in-range node ids")
        elif np.unique(nodes).size > self.gateway.max_targets:
            self._finish(p, STATUS_TOO_LARGE,
                         detail=f"{np.unique(nodes).size} targets > largest "
                                f"bucket {self.gateway.max_targets}")
        else:
            try:
                self._q.put_nowait(p)
            except queue.Full:
                self._count("shed")
                self._finish(p, STATUS_OVERLOADED,
                             detail=f"admission queue full "
                                    f"(depth {self.config.queue_depth})")
        return p.future

    def infer(self, nodes, *, deadline_s: Optional[float] = None,
              request_id: str = "") -> ServeResponse:
        """Synchronous submit+wait. Bounded: even a wedged worker yields a
        typed timeout response rather than a hang."""
        fut = self.submit(nodes, deadline_s=deadline_s,
                          request_id=request_id)
        budget = self.config.default_deadline_s if deadline_s is None \
            else deadline_s
        try:
            return fut.result(timeout=budget + 30.0)
        except FutureTimeout:
            return ServeResponse(request_id=request_id, status=STATUS_TIMEOUT,
                                 detail="no response within the hard bound")

    def warm_traces(self) -> None:
        """Build the kernels and run every (bucket, mode) once, so requests
        never pay the kernel build or lazy CUDA initialisation.

        Runs one dummy batch per bucket through the exact/ti/repair steps
        and discards the outputs — the store, integrity ledger and counters
        are untouched.
        """
        if self.device.type == "cuda" and self.config.backend == "ell":
            build_kernels()
        n = self.graph.num_nodes
        for b in self.gateway.buckets:
            targets = np.arange(min(b, n), dtype=np.int64)
            _, hb = self.gateway.build(targets)
            batch = hb.to(self.device)
            for step in self._steps.values():
                out, _ = step(self.params, self._store, batch,
                              self._x, self._self_w)
                out.cpu()

    def notify_update(self, steps: int = 1) -> None:
        """Age the store's staleness counters by ``steps`` training steps.

        Serving itself never ages rows — with frozen params a cached row
        stays exact forever; staleness means "training moved the params
        under the cache". A co-located trainer calls this per step; rows
        past the shared ρ-budget then degrade to ti until re-served (and
        thereby refreshed) or repaired.
        """
        with self._mu:
            self._guard.staleness += int(steps)

    def drain(self, timeout: float = 60.0) -> bool:
        """Graceful shutdown: complete everything admitted, then stop."""
        return self.close(drain=True, timeout=timeout)

    def close(self, *, drain: bool = True, timeout: float = 60.0) -> bool:
        """Stop the server; True iff the worker exited within ``timeout``.

        ``drain=True`` completes all queued batches first; ``drain=False``
        resolves them with a typed closed response. Either way no admitted
        future is left unresolved.
        """
        self._closing.set()
        if not drain:
            self._abort.set()
        self._worker.join(timeout=timeout)
        # resolve submissions that raced past the closing check
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                break
            self._finish(p, STATUS_CLOSED, detail="server closed")
        return not self._worker.is_alive()

    def stats(self) -> dict:
        """Counters + breaker state (all host-side, cheap)."""
        with self._stat_mu:
            out = dict(self._counts)
        out["batches"] = self._seq
        out["breaker"] = self._breaker.state
        out["pending"] = out.get("submitted", 0) - sum(
            out.get(k, 0) for k in (STATUS_OK, STATUS_DEGRADED,
                                    STATUS_OVERLOADED, STATUS_TIMEOUT,
                                    STATUS_TOO_LARGE, STATUS_CLOSED,
                                    STATUS_ERROR))
        return out

    @property
    def store(self) -> HistoricalState:
        """Current store (read-mostly; the worker writes it in place)."""
        return self._store

    # -------------------------------------------------------------- internals
    def _count(self, key: str, inc: int = 1) -> None:
        with self._stat_mu:
            self._counts[key] = self._counts.get(key, 0) + inc

    def _event(self, kind: str, seq: int, detail: str = "") -> None:
        self.events.append({"kind": kind, "seq": seq, "detail": detail})

    def _finish(self, p: _Pending, status: str, *, classes=None, logits=None,
                mode=None, reason=None, attempts: int = 0, seq: int = -1,
                detail: str = "") -> None:
        if p.future.done():
            return
        self._count(status)
        p.future.set_result(ServeResponse(
            request_id=p.request_id, status=status, classes=classes,
            logits=logits, mode=mode, degraded_reason=reason,
            latency_s=time.time() - p.t_submit, attempts=attempts,
            batch_seq=seq, detail=detail))

    def _worker_main(self) -> None:
        while True:
            p = self._carry
            self._carry = None
            if p is None:
                try:
                    p = self._q.get(timeout=_POLL_S)
                except queue.Empty:
                    if self._closing.is_set():
                        return
                    continue
            if self._abort.is_set():
                self._finish(p, STATUS_CLOSED, detail="server closed")
                continue
            pend = self._collect(p)
            self._seq += 1
            try:
                self._execute(pend, self._seq)
            except BaseException as e:  # worker must never die silently
                self._count("worker_restarts")
                self._event("worker-crash", self._seq, repr(e))
                for q_ in pend:
                    self._finish(q_, STATUS_ERROR, seq=self._seq,
                                 detail=f"unrecovered worker fault: {e!r}")

    def _collect(self, first: _Pending) -> list:
        """Coalesce queued requests behind ``first`` into one bucket batch."""
        pend = [first]
        total = first.nodes.shape[0]
        cap = self.gateway.max_targets
        t_end = time.time() + self.config.batch_window_s
        while total < cap:
            try:
                nxt = self._q.get(timeout=max(0.0, t_end - time.time()))
            except queue.Empty:
                break
            if total + nxt.nodes.shape[0] > cap:
                self._carry = nxt   # consumed first on the next iteration
                break
            pend.append(nxt)
            total += nxt.nodes.shape[0]
        return pend

    def _expire(self, live: list, seq: int, detail: str) -> list:
        now = time.time()
        kept = []
        for p in live:
            if p.deadline is not None and now > p.deadline:
                self._finish(p, STATUS_TIMEOUT, seq=seq, detail=detail)
            else:
                kept.append(p)
        return kept

    def _execute(self, pend: list, seq: int) -> None:
        cfg, plan = self.config, self.fault_plan
        live = self._expire(pend, seq, "deadline expired in queue")
        if not live:
            return
        # ---- injected slow/hung batch: deadlines turn the stall into
        # typed timeouts instead of a hang
        delay = plan.serve_delay(seq) if plan else 0.0
        if delay:
            self._event("slow-batch", seq, f"injected {delay:.3f}s stall")
            time.sleep(delay)
            live = self._expire(live, seq, "deadline expired during stall")
            if not live:
                return

        all_nodes = np.concatenate([p.nodes for p in live])
        uniq, inv = np.unique(all_nodes, return_inverse=True)
        try:
            sg, hb = self.gateway.build(uniq)
        except Exception as e:
            if len(live) > 1:   # pad overflow on a merged batch: split it
                for p in live:
                    self._execute([p], seq)
                return
            self._finish(live[0], STATUS_TOO_LARGE, seq=seq, detail=str(e))
            return
        if plan and plan.serve_poison(seq):
            self._inject_poison(sg, seq)

        batch = hb.to(self.device)
        hg = np.asarray(sg.halo_gids)
        hm = np.asarray(sg.halo_mask)
        store_rows = None
        if cfg.verify_rows and cfg.force_mode is None:
            store_rows = self._store_rows(hg)
        mode, reason, bad = self._policy.decide(seq, hg, hm, store_rows)

        # ---- bounded retry loop: worker crashes and transient failures
        # retry in place; non-finite exact output trips the breaker and
        # re-runs the same batch on the store-free rung
        attempts = 0
        switched = False
        out = rows = None
        while True:
            attempts += 1
            try:
                if plan:
                    plan.serve_crash_hook(seq)
                step = self._steps[MODE_EXACT if mode == MODE_EXACT
                                   else MODE_TI]
                logits, rows = step(self.params, self._store, batch,
                                    self._x, self._self_w)
                out = logits.cpu().numpy()
                if not np.isfinite(out[:sg.n_batch_real]).all():
                    raise _NonFinite()
                break
            except ServeWorkerFault as e:
                self._count("worker_restarts")
                self._event("worker-crash", seq, str(e))
                if attempts >= cfg.max_attempts:
                    for p in live:
                        self._finish(p, STATUS_ERROR, seq=seq,
                                     attempts=attempts,
                                     detail=f"retry budget exhausted: {e}")
                    return
                time.sleep(cfg.backoff_s)
            except _NonFinite:
                if mode == MODE_EXACT and not switched:
                    self._breaker.record_failure(seq)
                    self._event("breaker-open", seq,
                                "non-finite exact output")
                    mode, reason, switched = MODE_TI, "nan-circuit", True
                    nan_gids = self._nonfinite_store_rows(hg, hm)
                    if nan_gids.size:
                        bad = np.union1d(bad, nan_gids)
                else:
                    for p in live:
                        self._finish(p, STATUS_ERROR, seq=seq,
                                     attempts=attempts,
                                     detail="non-finite output on the "
                                            "store-free path")
                    return
            except Exception as e:
                if attempts >= cfg.max_attempts:
                    for p in live:
                        self._finish(p, STATUS_ERROR, seq=seq,
                                     attempts=attempts,
                                     detail=f"execution failed: {e!r}")
                    return
                time.sleep(cfg.backoff_s)

        # ---- commit (exact path refreshes rows, so they are provably fresh:
        # re-record crcs, zero staleness) and breaker bookkeeping
        if mode == MODE_EXACT:
            self._commit(sg, batch, rows)
            was = self._breaker.state
            self._breaker.record_success()
            if was == "half-open" and self._breaker.state == "closed":
                self._event("breaker-closed", seq, "healed")
        elif reason:
            self._event("degraded", seq, reason)

        # ---- respond
        preds = np.argmax(out[:sg.n_batch_real], axis=-1)
        status = STATUS_OK if mode == MODE_EXACT else STATUS_DEGRADED
        now = time.time()
        off = 0
        for p in live:
            k = p.nodes.shape[0]
            idx = inv[off:off + k]
            off += k
            if p.deadline is not None and now > p.deadline:
                self._finish(p, STATUS_TIMEOUT, seq=seq, attempts=attempts,
                             detail="deadline expired during execution")
                continue
            self._finish(
                p, status, classes=preds[idx],
                logits=out[:sg.n_batch_real][idx] if cfg.return_logits
                else None,
                mode=mode, reason=reason, attempts=attempts, seq=seq)

        # ---- post-response repair: heal the rows that forced degradation
        if mode == MODE_TI and bad.size and cfg.repair:
            self._repair(bad, seq)

    def _inject_poison(self, sg, seq: int) -> None:
        """FaultPlan serve-poison drill: NaN store rows the batch will read."""
        hg = np.asarray(sg.halo_gids)[:sg.n_halo_real]
        if hg.size == 0:
            self._event("poisoned", seq, "no halo rows to poison; skipped")
            return
        gids = hg[:min(2, hg.size)]
        with self._mu:
            self._store.h[:, torch.as_tensor(gids, device=self.device)] = \
                float("nan")
        self._event("poisoned", seq, f"rows {gids.tolist()}")

    def _nonfinite_store_rows(self, hg: np.ndarray,
                              hm: np.ndarray) -> np.ndarray:
        gids = hg[hm > 0]
        if gids.size == 0:
            return np.zeros(0, dtype=np.int64)
        rows = self._store_rows(gids)
        return gids[~np.isfinite(rows).all(axis=(0, 2))].astype(np.int64)

    def _store_rows(self, gids: np.ndarray) -> np.ndarray:
        """Host copy of ``store.h[:, gids]``."""
        idx = torch.as_tensor(np.asarray(gids, np.int64), device=self.device)
        return self._store.h.index_select(1, idx).cpu().numpy()

    def _commit(self, sg, batch, rows) -> None:
        """Write a batch's refreshed rows into the store, re-record their
        crcs and zero their staleness (they are provably fresh)."""
        bg = np.asarray(sg.batch_gids)[:sg.n_batch_real]
        with self._mu:
            commit_rows(self._store, batch, rows, self.graph.num_nodes)
            self._integrity.record(bg, self._store_rows(bg))
            self._guard.staleness[:, bg] = 0

    def _repair(self, gids: np.ndarray, seq: int) -> None:
        """Recompute store rows via the store-free path and write them back.

        Repaired rows are ti-grade (their halo inputs are α-estimates); the
        next exact serve of those nodes overwrites them with exact values.
        The point is liveness: corruption and budget violations are healed,
        not served around forever.
        """
        gids = np.unique(np.asarray(gids, dtype=np.int64))
        if gids.size == 0:
            return
        self._count("repaired_rows", int(gids.size))
        self._event("repair", seq, f"{gids.size} rows")
        cap = self.gateway.max_targets
        for chunk in np.array_split(gids, -(-gids.size // cap)):
            sg, hb = self.gateway.build(chunk)
            batch = hb.to(self.device)
            _, rows = self._steps["repair"](
                self.params, self._store, batch, self._x, self._self_w)
            self._commit(sg, batch, rows)
