"""Host-side prefetch: overlap batch construction with device compute.

Two layers live here (DESIGN.md §9):

* :class:`Prefetcher` — a generic background-thread iterator wrapper with a
  bounded buffer, in-order delivery, exception propagation and prompt
  ``close()``. It knows nothing about graphs.
* :class:`SubgraphPipeline` — the LMC training pipeline built on top of it: a
  thread pool pulls schedule slots from ``ClusterSampler.clusters_at`` (a pure
  function of the slot index, so worker arrival order cannot perturb the
  stream), builds padded ``Batch`` objects with the plan of their
  fixed-capacity ELL buckets on the host and pins them, hands them through
  the ``Prefetcher`` queue, and double-buffers the host→device transfer:
  while the consumer runs step k, the copy of the next batch, and the build
  of its ELL buckets from the copied COO, are already issued on a side CUDA
  stream.
  ``recycle=ρ`` reuses each sampled subgraph for ρ consecutive steps
  (LazyGNN-style minibatch recycling) before resampling; LMC's
  bounded-staleness historical stores keep this within the Thm 2 staleness
  budget because the store-refresh path is unchanged — every recycled step
  still rewrites its store rows.
"""
from __future__ import annotations

import itertools
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, NamedTuple, Optional

import torch

from repro_torch import trace
from repro_torch.core.lmc import Batch, host_batch
from repro_torch.device import resolve_device
import repro_torch.kernels.ell_build as ell_build
from repro_torch.kernels import ELLPlan


class _Done:
    """Private end-of-stream sentinel (unique object, never yielded by a
    source — unlike e.g. the StopIteration class itself)."""


class _Raised:
    """Wraps an exception raised inside the worker for re-raise in the
    consumer thread."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetcher:
    """Background-thread prefetch with a bounded buffer (double buffering
    by default).

    * Items are yielded in source order; at most ``depth`` batches are ever
      buffered ahead of the consumer (bounded lookahead, so host memory for
      batch construction stays O(depth)).
    * An exception raised by the source propagates to the consumer from
      ``__next__`` — after all items produced before it have been consumed.
    * ``close()`` stops the worker thread promptly even when it is blocked
      in a full-queue ``put`` and joins it; it is idempotent and is also
      called on GC. Iterating after ``close()`` raises ``StopIteration``.

    Thread-safety: one producer (the internal worker) and one consumer
    thread; ``__next__``/``poll`` must not be called concurrently from
    multiple threads.
    """

    # worker wakes up at this period to notice close() while blocked on a
    # full queue; latency of close(), not of the data path
    _PUT_POLL_S = 0.05

    def __init__(self, source: Iterator, depth: int = 2):
        """Start prefetching from ``source`` with a ``depth``-item buffer."""
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._held = None   # terminal item peeked by poll(), kept in order
        self._exhausted = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that aborts (returns False) once close() is called."""
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=self._PUT_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        try:
            for item in self.source:
                if not self._put(item):
                    return
        except BaseException as exc:  # noqa: BLE001 — re-raised in consumer
            self._put(_Raised(exc))
            return
        self._put(_Done)

    def __iter__(self):
        """Return self (single-consumer iterator)."""
        return self

    def __next__(self):
        """Next item in source order; blocks until one is buffered."""
        if self._exhausted:
            raise StopIteration
        if self._held is not None:
            item, self._held = self._held, None
            return self._resolve(item)
        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                item = self.q.get(timeout=self._PUT_POLL_S)
                break
            except queue.Empty:
                continue
        return self._resolve(item)

    def poll(self):
        """Non-blocking variant of ``__next__``: an item if one is already
        buffered, else ``None`` (also ``None`` at end-of-stream).

        Terminal items (end-of-stream, or an exception raised by the
        source) are *held back* rather than consumed here, so they surface
        from the next blocking ``__next__`` at their exact position in the
        stream. The pipeline uses poll() to opportunistically stage the next
        device transfer without stalling the train step — an error for a
        later slot must not fire while an earlier slot is being fetched.
        """
        if self._exhausted or self._stop.is_set() or self._held is not None:
            return None
        try:
            item = self.q.get_nowait()
        except queue.Empty:
            return None
        if item is _Done or isinstance(item, _Raised):
            self._held = item
            return None
        return item

    def _resolve(self, item):
        """Map a queue item to (value | StopIteration | re-raised error)."""
        if item is _Done:
            self._exhausted = True
            raise StopIteration
        if isinstance(item, _Raised):
            self._exhausted = True
            raise item.exc
        return item

    def close(self) -> None:
        """Stop and join the worker; idempotent, also invoked on GC."""
        self._stop.set()
        # drain so a worker blocked mid-put sees _stop on its next poll and
        # the queue's buffered batches are released promptly
        while True:
            try:
                self.q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __del__(self):
        """Best-effort close when the prefetcher is garbage collected."""
        try:
            self.close()
        except Exception:
            pass


class _Staged(NamedTuple):
    """A batch whose copy to the device is issued: the device batch, the
    event the copy recorded on the side stream (None when no side stream
    was used), the host batch, held until the copy has been waited on, the
    slot's build record and the copy's events (``SubgraphPipeline.slot``)."""
    batch: Batch
    ready: Optional[torch.cuda.Event]
    host: Batch
    record: dict
    copy: dict


class SubgraphPipeline:
    """Async subgraph sampling pipeline with minibatch recycling.

    Yields device-ready ``repro_torch.core.Batch`` objects, one per
    *training step*. Internally a ``ThreadPoolExecutor`` builds schedule
    slots ahead of the consumer (``sampler.build_batch`` + ``host_batch``
    and, for a CUDA device, ``pin_memory``: numpy and host tensors only,
    nothing launched on the card from worker threads), a :class:`Prefetcher`
    buffers up to ``depth`` built batches, and the consumer side keeps one
    extra batch staged on the device: its ``non_blocking`` copy, then the
    build of its ELL buckets from the copied COO (``Batch.bucketed``), are
    issued on a side CUDA stream by :meth:`stage_next`, which the trainer
    calls once it has issued a step (so that they overlap it), or at the
    latest when the slot is fetched, and record an event that the compute
    stream waits on before the step reads the batch (double-buffered
    host→device transfer). The device tensors are ``record_stream``-ed on
    the compute stream, and the pinned host batch is held until its slot is
    replaced, so neither memory is reused while the copy or the step may
    still read it. Each slot carries a record of its
    build's spans, bytes and copy events to its first step (``slot``).

    Determinism contract: the stream is a pure function of
    ``(sampler.seed, mode, recycle, step index)``. Slot ``i`` (steps
    ``[i*recycle, (i+1)*recycle)``) always carries the clusters
    ``sampler.clusters_at(i, mode=mode)``, regardless of ``depth``,
    ``workers`` or thread scheduling; ``depth=0`` builds the identical stream
    synchronously in the consumer thread. Resuming from ``start_step`` k
    replays exactly the tail of a run started at 0 (checkpoint recovery).

    Recycling (``recycle=ρ > 1``): each built subgraph is yielded for ρ
    consecutive steps before the next slot is fetched, amortizing the host
    sampling + bucketing cost 1/ρ. Under ``mode="epoch"`` an "epoch" becomes
    ρ·B/c steps but still visits every cluster exactly once per B/c distinct
    slots. Safe for LMC because the historical stores are refreshed by every
    step — including recycled ones — so staleness stays within the Thm 2
    ρ-term (DESIGN.md §9 discusses the bound).

    Lifecycle: iterate (``for batch in pipe`` / ``next(pipe)``), then
    ``close()`` — or use it as a context manager, which closes on exit even
    when the consumer raises mid-epoch. A worker-side exception surfaces in
    the consumer at the failed slot's position in the stream; buffered
    earlier batches drain first. After ``close()`` iteration raises
    ``StopIteration``.

    Thread-safety: single consumer thread; the sampler's schedule API
    (``clusters_at``/``build_batch``) is called concurrently from workers
    and must stay read-only (``ClusterSampler``'s is).
    """

    def __init__(self, sampler, *, backend: str = "segment", depth: int = 2,
                 workers: int = 2, recycle: int = 1, mode: str = "uniform",
                 start_step: int = 0, num_steps: Optional[int] = None,
                 ell_buckets=(8, 32, 128),
                 build_hook: Optional[Callable[[int], None]] = None,
                 device=None):
        """Configure and (for ``depth >= 1``) start the background pipeline.

        Args:
            sampler: a ``ClusterSampler`` (any object with ``clusters_at`` +
                ``build_batch``); its schedule API must be thread-safe.
            backend: ``"segment"``, ``"ell"`` or ``"ti"`` — whether workers
                also plan each batch's adjacency (A and Aᵀ) in the CUDA
                kernels' ELL layout, which ``_stage`` builds on the device
                (``"ti"`` additionally rides the
                subgraph's message-invariance scales along; see
                core/lmc.host_batch).
            depth: prefetch queue depth. ``0`` disables all threading: the
                synchronous path, same stream (tiny graphs, debugging).
                ``>= 1`` bounds host lookahead to ``depth + workers`` built
                batches plus one staged on the device.
            workers: thread-pool size for host-side batch construction.
            recycle: ρ — consecutive steps each sampled subgraph is reused.
            mode: ``"uniform"`` (iid slots, Alg. 1 line 4) or ``"epoch"``
                (shuffled epochs, every cluster once per B/c slots).
            start_step: global step to resume from (slot ``start_step //
                recycle``, mid-recycle-window offsets included).
            num_steps: stop after this many yields (``None`` = unbounded).
            ell_buckets: ELL degree-bucket sizes for ``backend="ell"``.
            build_hook: optional ``hook(slot)`` invoked (on the building
                thread) before each slot is built — the fault-injection
                seam (``train.health.FaultPlan.pipeline_hook``): raising
                here surfaces at that slot's position in the stream like
                any worker exception, and the consumer can rebuild the
                pipeline at the same step for a deterministic retry.
            device: where the batches go (None: the CUDA card, raising
                without one; ``"cpu"`` yields the host batches unpinned).
        """
        if depth < 0:
            raise ValueError(f"depth must be >= 0, got {depth}")
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if recycle < 1:
            raise ValueError(f"recycle must be >= 1, got {recycle}")
        if start_step < 0:
            raise ValueError(f"start_step must be >= 0, got {start_step}")
        self.device = resolve_device(device)
        self.sampler = sampler
        self.backend = backend
        self.depth = int(depth)
        self.workers = int(workers)
        self.recycle = int(recycle)
        self.mode = mode
        self.ell_buckets = ell_buckets
        self.build_hook = build_hook
        self._cuda = self.device.type == "cuda"
        # high priority: the build's few small kernels on it go ahead of
        # the blocks of a running step, which it hardly delays
        self._copy_stream = (torch.cuda.Stream(self.device, priority=-1)
                             if self._cuda and self.depth >= 1 else None)
        # pinned host bytes alive (built, not yet released), and their peak
        self._pinned_lock = threading.Lock()
        self.pinned_bytes = 0
        self.pinned_peak_bytes = 0
        self._step = int(start_step)
        self._end_step = None if num_steps is None else self._step + int(num_steps)
        self._cur_slot = -1
        self._cur: Optional[_Staged] = None
        self._fresh = False   # the newest yield is its slot's first step
        self._staged: Optional[_Staged] = None   # next slot, copy issued
        self._closed = False
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pf: Optional[Prefetcher] = None
        if self.depth >= 1:
            first_slot = self._step // self.recycle
            end_slot = (None if self._end_step is None
                        else -(-self._end_step // self.recycle))
            self._pool = ThreadPoolExecutor(
                max_workers=self.workers,
                thread_name_prefix="subgraph-pipeline")
            self._pf = Prefetcher(self._built_stream(first_slot, end_slot),
                                  depth=self.depth)

    # ------------------------------------------------------------- producer
    def _build_host(self, slot: int, pin: bool = False) -> tuple:
        """Worker-side: schedule slot -> (host Batch, its record). The batch
        is numpy and ``torch.from_numpy``, pinned when ``pin``; the record
        is ``{"index", "t_ns", "sample_ms", "bucket_ms", "pin_ms" (pinned
        only), "copy_bytes"}``: the build's spans on this thread (the
        sampler's subgraph, the ELL plan in ``host_batch``, pinning), its
        start and end on the profiler's clock, and the batch's bytes.
        Nothing here launches on the card; ``_stage`` adds
        ``ell_launches``."""
        if self.build_hook is not None:
            self.build_hook(slot)
        spans: dict = {}
        with trace.span("pipeline.sample", spans):
            sg = self.sampler.build_batch(
                self.sampler.clusters_at(slot, mode=self.mode))
        with trace.span("pipeline.bucket", spans):
            hb = host_batch(sg, backend=self.backend,
                            ell_buckets=self.ell_buckets)
        nbytes = sum(t.nbytes for t in hb.tensors())
        if pin:
            with trace.span("pipeline.pin", spans):
                hb = hb.pin_memory()
            with self._pinned_lock:
                self.pinned_bytes += nbytes
                self.pinned_peak_bytes = max(self.pinned_peak_bytes,
                                             self.pinned_bytes)
        stamps = list(spans.values())
        rec = {"index": slot, "t_ns": (stamps[0][0], stamps[-1][1]),
               "copy_bytes": nbytes,
               **{k.split(".")[1] + "_ms": v
                  for k, v in trace.stamp_ms(spans).items()}}
        return hb, rec

    def _built_stream(self, first_slot: int, end_slot: Optional[int]):
        """Generator the Prefetcher drives: in-order built host batches.

        Keeps up to ``workers`` build futures in flight; ``.result()``
        re-raises worker exceptions in slot order so the Prefetcher's
        exception contract holds unchanged.
        """
        slots = (itertools.count(first_slot) if end_slot is None
                 else iter(range(first_slot, end_slot)))
        pending: deque = deque()
        try:
            while True:
                while len(pending) < self.workers:
                    try:
                        s = next(slots)
                    except StopIteration:
                        break
                    pending.append(self._pool.submit(self._build_host, s,
                                                     self._cuda))
                if not pending:
                    return
                yield pending.popleft().result()
        finally:
            for f in pending:
                f.cancel()

    # ------------------------------------------------------------- consumer
    def _stage(self, built: tuple) -> _Staged:
        """Issue a built (host Batch, record)'s copy to the device on the
        side stream, between the events ``pipeline.copy`` times, then build
        its ELL buckets there from the copied COO, between the events
        ``pipeline.ell`` times (where the batch carries an ELL plan). The
        record gains ``ell_launches``, the build's kernel launches."""
        hb, rec = built
        launches = ell_build.LAUNCHES
        if self._copy_stream is None:
            db = hb.to(self.device)
            rec["ell_launches"] = ell_build.LAUNCHES - launches
            return _Staged(db, None, hb, rec, {})
        start, copied, ready = (torch.cuda.Event(enable_timing=True)
                                for _ in range(3))
        with torch.cuda.stream(self._copy_stream):
            start.record(self._copy_stream)
            db = hb.copy_to(self.device, non_blocking=True)
            copied.record(self._copy_stream)
            events = {"pipeline.copy": (start, copied)}
            if isinstance(hb.ell, ELLPlan):
                db = db.bucketed()
                ready.record(self._copy_stream)
                events["pipeline.ell"] = (copied, ready)
            else:
                ready = copied
        rec["ell_launches"] = ell_build.LAUNCHES - launches
        return _Staged(db, ready, hb, rec, events)

    def _fetch_next_slot(self) -> _Staged:
        """Staged batch for the next schedule slot, advancing the stream.

        With prefetch: take the staged copy if one exists (staging it now
        if its batch is built and no :meth:`stage_next` did), else block on
        the queue and issue the copy. Without prefetch (``depth=0``): build
        + copy inline.
        """
        if self._pf is None:
            return self._stage(self._build_host(self._step // self.recycle))
        self.stage_next()
        if self._staged is not None:
            staged, self._staged = self._staged, None
        else:
            staged = self._stage(next(self._pf))   # may raise StopIteration
        return staged

    def stage_next(self) -> None:
        """Issue the following slot's copy, and its ELL build, on the side
        stream if its batch is built and none is staged yet (the device's
        double buffer). The trainer calls it once it has issued the step
        that reads the current batch, so that the host's staging overlaps
        the device's step; else the next slot's fetch does. A no-op
        without prefetch."""
        if self._pf is None or self._staged is not None:
            return
        nxt = self._pf.poll()
        if nxt is not None:
            self._staged = self._stage(nxt)

    def _release(self, staged: Optional[_Staged]) -> None:
        """Drop a replaced slot's pinned host batch from the accounting."""
        if staged is not None and self._cuda and self._pf is not None:
            with self._pinned_lock:
                self.pinned_bytes -= staged.record["copy_bytes"]

    def __iter__(self):
        """Return self (single-consumer iterator)."""
        return self

    def __next__(self) -> Batch:
        """Device Batch for the next training step (recycling-aware)."""
        if self._closed:
            raise StopIteration
        if self._end_step is not None and self._step >= self._end_step:
            raise StopIteration
        slot = self._step // self.recycle
        self._fresh = False
        if slot != self._cur_slot:
            staged = self._fetch_next_slot()
            if staged.ready is not None:
                # the step reads the batch on the compute stream: wait for
                # the side-stream copy there, and keep the allocator from
                # reusing the copy's memory until the compute stream is done
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(staged.ready)
                for t in staged.batch.tensors():
                    t.record_stream(compute)
            self._release(self._cur)
            self._cur, self._cur_slot, self._fresh = staged, slot, True
        self._step += 1
        return self._cur.batch

    @property
    def host(self) -> Batch:
        """The host Batch of the newest yield's slot: the same gids and
        masks as the device batch, readable without a device sync (its ELL
        still the plan)."""
        return self._cur.host

    @property
    def slot(self) -> Optional[tuple]:
        """``(record, copy)`` of the newest yield's slot when that yield is
        the slot's first step, else None. ``record`` is the build's (see
        ``_build_host``) with ``ell_launches``; ``copy`` holds the side
        stream's events around the batch's copy and its ELL build,
        ``{"pipeline.copy": (start, copied), "pipeline.ell": (copied,
        ready)}`` (the latter only for a batch with an ELL plan; empty
        without a side stream), which ``trace.elapsed_ms`` reads once the
        step that read the batch has synchronised."""
        return (self._cur.record, self._cur.copy) if self._fresh else None

    @property
    def step(self) -> int:
        """Global index of the next step this pipeline will yield."""
        return self._step

    def close(self) -> None:
        """Shut down the queue and thread pool; idempotent, also on GC.

        Safe to call with builds still in flight (consumer raised mid-epoch):
        the Prefetcher unblocks/joins its worker, then queued-but-unstarted
        builds are cancelled and the pool joins.
        """
        if self._closed:
            return
        self._closed = True
        self._cur = self._staged = None
        if self._pf is not None:
            self._pf.close()
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self):
        """Context-manager entry: the pipeline itself."""
        return self

    def __exit__(self, exc_type, exc, tb):
        """Context-manager exit: always close, never swallow the exception."""
        self.close()
        return False

    def __del__(self):
        """Best-effort close when the pipeline is garbage collected."""
        try:
            self.close()
        except Exception:
            pass

