"""The port's ``data/prefetch.py``: the Prefetcher's contract (mirrors
tests/test_prefetch.py) and the SubgraphPipeline's (mirrors
tests/test_pipeline.py: stream determinism, resume, recycling, epoch
coverage, worker exceptions, shutdown, the trainer on the pipeline), plus its
slot stream against the reference pipeline's: the same cluster ids and the
same batches. On the CPU the batches are not pinned and no side stream
exists; tests/test_torch_gpu.py holds the staged copy on the card."""
import threading
import time

import numpy as np
import pytest
import torch

from repro import graph as jgraph
from repro.data.prefetch import SubgraphPipeline as JPipeline

from repro_torch import graph as tgraph
from repro_torch.data import Prefetcher, SubgraphPipeline

from _torch_port import PARTS, losses, port_trainer, tiny_graph, tiny_parts


def _wait_until(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


# ------------------------------------------------------------ Prefetcher
def test_yields_all_items_in_order():
    assert list(Prefetcher(iter(range(100)))) == list(range(100))


def test_exhausted_stream_stays_exhausted():
    p = Prefetcher(iter([1]))
    assert list(p) == [1]
    with pytest.raises(StopIteration):
        next(p)  # must not hang on the drained sentinel


def test_empty_source():
    assert list(Prefetcher(iter([]))) == []


def test_depth_must_be_positive():
    with pytest.raises(ValueError):
        Prefetcher(iter([]), depth=0)


def test_bounded_lookahead():
    """The worker never runs more than `depth` items ahead of the
    consumer."""
    produced = []

    def source():
        for i in range(50):
            produced.append(i)
            yield i

    depth = 3
    p = Prefetcher(source(), depth=depth)
    try:
        assert [next(p) for _ in range(5)] == list(range(5))
        _wait_until(lambda: len(produced) >= 5 + depth)
        time.sleep(0.1)
        # +1 for the item it may hold while blocked in put()
        assert len(produced) <= 5 + depth + 1
    finally:
        p.close()


def test_exception_propagates_after_good_items():
    def source():
        yield 1
        yield 2
        raise RuntimeError("bad batch")

    p = Prefetcher(source())
    assert next(p) == 1
    assert next(p) == 2
    with pytest.raises(RuntimeError, match="bad batch"):
        next(p)
    with pytest.raises(StopIteration):
        next(p)


def test_exception_on_first_item():
    def source():
        raise ValueError("boom")
        yield  # pragma: no cover

    with pytest.raises(ValueError, match="boom"):
        next(Prefetcher(source()))


def test_poll_holds_terminal_items_back():
    """poll() never consumes an exception or the end: both surface from the
    next blocking ``__next__`` at their position."""
    def source():
        yield 1
        raise RuntimeError("late")

    p = Prefetcher(source(), depth=2)
    _wait_until(lambda: p.q.full())
    assert p.poll() == 1
    assert p.poll() is None            # the error is held, not raised
    with pytest.raises(RuntimeError, match="late"):
        next(p)
    assert p.poll() is None


def test_close_unblocks_full_queue_worker():
    release = threading.Event()

    def source():
        for i in range(1000):
            yield i
        release.set()  # only reached if the worker ran to completion

    p = Prefetcher(source(), depth=1)
    _wait_until(lambda: p.q.full())
    p.close()
    assert _wait_until(lambda: not p._thread.is_alive()), (
        "worker thread still alive after close()")
    assert not release.is_set(), "worker should have stopped early"
    with pytest.raises(StopIteration):
        next(p)


def test_close_is_idempotent():
    p = Prefetcher(iter(range(10)))
    p.close()
    p.close()
    with pytest.raises(StopIteration):
        next(p)


def test_sentinel_collision_safe():
    items = [None, StopIteration, 0, ""]
    assert list(Prefetcher(iter(items))) == items


# ------------------------------------------------------- SubgraphPipeline
@pytest.fixture(scope="module")
def tg():
    return tiny_graph(tgraph)


@pytest.fixture(scope="module")
def parts():
    return tiny_parts()


def _sampler(graph, parts, c=2, lib=tgraph):
    return lib.ClusterSampler(graph, PARTS, c, parts=parts, seed=1)


def _arrays(batch) -> list:
    """Every array of a batch of either package, in field order (the ELL
    graph's buckets and its transpose's included)."""
    out = []
    for f in batch:
        if f is None:
            continue
        if hasattr(f, "bucket_idx"):
            ell = f
            while ell is not None:
                out += [np.asarray(a) for a in (*ell.bucket_idx,
                                                *ell.bucket_w,
                                                *ell.bucket_rows)]
                ell = ell.transpose
        else:
            out.append(np.asarray(f))
    return out


def _same_batch(a, b) -> bool:
    """Equal arrays, dtypes included; raveled, since the port's host batch
    holds the scalar loss and grad scales as 1-element tensors."""
    xa, xb = _arrays(a), _arrays(b)
    return len(xa) == len(xb) and all(
        x.dtype == y.dtype and np.array_equal(x.ravel(), y.ravel())
        for x, y in zip(xa, xb))


def _pipe(tg, parts, c=2, **kw):
    return SubgraphPipeline(_sampler(tg, parts, c), device="cpu", **kw)


def _pipeline_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("subgraph-pipeline") and t.is_alive()]


class _RecordingSampler:
    """Duck-typed sampler wrapper recording the schedule slots built."""

    def __init__(self, inner, fail_slot=None):
        self._inner = inner
        self.fail_slot = fail_slot
        self.calls: list = []
        self._lock = threading.Lock()

    def clusters_at(self, slot, *, mode="uniform"):
        if slot == self.fail_slot:
            raise RuntimeError(f"bad slot {slot}")
        cids = self._inner.clusters_at(slot, mode=mode)
        with self._lock:
            self.calls.append((int(slot), tuple(int(c) for c in cids)))
        return cids

    def build_batch(self, cids):
        return self._inner.build_batch(cids)


@pytest.mark.parametrize("kw", [dict(depth=-1), dict(workers=0),
                                dict(recycle=0), dict(start_step=-1)])
def test_invalid_config_rejected(tg, parts, kw):
    with pytest.raises(ValueError):
        _pipe(tg, parts, **kw)


@pytest.mark.parametrize("backend", ["segment", "ell"])
def test_prefetch_equals_sync_stream(tg, parts, backend):
    """depth=2, workers=2 yields the same batches as depth=0: the stream is
    a pure function of the slot index, not of thread timing."""
    with _pipe(tg, parts, backend=backend, depth=0, num_steps=6) as sync:
        ref = list(sync)
    with _pipe(tg, parts, backend=backend, depth=2, workers=2,
               num_steps=6) as pre:
        got, slots = [], []
        for batch in pre:
            got.append(batch)
            slots.append(pre.slot)
        assert pre.pinned_peak_bytes == 0
    # CPU: no slot was pinned, and none was copied on a side stream
    assert all("pin_ms" not in rec and copy == {} for rec, copy in slots)
    assert len(ref) == len(got) == 6
    assert all(_same_batch(r, g) for r, g in zip(ref, got))


def test_resume_replays_uninterrupted_tail(tg, parts):
    full = list(_pipe(tg, parts, depth=0, recycle=2, num_steps=10))
    with _pipe(tg, parts, depth=2, recycle=2, start_step=5,
               num_steps=5) as tail:
        resumed = list(tail)
    assert len(resumed) == 5
    assert all(_same_batch(r, g) for r, g in zip(full[5:], resumed))


def test_recycle_reuses_each_subgraph_rho_times(tg, parts):
    rho, slots = 3, 4
    with _pipe(tg, parts, depth=2, recycle=rho,
               num_steps=rho * slots) as pipe:
        got = list(pipe)
    assert len(got) == rho * slots
    for i in range(0, len(got), rho):
        assert all(b is got[i] for b in got[i:i + rho])   # same object
    distinct = got[::rho]
    assert all(a is not b for a, b in zip(distinct, distinct[1:]))


def test_epoch_coverage_under_recycling(tg, parts):
    rho, c = 3, 2
    slots_per_epoch = PARTS // c
    rec = _RecordingSampler(_sampler(tg, parts, c))
    with SubgraphPipeline(rec, depth=2, workers=2, recycle=rho,
                          mode="epoch", num_steps=2 * rho * slots_per_epoch,
                          device="cpu") as pipe:
        n = sum(1 for _ in pipe)
    assert n == 2 * rho * slots_per_epoch
    assert len(rec.calls) == 2 * slots_per_epoch    # 1/ρ of the steps
    for e in range(2):
        epoch = [cid for slot, cids in rec.calls for cid in cids
                 if slot // slots_per_epoch == e]
        assert sorted(epoch) == list(range(PARTS))  # each cluster once


def test_worker_exception_surfaces_in_slot_order(tg, parts):
    fail = _RecordingSampler(_sampler(tg, parts), fail_slot=2)
    with SubgraphPipeline(fail, depth=2, workers=2, num_steps=6,
                          device="cpu") as pipe:
        assert next(pipe) is not None
        assert next(pipe) is not None
        with pytest.raises(RuntimeError, match="bad slot 2"):
            next(pipe)


def test_build_hook_fires_on_the_building_thread(tg, parts):
    seen = []

    def hook(slot):
        seen.append((slot, threading.current_thread().name))
        if slot == 3:
            raise RuntimeError("hooked 3")

    with _pipe(tg, parts, depth=1, workers=1, build_hook=hook) as pipe:
        for _ in range(3):
            next(pipe)
        with pytest.raises(RuntimeError, match="hooked 3"):
            next(pipe)
    assert [s for s, _ in seen][:4] == [0, 1, 2, 3]
    assert all(name.startswith("subgraph-pipeline") for _, name in seen)


def test_consumer_raise_mid_epoch_shuts_down_cleanly(tg, parts):
    with pytest.raises(ValueError, match="consumer bug"):
        with _pipe(tg, parts, depth=2, workers=2) as pipe:
            next(pipe)
            next(pipe)
            raise ValueError("consumer bug")
    assert _wait_until(lambda: not _pipeline_threads()), (
        f"pipeline threads survived close(): {_pipeline_threads()}")
    with pytest.raises(StopIteration):
        next(pipe)


def test_close_is_idempotent_pipeline(tg, parts):
    pipe = _pipe(tg, parts, depth=1)
    next(pipe)
    pipe.close()
    pipe.close()
    assert _wait_until(lambda: not _pipeline_threads())


def test_host_batch_is_the_yielded_slot(tg, parts):
    """``host`` is the host batch of the newest yield: the trainer reads the
    staleness gids there instead of syncing the device batch."""
    with _pipe(tg, parts, depth=2, recycle=2, num_steps=4) as pipe:
        for b in pipe:
            assert _same_batch(pipe.host, b)


@pytest.mark.parametrize("depth,recycle", [(0, 1), (0, 2), (2, 1), (2, 2)])
def test_slot_record_reaches_its_first_step(tg, parts, depth, recycle):
    """Each slot's build record comes with the first yield of its slot and
    with no other: its index, its build's spans in order on the profiler's
    clock, its bytes, its ELL build's kernel launches; no pinning and no
    side-stream copy on the CPU."""
    with _pipe(tg, parts, depth=depth, recycle=recycle,
               num_steps=6) as pipe:
        seen = [(batch, pipe.slot) for batch in pipe]
    assert len(seen) == 6
    for step, (batch, slot) in enumerate(seen):
        if step % recycle:
            assert slot is None
            continue
        rec, copy = slot
        assert rec["index"] == step // recycle and copy == {}
        assert set(rec) == {"index", "t_ns", "sample_ms", "bucket_ms",
                            "copy_bytes", "ell_launches"}
        assert rec["ell_launches"] == 0   # built on the CPU: no launch
        assert rec["sample_ms"] > 0 and rec["bucket_ms"] > 0
        assert 0 < rec["t_ns"][0] < rec["t_ns"][1]
        assert (rec["t_ns"][1] - rec["t_ns"][0]) / 1e6 >= \
            rec["sample_ms"] + rec["bucket_ms"]
        assert rec["copy_bytes"] == sum(t.nbytes for t in batch.tensors())


def test_stage_next_keeps_the_stream(tg, parts):
    """Staging the following slot from the consumer, as the trainer does
    once it has issued a step, yields the batches plain iteration yields;
    a slot once staged stays staged until it is fetched."""
    with _pipe(tg, parts, backend="ell", depth=2, num_steps=5) as plain:
        want = list(plain)
    got = []
    with _pipe(tg, parts, backend="ell", depth=2, num_steps=5) as pipe:
        for b in pipe:
            got.append(b)
            pipe.stage_next()
            staged = pipe._staged
            pipe.stage_next()
            assert staged is None or pipe._staged is staged
    assert len(got) == 5 and all(_same_batch(a, b)
                                 for a, b in zip(want, got))


# ---------------------------------------------------- against the reference
@pytest.mark.parametrize("mode,recycle,backend", [
    ("uniform", 1, "segment"), ("epoch", 2, "ell")])
def test_slot_stream_matches_reference(tg, parts, mode, recycle, backend):
    """The same schedule slots carry the same cluster ids and build the same
    batches in both packages."""
    jgr = tiny_graph(jgraph)
    jrec = _RecordingSampler(_sampler(jgr, parts, lib=jgraph))
    trec = _RecordingSampler(_sampler(tg, parts))
    kw = dict(backend=backend, depth=2, workers=2, mode=mode,
              recycle=recycle, num_steps=8)
    with JPipeline(jrec, **kw) as jp, SubgraphPipeline(trec, device="cpu",
                                                       **kw) as tp:
        pairs = list(zip(jp, tp))
    assert len(pairs) == 8
    assert sorted(trec.calls) == sorted(jrec.calls)
    assert all(_same_batch(j, t) for j, t in pairs)


# ------------------------------------------------------- the trainer on it
def test_trainer_prefetch_matches_sync(tg, parts):
    """GNNTrainer(prefetch=2) gives the losses of prefetch=0 (the same
    schedule, built synchronously)."""
    ta = port_trainer(tg, parts, prefetch=0)
    ta.run(6)
    tb = port_trainer(tg, parts, prefetch=2)
    tb.run(6)
    tb.close()
    assert losses(ta) == losses(tb)


@pytest.mark.parametrize("depth,recycle", [(0, 1), (0, 2), (2, 1), (2, 2)])
def test_trainer_step_records_carry_spans(tg, parts, depth, recycle):
    """On the CPU every step record carries its start and end on the
    profiler's clock, the first step of each slot that slot's build record
    and no other step one, and no step device times (no profiler, no card);
    ``host_s`` lies inside ``t_ns``."""
    tr = port_trainer(tg, parts, prefetch=depth, recycle=recycle)
    tr.run(6)
    tr.close()
    recs = [r for r in tr.history if "loss" in r]
    assert [r["step"] for r in recs] == list(range(1, 7))
    for prev, r in zip([None] + recs, recs):
        t0, t1 = r["t_ns"]
        assert 0 < t0 < t1 and (prev is None or prev["t_ns"][1] <= t0)
        assert r["host_s"] <= r["time_s"] <= (t1 - t0) / 1e9 + 1e-3
        assert "device_ms" not in r
        first = (r["step"] - 1) % recycle == 0
        assert ("slot" in r) == first
        if first:
            assert r["slot"]["index"] == (r["step"] - 1) // recycle
            assert r["slot"]["sample_ms"] > 0 and r["slot"]["bucket_ms"] > 0
            assert not {"pin_ms", "copy_ms"} & set(r["slot"])
            assert r["slot"]["t_ns"][1] <= t1


def test_trainer_resume_through_pipeline(tmp_path, tg, parts):
    ref = port_trainer(tg, parts, prefetch=2, recycle=2)
    ref.run(8)
    ref.close()
    ta = port_trainer(tg, parts, str(tmp_path), prefetch=2, recycle=2,
                      ckpt_every=4)
    ta.run(4)
    ta.save()
    ta.close()
    tb = port_trainer(tg, parts, str(tmp_path), prefetch=2, recycle=2,
                      ckpt_every=4)
    assert tb.restore() and tb.step_num == 4
    tb.run(4)
    tb.close()
    for k in ("w", "b"):
        assert torch.equal(ref.params["head"][k], tb.params["head"][k])
    assert torch.equal(ref.store.h, tb.store.h)


def test_trainer_close_stops_workers(tg, parts):
    tr = port_trainer(tg, parts, prefetch=2)
    tr.run(2)
    tr.close()
    assert _wait_until(lambda: not _pipeline_threads())
