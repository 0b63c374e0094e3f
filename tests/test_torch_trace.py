"""The port's span helper (``repro_torch/trace.py``): without a profiler it
only stamps, making no ``record_function`` and no CUDA event; under one, a
span shows in the profiler's events on the profiler's own clock, on the
thread that started it only. Imports no JAX."""
import threading
import time

import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from repro_torch import trace


def _forbid(*_a, **_k):
    raise AssertionError("made while no profiler records")


@pytest.fixture
def nothing_made(monkeypatch):
    """Any record_function or CUDA event made fails the test."""
    monkeypatch.setattr(autograd_profiler, "record_function", _forbid)
    monkeypatch.setattr(torch.profiler, "record_function", _forbid)
    monkeypatch.setattr(torch.cuda, "Event", _forbid)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_no_profiler_stamps_only(nothing_made, device):
    assert not trace.profiling()
    host, dev = {}, {}
    with trace.span("outer", host):
        with trace.span("inner", host), \
                trace.device_span("inner", dev, torch.device(device)):
            torch.ones(8).sum()
        with trace.span("bare"):   # an annotation alone: no stamp
            pass
    assert dev == {} and list(host) == ["inner", "outer"]
    (i0, i1), (o0, o1) = host["inner"], host["outer"]
    assert o0 <= i0 <= i1 <= o1
    ms = trace.stamp_ms(host)
    assert 0 <= ms["inner"] <= ms["outer"] == (o1 - o0) / 1e6


def test_span_stamps_even_when_the_block_raises():
    host = {}
    with pytest.raises(ValueError), trace.span("boom", host):
        raise ValueError("boom")
    assert host["boom"][0] <= host["boom"][1]


def test_span_on_the_profilers_clock():
    """Under ``torch.profiler.profile`` the span is a profiler event whose
    start and end lie within 2 ms of its ``time.time_ns()`` stamps."""
    host, dev = {}, {}
    with torch.profiler.profile() as prof:
        assert trace.profiling()
        with trace.span("probe.clock", host), \
                trace.device_span("probe.clock", dev, torch.device("cpu")):
            torch.ones(64).sum()
        with trace.span("probe.bare"):
            torch.ones(64).sum()
    assert dev == {}   # no CUDA device: no events
    assert list(host) == ["probe.clock"]
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "probe.clock"]
    assert len(evs) == 1
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "probe.bare" in names
    assert abs(evs[0].start_ns() - host["probe.clock"][0]) < 2_000_000
    assert abs(evs[0].end_ns() - host["probe.clock"][1]) < 2_000_000
    assert not trace.profiling()


def test_span_on_another_thread_stamps_only():
    """A thread other than the profiler's makes no ``record_function``,
    which would leave no event there anyway, and still stamps."""
    go, done, host = threading.Event(), threading.Event(), {}

    def worker():
        go.wait(timeout=30)
        with trace.span("probe.worker", host):
            time.sleep(0.001)
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    with torch.profiler.profile() as prof:
        go.set()
        assert done.wait(timeout=30)
    t.join(timeout=30)
    assert not t.is_alive()
    assert "probe.worker" in host
    assert "probe.worker" not in {e.name() for e in prof.events()}


def test_elapsed_ms_reads_event_pairs():
    class Ev:
        def __init__(self, t):
            self.t = t

        def elapsed_time(self, other):
            return other.t - self.t

    assert trace.elapsed_ms({"a": (Ev(1.0), Ev(3.5))}) == {"a": 2.5}
