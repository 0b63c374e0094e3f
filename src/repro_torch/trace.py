"""Spans of the program on the profiler's clock (the metrics that read them:
PERF.md §3).

``span`` stamps a host interval with ``time.time_ns()``, the Unix-epoch clock
on which the torch profiler's CPU events lie, so a stamp can be laid on a
device trace exported from the same run. ``device_span`` brackets work on the
current CUDA stream with a pair of timing events. A running profiler is the
switch: without one, ``span`` at most stamps and ``device_span`` does nothing;
neither takes an argument or reads a setting to turn it on. Neither waits on
the device: event pairs are read by ``elapsed_ms`` after a synchronisation
the caller already makes.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Optional

import torch
from torch.autograd import profiler as _profiler


def profiling() -> bool:
    """Whether a torch profiler is recording, on any thread."""
    return _profiler._is_profiler_enabled


@contextmanager
def span(name: str, into: Optional[dict] = None):
    """Stamp ``into[name] = (start_ns, end_ns)`` around the block when
    ``into`` is given; on the thread that started a profiler, also a
    ``record_function(name)``, so the span shows in the trace. Each stamp
    is taken just before the profiler records the matching end of the
    event: after recording one, the thread may wait for the GIL for
    milliseconds."""
    rf = None
    t0 = time.time_ns()
    if profiling() and torch.autograd._profiler_enabled():   # this thread
        rf = _profiler.record_function(name)
        rf.__enter__()
    try:
        yield
    finally:
        t1 = time.time_ns()
        if rf is not None:
            rf.__exit__(None, None, None)
        if into is not None:
            into[name] = (t0, t1)


@contextmanager
def device_span(name: str, into: dict, device: torch.device):
    """While profiling on a CUDA ``device``: ``into[name] = (start, end)``,
    timing events recorded on its current stream around the block."""
    if device.type != "cuda" or not profiling():
        yield
        return
    stream = torch.cuda.current_stream(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record(stream)
    try:
        yield
    finally:
        end.record(stream)
        into[name] = (start, end)


def elapsed_ms(into: dict) -> dict:
    """``{name: ms}`` of a dict of event pairs, all of whose end events the
    device has passed."""
    return {k: s.elapsed_time(e) for k, (s, e) in into.items()}


def stamp_ms(into: dict) -> dict:
    """``{name: ms}`` of a dict of ``span`` stamps."""
    return {k: (t1 - t0) / 1e6 for k, (t0, t1) in into.items()}
