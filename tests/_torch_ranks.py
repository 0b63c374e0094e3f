"""Spawned gloo ranks of the port's distributed tests, joined on progress.

Each rank touches ``out/rank<r>.alive`` whenever it gets somewhere (after
its process group is up, and after every piece of work; :func:`heartbeat`).
:func:`join_ranks` waits for all ranks and fails only when a rank exited
non-zero, or when no rank has touched its heartbeat for ``JOIN_S`` seconds:
a hung rank fails the test instead of stalling the run, while a rank that
is merely slow — the CPU shared with other test workers — is waited for as
long as it keeps making progress.

This module imports only the standard library: the workers that use it are
spawned, and a spawned child imports the module of its target.
"""
import time
from pathlib import Path

JOIN_S = 240.0   # no heartbeat from any rank for this long: hung
POLL_S = 0.5


def heartbeat(out, rank: int) -> None:
    """Record that ``rank`` made progress."""
    (Path(out) / f"rank{rank}.alive").touch()


def join_ranks(procs: list, out: Path) -> None:
    """Wait for ``procs`` (rank order), whose heartbeats go to ``out``.

    Raises AssertionError, after terminating every rank still running,
    when a rank exited non-zero or when no rank made progress for
    ``JOIN_S`` seconds; the ranks' ``rank<r>.err`` tracebacks are in the
    message.
    """
    started = time.time()
    problem = None
    while True:
        codes = [p.exitcode for p in procs]
        bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
        if bad:
            problem = f"rank(s) exited non-zero (rank, code): {bad}"
            break
        if all(c is not None for c in codes):
            break
        beats = [f.stat().st_mtime for f in out.glob("rank*.alive")]
        idle = time.time() - max([started] + beats)
        if idle > JOIN_S:
            problem = (f"no rank made progress for {idle:.0f} s (limit "
                       f"{JOIN_S} s); exit codes {codes}")
            break
        time.sleep(POLL_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
    for p in alive:
        p.join(10)
    errs = {f.name: f.read_text() for f in out.glob("*.err")}
    assert problem is None, f"{problem}: {errs}"
