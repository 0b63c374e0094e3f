"""Line-coverage floors of the PyTorch port's numerics core + serving tier
(``scripts/check_torch.sh``), the counterpart of ``scripts/coverage_gate.py``.

Measures line coverage of the port's load-bearing packages under a targeted
pytest subset, run in this process, and fails if any group drops below its
floor:

* ``core+kernels`` — ``src/repro_torch/core`` + ``src/repro_torch/kernels``
  under the LMC training tests, the kernel wrappers' tests (their plain
  versions on the CPU), the scatter SpMM and compensation layout tests and
  the model tests;
* ``serve`` — ``src/repro_torch/serve`` under the serving unit tests and
  the serving fault matrix.

The floors are the reference's 85% where the port reaches it on the CPU,
else the CPU's measured value rounded down to a whole percent: the CUDA
branches of the kernel wrappers and ``kernels/build.py``'s nvcc path run
only on a card, and the ranks the distributed tests spawn are not traced.

Prefers coverage.py when importable.  The pinned container does not ship it,
so the fallback is self-contained stdlib machinery:

* numerator  — a ``sys.settrace``/``threading.settrace`` line tracer that
  records ``(filename, lineno)`` only for frames inside the target packages
  (every other frame pays one set lookup per call event and is not traced);
* denominator — ``compile()`` each target file and walk ``co_lines()`` over
  the full nested code-object tree (PEP 626 makes that the exact set of
  traceable lines, which is what the numerator can ever hit).

The tracer is installed *before* pytest is imported so that the one-time
module-level lines of the target packages (executed at first import, during
collection) are credited.  ``threading.settrace`` matters for the serving
group: the server's worker thread executes most of server.py.

Run: ``PYTHONPATH=src python scripts/coverage_gate_torch.py [extra pytest args]``.
"""
from __future__ import annotations

import sys
import types
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch"
# floors from a CPU run (torch 2.13): core+kernels 69.0% (below the
# reference's 85%: the wrappers' CUDA branches, kernels/build.py's nvcc
# path and core/distributed.py, which runs in spawned ranks), serve 88.6%
GROUPS = {
    "core+kernels": {"dirs": (SRC / "core", SRC / "kernels"), "floor": 69.0},
    "serve": {"dirs": (SRC / "serve",), "floor": 85.0},
}
TESTS = ("tests/test_torch_train.py", "tests/test_torch_kernels.py",
         "tests/test_torch_spmm_scatter.py",
         "tests/test_torch_compensate_layout.py", "tests/test_torch_models.py",
         "tests/test_torch_serve.py", "tests/test_torch_serve_matrix.py")

GROUP_FILES = {
    name: frozenset(str(p) for d in g["dirs"] for p in sorted(d.rglob("*.py")))
    for name, g in GROUPS.items()}
TARGET_FILES = frozenset().union(*GROUP_FILES.values())
_executed: dict[str, set[int]] = defaultdict(set)


def _line_tracer(frame, event, arg):
    if event == "line":
        _executed[frame.f_code.co_filename].add(frame.f_lineno)
    return _line_tracer


def _call_tracer(frame, event, arg):
    if frame.f_code.co_filename in TARGET_FILES:
        return _line_tracer
    return None


def _executable_lines(path: str) -> set[int]:
    code = compile(Path(path).read_text(), path, "exec")
    lines: set[int] = set()
    stack = [code]
    while stack:
        co = stack.pop()
        lines.update(ln for *_, ln in co.co_lines() if ln is not None)
        stack.extend(c for c in co.co_consts
                     if isinstance(c, types.CodeType))
    return lines


def _run_pytest(argv: list[str]) -> int:
    import pytest
    return pytest.main(["-q", "-p", "no:cacheprovider", *TESTS, *argv])


def main(argv: list[str]) -> int:
    try:
        import coverage
    except ImportError:
        coverage = None

    if coverage is not None:
        cov = coverage.Coverage(
            source=[str(d) for g in GROUPS.values() for d in g["dirs"]])
        cov.start()
        rc = _run_pytest(argv)
        cov.stop()

        def file_cov(f):
            _, statements, _, missing, _ = cov.analysis2(f)
            return len(statements) - len(missing), len(statements)
    else:
        import threading
        threading.settrace(_call_tracer)
        sys.settrace(_call_tracer)
        rc = _run_pytest(argv)
        sys.settrace(None)
        threading.settrace(None)

        def file_cov(f):
            ex = _executable_lines(f)
            return len(_executed.get(f, set()) & ex), len(ex)

    if rc != 0:
        print(f"coverage gate: pytest exited {rc}; not checking the floors")
        return rc

    failed = False
    for name, g in GROUPS.items():
        total = hit = 0
        for f in sorted(GROUP_FILES[name]):
            got, ex = file_cov(f)
            total += ex
            hit += got
            rel = Path(f).relative_to(ROOT)
            print(f"coverage: {rel} {got}/{ex} "
                  f"({100 * got / max(ex, 1):.0f}%)")
        pct = 100.0 * hit / max(total, 1)
        floor = g["floor"]
        print(f"coverage gate: {name} {pct:.1f}% (floor {floor:.0f}%)")
        if pct < floor:
            print(f"coverage gate: FAILED — {name} {pct:.1f}% < {floor:.0f}%")
            failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
