"""The port's CI gate (``scripts/check_torch.sh``) and its coverage floors
(``scripts/coverage_gate_torch.py``), checked without running them: the
shell script parses and names nothing of the JAX package; the coverage
groups are files of the port; the executable-line count is the
reference's (``scripts/coverage_gate.py::_executable_lines``, loaded from
its path: it imports nothing of JAX)."""
import importlib.util
import re
import subprocess
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
GATE = REPO / "scripts" / "check_torch.sh"
COVERAGE = REPO / "scripts" / "coverage_gate_torch.py"
PORT = REPO / "src" / "repro_torch"


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gate_parses():
    subprocess.run(["bash", "-n", str(GATE)], check=True, timeout=30)


@pytest.mark.parametrize("path", [GATE, COVERAGE], ids=lambda p: p.name)
def test_gate_names_no_reference_module(path):
    """``repro.<module>``, ``-m repro`` or ``src/repro/`` would run or
    measure the JAX package; the port's gate names ``repro_torch`` only."""
    text = path.read_text()
    assert not re.search(r"\brepro\.|-m repro\b|src/repro/|\bimport jax",
                         text), path.name


def test_gate_runs_the_card_gates_only_when_asked():
    """Without ``--gpu`` it says that the card gates did not run."""
    text = GATE.read_text()
    assert "chip_smoke.py" in text and "-m gpu" in text
    assert "the card gates did not run" in text


def test_coverage_groups_are_port_files():
    cov = _load(COVERAGE)
    assert set(cov.GROUP_FILES) == {"core+kernels", "serve"}
    for name, files in cov.GROUP_FILES.items():
        assert files, name
        for f in files:
            path = Path(f)
            assert path.is_file() and PORT in path.parents, f
    for test in cov.TESTS:
        assert (REPO / test).is_file() and "test_torch_" in test, test
    assert all(0 < g["floor"] <= 85.0 for g in cov.GROUPS.values())


@pytest.mark.parametrize("rel", ["kernels/ops.py", "serve/server.py",
                                 "core/lmc.py"])
def test_executable_lines_match_the_reference_counter(rel):
    ref = _load(REPO / "scripts" / "coverage_gate.py")
    cov = _load(COVERAGE)
    path = str(PORT / rel)
    lines = cov._executable_lines(path)
    assert lines and lines == ref._executable_lines(path)
