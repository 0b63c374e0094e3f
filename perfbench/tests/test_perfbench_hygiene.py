"""Nothing the benchmark runs imports JAX or the JAX package, compared by
each module's whole top-level name (``repro_torch`` is not ``repro``), and
nothing in it reads the JAX-era benchmark folders."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _imports(path):
    out = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.append(node.args[0].value)
    return out


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"
    if "tests" in path.relative_to(BENCH).parts:
        return
    text = path.read_text()
    for folder in ("benchmarks", "experiments"):
        assert f'"{folder}/' not in text and f"'{folder}/" not in text \
            and f'"{folder}"' not in text, (path, folder)


@pytest.mark.parametrize("names,bad", [
    (["repro_torch", "repro_torch.core.lmc", "reproducible"], []),
    (["repro", "repro_torch"], ["repro"]),
    (["repro.core.lmc"], ["repro"]),
    (["jax.numpy", "jaxlib", "flax.linen", "jaxtyping"],
     ["flax", "jax", "jaxlib"])])
def test_whole_names_are_compared(names, bad):
    from perfbench import harness
    assert harness.forbidden_modules(names) == bad


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert all(not m.startswith("repro_torch") for m in _imports(path)), \
            path


def test_running_the_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import perfbench.run, perfbench.drivers.train, "
            "perfbench.drivers.serve, perfbench.calibrate, perfbench.sweep, "
            "perfbench.faults, repro_torch.train, repro_torch.serve; "
            "from perfbench import harness; bad = harness.forbidden_modules(); "
            "print(bad); sys.exit(1 if bad else 0)"
            % (str(ROOT), str(ROOT / "src")))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=180)
    assert res.returncode == 0, res.stdout + res.stderr
