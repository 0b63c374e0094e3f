"""The port stands alone: no JAX and nothing of ``repro`` in ``repro_torch``
or ``chip_smoke.py``, and its entry points never drop to the CPU unasked."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
CHIP_SMOKE = REPO / "chip_smoke.py"


def _imported_modules(path: Path) -> list:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
    return mods


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [CHIP_SMOKE],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert bad == [], f"{path.relative_to(REPO)} imports {bad}"


def test_import_leaves_jax_and_reference_unloaded():
    code = ("import sys, repro_torch.serve, repro_torch.convert; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_refuse_to_run_on_cpu_unasked(monkeypatch):
    """device=None means the card; without CUDA it raises instead of
    silently running on the CPU."""
    from repro_torch.core import from_graph, init_history
    from repro_torch.graph import make_sbm_dataset
    from repro_torch.models import make_gnn
    from repro_torch.serve import GNNServer, warm_store

    g = make_sbm_dataset("ppi-cpu", seed=3)
    gnn = make_gnn("gcn", g.feature_dim, 16, g.num_classes, 2)
    data = from_graph(g, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_graph(g)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        warm_store(gnn, gnn.params(), data)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_history(2, 10, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GNNServer(gnn, g, gnn.params(), data=data)
    assert np.isfinite(data.x.numpy()).all()   # the CPU path still works


def test_chip_smoke_fails_alone_and_without_cuda(tmp_path):
    """Copied into an empty directory, or on a machine without CUDA, the
    smoke script exits non-zero and prints no result line."""
    (tmp_path / "chip_smoke.py").write_text(CHIP_SMOKE.read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
