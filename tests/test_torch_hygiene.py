"""The port stands alone: no JAX and nothing of ``repro`` in ``repro_torch``,
``chip_smoke.py``, the port's CLIs (``examples/*_torch.py``), its CI
scripts (``scripts/*_torch.py``) or the worker
modules the distributed tests spawn (``tests/_torch_dist.py``,
``_torch_lm_dist.py`` and their ``_torch_ranks.py``), and its entry points
never drop to the CPU unasked."""
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
PORT_CLIS = sorted((REPO / "examples").glob("*_torch.py"))
PORT_SCRIPTS = sorted((REPO / "scripts").glob("*_torch.py"))
# spawned by the distributed tests: their children must not import JAX
DIST_WORKERS = [REPO / "tests" / f for f in ("_torch_dist.py",
                                             "_torch_lm_dist.py",
                                             "_torch_ranks.py")]


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


@pytest.mark.parametrize("path",
                         sorted(PORT.rglob("*.py")) + [CHIP_SMOKE] + PORT_CLIS
                         + PORT_SCRIPTS + DIST_WORKERS,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert bad == [], f"{path.relative_to(REPO)} imports {bad}"


def test_import_leaves_jax_and_reference_unloaded():
    code = ("import sys, repro_torch.serve, repro_torch.convert, "
            "repro_torch.train, repro_torch.optim, repro_torch.graph.sampler, "
            "repro_torch.graph.partition, repro_torch.data, "
            "repro_torch.checkpoint, repro_torch.dist, "
            "repro_torch.core.distributed, repro_torch.models.lm, "
            "repro_torch.configs, repro_torch.launch.steps, "
            "repro_torch.analysis.__main__; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_refuse_to_run_on_cpu_unasked(monkeypatch, tmp_path):
    """device=None means the card; without CUDA it raises instead of
    silently running on the CPU."""
    from repro_torch.convert import state_from_reference
    from repro_torch.core import LMC, from_graph, init_history, to_device_batch
    from repro_torch.data import SubgraphPipeline
    from repro_torch.graph import ClusterSampler, make_sbm_dataset
    from repro_torch.models import make_gnn
    from repro_torch.optim import sgd
    from repro_torch.serve import GNNServer, warm_store
    from repro_torch.train import GNNTrainer, HealthConfig

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
    sampler = ClusterSampler(g, 4, 1, parts=np.arange(g.num_nodes) % 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GNNTrainer(gnn, LMC, g, sampler, sgd())
    for kw in (dict(ckpt_dir=str(tmp_path), async_ckpt=True),
               dict(health=HealthConfig()), dict(prefetch=2),
               dict(recycle=2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GNNTrainer(gnn, LMC, g, sampler, sgd(), **kw)
    for depth in (0, 2):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SubgraphPipeline(sampler, depth=depth)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        to_device_batch(sampler.sample(), backend="ell")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        state_from_reference(np.zeros((2, 3, 4)), np.zeros((1, 3, 4)))
    from repro_torch.checkpoint import reshard
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reshard({"store": (np.zeros((2, 3, 4)), None)}, {"store": (1, 1)})
    from repro_torch.configs import reduced_config
    from repro_torch.convert import lm_caches_from_reference
    from repro_torch.models import LM
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LM(reduced_config("llama3.2-1b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_caches_from_reference({"k": np.zeros((2, 3), np.float32)})
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


@pytest.mark.parametrize("cli", PORT_CLIS, ids=lambda p: p.name)
def test_port_clis_refuse_to_run_on_cpu_unasked(cli, tmp_path):
    """Without ``--device`` a port CLI means the card: with none visible it
    fails, naming the way to the CPU, and writes nothing."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    args = {"train_gnn_torch.py": ["--preset", "ppi-cpu", "--steps", "50",
                                   "--ckpt-dir", str(tmp_path)],
            "serve_gnn_torch.py": ["--preset", "ppi-cpu",
                                   "--train-steps", "50"],
            "serve_decode_torch.py": ["--arch", "llama3.2-1b"],
            "train_lm_torch.py": ["--arch", "llama3.2-1b", "--steps", "2"],
            "multipod_dryrun_torch.py": ["--arch", "llama3.2-1b", "--shape",
                                         "train_4k", "--single-pod"]}.get(
                cli.name, ["--preset", "ppi-cpu", "--steps", "50"])
    res = subprocess.run([sys.executable, str(cli), *args],
                         capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert "device='cpu'" in res.stderr
    assert not list(tmp_path.iterdir())
