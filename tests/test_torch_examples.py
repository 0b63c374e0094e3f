"""The port's CLIs (``examples/*_torch.py``) end to end in a fresh
interpreter on the CPU: exit 0, their headline lines, and a resume from the
first run's checkpoint."""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _run(script, *args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, str(REPO / "examples" / script), *args],
        capture_output=True, text=True, timeout=timeout, env=env)
    assert res.returncode == 0, \
        f"{script} exited {res.returncode}:\n{res.stdout}\n{res.stderr}"
    return res.stdout


def test_quickstart_torch_smoke():
    out = _run("quickstart_torch.py", "--device", "cpu", "--preset",
               "ppi-cpu", "--steps", "50")
    assert "=== lmc ===" in out and "=== cluster ===" in out
    assert out.count("final test acc:") == 3


def test_train_gnn_torch_resumes(tmp_path):
    args = ["--device", "cpu", "--preset", "ppi-cpu", "--backend", "ell",
            "--health", "--async-ckpt", "--ckpt-dir", str(tmp_path)]
    first = _run("train_gnn_torch.py", *args, "--steps", "40")
    assert "resumed" not in first and "step    40" in first
    assert "done: test acc" in first
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_0000000040"]
    second = _run("train_gnn_torch.py", *args, "--steps", "60")
    assert "resumed from checkpoint at step 40" in second
    assert "step    60" in second and "done: test acc" in second
    assert not list(tmp_path.glob("*.tmp.*"))


def test_train_gnn_torch_rejects_recycle_without_pipeline(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    res = subprocess.run(
        [sys.executable, str(REPO / "examples" / "train_gnn_torch.py"),
         "--device", "cpu", "--no-prefetch", "--recycle", "2",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode == 2 and "--no-prefetch is incompatible" in res.stderr


def test_serve_gnn_torch_smoke():
    out = _run("serve_gnn_torch.py", "--device", "cpu", "--requests", "8",
               "--qps", "50", "--train-steps", "20")
    assert "server up:" in out
    assert "'ok': 8" in out
    assert "drain clean: True" in out


def test_serve_gnn_torch_fault_smoke():
    out = _run("serve_gnn_torch.py", "--device", "cpu", "--fault",
               "--requests", "24", "--qps", "80", "--train-steps", "20")
    assert "server events:" in out
    assert "drain clean: True" in out
    assert "pending after drain: 0" in out


def test_serve_decode_torch_smoke():
    out = _run("serve_decode_torch.py", "--device", "cpu", "--arch",
               "zamba2-1.2b", "--batch", "2", "--prompt-len", "8",
               "--tokens", "4")
    assert "prefill 2x8:" in out
    assert "decoded 4 tokens/seq in" in out and "tok/s total" in out
    assert out.count("  seq") == 2


def test_train_lm_torch_smoke():
    """A reduced zamba2 (hybrid: Mamba2 groups and the shared attention
    block, 4 microbatches) for a few steps on the CPU."""
    out = _run("train_lm_torch.py", "--device", "cpu", "--arch",
               "zamba2-1.2b", "--steps", "3", "--batch", "4", "--seq", "32")
    assert "zamba2-1.2b (reduced):" in out and "optimizer=adamw" in out
    assert "step    0  loss" in out and "step    2  loss" in out
    assert "loss should decrease" in out


def test_train_lm_torch_refuses_a_batch_the_microbatches_cannot_split():
    """examples/train_lm.py's default --batch 8 against deepseek-v3's 16
    microbatches: the reference fails inside a reshape, the port names
    both numbers."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    res = subprocess.run(
        [sys.executable, str(REPO / "examples" / "train_lm_torch.py"),
         "--device", "cpu", "--arch", "deepseek-v3-671b", "--steps", "1"],
        capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode != 0
    assert "batch of 8 rows" in res.stderr and "microbatches=16" in res.stderr
