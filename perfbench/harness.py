"""What every cell shares: the spec, the files found by name, the data and
weights made from the seed, the profiler's window, and the result line.

Nothing here imports the program; the drivers do, after the harness has
found a card. Caches live in ``build/perfbench/`` inside the checkout, at
fixed paths.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "perfbench"
CACHE = ROOT / "build" / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def set_cache_dirs() -> None:
    """Point every compiler and kernel cache a run may touch at fixed
    directories inside the checkout (the program builds its own CUDA
    libraries into ``build/repro_torch/``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> dict:
    """A JSON file's object."""
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    """``BENCHMARK.json`` at the checkout's root."""
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(sp: dict, workload: str) -> tuple:
    """``(cell, config, traffic)`` of a workload, each found by name."""
    cells = {w["name"]: w for w in sp["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; cells: "
                       f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in sp["configs"]}[cell["config"]]
    return (cell, load_json(ROOT / conf["file"]),
            load_json(BENCH / "traffic" / f"{cell['traffic']}.json"))


def end_to_end_names(sp: dict, workload: str) -> list:
    """The end-to-end metrics a cell reports."""
    return [m["name"] for m in sp["end_to_end"]
            if workload in m.get("workloads", [workload])]


def per_layer_names(sp: dict, workload: str) -> list:
    """The per-layer metrics a cell reports: those listing it."""
    return [m["name"] for m in sp["per_layer"] if workload in m["workloads"]]


def read_metric(name: str, records: dict) -> Optional[float]:
    """``metrics/<name>.py``'s ``read(records)``: a number, or None when the
    run holds nothing for it to read."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(records)


def forbidden_modules(names=None) -> list:
    """Top-level names of loaded modules (or of ``names``) that the run must
    not hold (JAX and the JAX package), compared whole: ``repro_torch`` is
    not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


# --------------------------------------------------------------- inputs
def dataset(preset: str) -> dict:
    """The preset's graph (seed 0, fixed), generated once per checkout by
    the frozen generator and cached as arrays."""
    from perfbench.data.sbm import make_sbm
    path = CACHE / "data" / f"{preset}-seed0.npz"
    if path.exists():
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    arrays = make_sbm(preset, seed=0)
    _save(path, lambda f: np.savez(f, **arrays))
    return arrays


def cached_array(name: str, make) -> np.ndarray:
    """``make()`` computed once per checkout and kept in the cache."""
    path = CACHE / "reference" / f"{name}.npy"
    if path.exists():
        return np.load(path)
    arr = make()
    _save(path, lambda f: np.save(f, arr))
    return arr


def _save(path: Path, write) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


def norm_seed(seed: int) -> int:
    """Any whole number as a non-negative 63-bit seed."""
    return int(seed) % (1 << 63)


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Initial parameters by name (``arch_<arch>.leaves``): glorot-uniform
    weights from one ``torch.rand`` on ``device`` seeded by ``seed``, zero
    biases, f32 (the configurations' type)."""
    import torch
    from perfbench.reference.lmc import arch_module
    leaves = arch_module(cfg["arch"]).leaves(cfg)
    gen = torch.Generator(device=device).manual_seed(norm_seed(seed))
    total = sum(int(np.prod(s)) for _, s, init in leaves if init == "glorot")
    u = torch.rand(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, init in leaves:
        if init == "zeros":
            out[name] = torch.zeros(shape, device=device)
            continue
        k = int(np.prod(shape))
        lim = (6.0 / (shape[-2] + shape[-1])) ** 0.5
        out[name] = ((u[off:off + k] * 2 - 1) * lim).reshape(shape)
        off += k
    return out


def flat(tree, prefix: str = "") -> dict:
    """A nested dict/list parameter tree as ``{"layers.w.0": tensor}``."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flat(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


# ------------------------------------------------------------- context
@dataclasses.dataclass
class Ctx:
    """One run: the cell's files, the arguments, the device, process start."""
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float


# --------------------------------------------------------------- trace
class Window:
    """The measured window: host clock always; with ``trace`` the profiler
    over it, read afterwards into ``busy_s`` (union of the device's op
    intervals inside the window), ``device_ops`` (seconds by op name) and
    ``idle_gaps`` (the longest gaps between device ops, named by the host op
    that was running on the window's thread)."""

    def __init__(self, trace: bool, device):
        self.trace, self.device = trace, device
        self.busy_s = self.window_s = 0.0
        self.device_ops: dict = {}
        self.idle_gaps: list = []

    def __enter__(self):
        import torch
        self._cuda = self.device.type == "cuda"
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self._cuda else [])
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._span = torch.profiler.record_function("perfbench.window")
            self._span.__enter__()
        if self._cuda:
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        if self._cuda:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.window_s = self.t1 - self.t0
        if self.trace:
            self._span.__exit__(*exc)
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self._read()
        return False

    def _read(self) -> None:
        import torch
        evs = self._prof.profiler.kineto_results.events()
        win = [e for e in evs if e.name() == "perfbench.window"]
        lo, hi = win[0].start_ns(), win[0].end_ns()
        thread = win[0].start_thread_id()
        dev, host = [], []
        for e in evs:
            if e.is_user_annotation() or e.name().startswith("perfbench."):
                continue
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                s, t = max(e.start_ns(), lo), min(e.end_ns(), hi)
                if t > s:
                    dev.append((s, t, e.name()))
            elif e.start_thread_id() == thread:
                host.append((e.start_ns(), e.end_ns(), e.name()))
        ops: dict = {}
        for s, t, name in dev:
            ops[name] = ops.get(name, 0.0) + (t - s) * 1e-9
        self.device_ops = ops
        merged = []
        for s, t, _ in sorted(dev):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        self.busy_s = sum(t - s for s, t in merged) * 1e-9
        gaps, prev = [], lo
        for s, t in merged + [[hi, hi]]:
            if s > prev:
                gaps.append((s - prev, prev, s))
            prev = max(prev, t)
        gaps = sorted(gaps, reverse=True)[:10]
        host.sort()
        self.idle_gaps = [[_host_op(host, (a + b) // 2), g * 1e-9]
                          for g, a, b in gaps]
        self.window_s = (hi - lo) * 1e-9

    def breakdown(self) -> dict:
        """The result line's ``breakdown``: the ten device ops that took
        most time and the ten longest idle gaps."""
        top = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in top],
                "idle_gaps": self.idle_gaps}


def _host_op(host: list, t: int) -> str:
    """The innermost host op on the window's thread running at ``t``."""
    best = None
    for s, e, name in host:
        if s > t:
            break
        if e >= t:
            best = name
    return f"host: {best}"[:120] if best else "host: python (no op)"


# -------------------------------------------------------------- result
def percentile(values, q: float) -> float:
    """Nearest-rank percentile (``inf`` sorts last: a missed request)."""
    v = sorted(values)
    return v[max(0, int(np.ceil(q * len(v))) - 1)]


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every number finite and at most its limit."""
    checks = {k: {"value": float(v), "limit": limits.get(k)}
              for k, v in numbers.items()}
    ok = bool(checks) and all(
        c["limit"] is not None and np.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
