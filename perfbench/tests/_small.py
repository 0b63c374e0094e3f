"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds:
arxiv-cpu (4,096 nodes), 8 parts, 2 clusters a batch, 64 wide.

``BENCHMARK.json`` holds no serving cell: the serving latencies spread too
widely from run to run on a shared host to hold any bound (PERF.md). The
cell's entries wait in ``serve_cell.json``, and the tests read them beside
the benchmark's, so the serving driver, its mix and its metric readers stay
tested until a serving cell comes back."""
from __future__ import annotations

import time
from pathlib import Path

import torch

from perfbench import harness

SERVE_CELL = Path(__file__).with_name("serve_cell.json")


def spec_with_serving() -> dict:
    """``BENCHMARK.json`` with the serving cell's entries added."""
    sp = harness.spec()
    extra = harness.load_json(SERVE_CELL)
    for key in ("workloads", "end_to_end", "per_layer"):
        have = {e["name"] for e in sp[key]}
        sp[key] = sp[key] + [e for e in extra[key] if e["name"] not in have]
    return sp


def small_ctx(workload: str, *, seed: int = 2**31 + 11,
              seconds: float = 1.0, trace: bool = False) -> harness.Ctx:
    cell, cfg, mix = harness.cell_files(spec_with_serving(), workload)
    cfg = dict(cfg, dataset="arxiv-cpu", hidden_dim=64, num_parts=8,
               clusters_per_batch=2, num_layers=min(cfg["num_layers"], 4),
               feature_dim=128, num_classes=40)
    if mix["driver"] == "serve":
        mix = dict(mix, rate_rps=20, warmup_s=0.5)
    return harness.Ctx(cell=cell, config=cfg, traffic=mix, seed=seed,
                       seconds=seconds, trace=trace,
                       device=torch.device("cpu"),
                       t_start=time.perf_counter())
