"""The command refuses to run without a card, and the result line carries
the contract's keys, the cell's metrics only, and the checks last."""
import json
import os
import subprocess
import sys
from pathlib import Path

from perfbench import harness
from perfbench.run import result_line
from perfbench.tests._small import spec_with_serving

ROOT = Path(__file__).resolve().parents[2]


def test_no_card_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "gcn-arxiv.train",
         "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 2, res.stderr
    assert res.stdout.strip() == ""


class _Win:
    busy_s, window_s = 1.5, 2.0

    def breakdown(self):
        return {"device_ops": [["k", 1.5]], "idle_gaps": [["host: x", 0.5]]}


def _res(**kw):
    return {"correct": True, "attempted": 3, "failed": 0,
            "memory_peak_bytes": 7, "window": _Win(),
            "checks": {"loss": {"value": 0.0, "limit": 1e-5}},
            "e2e": {"train_nodes_per_s": 5.0, "train_peak_mem_gib": 4.0,
                    "setup_s": 2.0}, **kw}


def test_result_line_end_to_end():
    sp = harness.spec()
    line = result_line(sp, "gcnii-ppi.train", False, _res(), 1, "H100")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"train_nodes_per_s", "setup_s"}
    # the host-paced cell: its throughput is per-layer (PERF.md §2)
    arxiv = result_line(sp, "gcn-arxiv.train", False, _res(), 1, "H100")
    assert arxiv["metrics"] == {
        "train_peak_mem_gib": {"value": 4.0, "unit": "GiB"},
        "setup_s": {"value": 2.0, "unit": "s"}}
    assert line["device"] == {"platform": "gpu", "kind": "H100", "count": 1,
                              "memory_peak_bytes": 7}
    json.loads(json.dumps(line))


def test_result_line_traced_leaves_out_what_was_not_read():
    sp = spec_with_serving()
    rec = {"kind": "serve", "busy_s": 1.5, "window_s": 2.0, "batches": 4,
           "submitted": 8, "late_ms": []}
    line = result_line(sp, "gcn-arxiv.serve", True, _res(records=rec), 1,
                       "H100")
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"serve.requests_per_batch",
                                    "serve.infer_device_ms",
                                    "device.idle_share.serve"}
    assert line["device"]["busy_s"] == 1.5
    assert line["breakdown"]["idle_gaps"] == [["host: x", 0.5]]
