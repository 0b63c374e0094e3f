"""The yardstick's FLOP and byte counts on batches small enough to count by
hand, and the per-layer readers on a hand-made traced run."""
import importlib.util
from pathlib import Path

import pytest

from perfbench import yardstick
from perfbench.reference import arch_gcn, arch_gcnii

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def _metric(name):
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"),
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_spmm_work_by_hand():
    # 3 rows of width 2 read and written (2 * 3 * 2 * 4 B), 4 edges of an
    # index and a weight (4 * 8 B); a multiply-add per edge and column
    assert yardstick.spmm_work(3, 4, 2) == (80, 16.0)


def test_compensate_work_by_hand():
    # 2 halo rows of width 3: store, fresh, out (3 * 2 * 3 * 4 B) and
    # gid, beta, mask (2 * 12 B); 5 operations an element
    assert yardstick.compensate_work(2, 3) == (96, 30.0)


def test_least_seconds_takes_the_larger_bound():
    assert yardstick.least_seconds(3.35e12, 0.0) == pytest.approx(1.0)
    assert yardstick.least_seconds(0.0, 67e12) == pytest.approx(1.0)
    assert yardstick.least_seconds(3.35e12, 134e12) == pytest.approx(2.0)


def test_gcn_step_flops_by_hand():
    cfg = {"feature_dim": 2, "hidden_dim": 3, "num_layers": 2,
           "num_classes": 4}
    rows, batch, edges = 5, 2, 6
    # layer 0 (2 -> 3): agg 2*6*2, self 2*5*2, gemm 2*5*2*3, weight grad
    # 2*5*2*3; layer 1 (3 -> 3): agg 2*6*3, self 2*5*3, gemm 2*5*3*3,
    # weight grad the same, input grad gemm the same + agg over A^T 2*6*3
    # + self 2*5*3; head: 2*5*3*4 forward, 2*2*3*4 weight grad,
    # 2*5*3*4 input grad
    want = (24 + 20 + 60 + 60) + (36 + 30 + 90 + 90 + 90 + 36 + 30) \
        + (120 + 48 + 120)
    assert arch_gcn.step_flops(cfg, rows, batch, edges) == want
    assert arch_gcn.spmm_widths(cfg) == [2, 3, 3]


def test_gcnii_step_flops_by_hand():
    cfg = {"feature_dim": 2, "hidden_dim": 3, "num_layers": 1,
           "num_classes": 4}
    rows, batch, edges = 5, 2, 6
    # embed 2*5*2*3 + weight grad 2*2*2*3; the layer: agg 2*6*3, self
    # 2*5*3, gemm 2*5*9, weight grad 2*5*9, input grad gemm 2*5*9, agg over
    # A^T 2*6*3, self 2*5*3; head as in GCN
    want = (60 + 24) + (36 + 30 + 90 + 90 + 90 + 36 + 30) \
        + (120 + 48 + 120)
    assert arch_gcnii.step_flops(cfg, rows, batch, edges) == want
    assert arch_gcnii.spmm_widths(cfg) == [3, 3]


def _train_record():
    cfg = {"arch": "gcn", "feature_dim": 2, "hidden_dim": 3,
           "num_layers": 2, "num_classes": 4}
    return {"kind": "train", "config": cfg,
            "steps": [{"time_s": 1.0, "host_s": 0.25},
                      {"time_s": 1.0, "host_s": 0.75}],
            "step_stats": [(2, 3, 6), (2, 3, 6)], "window_s": 2.0,
            "busy_s": 0.5, "peak_window_bytes": 2**31,
            "device_ops": {"void ell_spmm_kernel<F32>": 1e-6,
                           "void compensate_kernel<F32>": 2e-6,
                           "sgemm": 1.0},
            "build_ms": [3.0, 1.0, 2.0]}


def test_train_readers_on_a_made_record():
    rec = _train_record()
    assert _metric("trainer.batch_wait_share")(rec) == pytest.approx(50.0)
    assert _metric("host.batch_build_ms")(rec) == 2.0
    assert _metric("step.device_ms")(rec) == pytest.approx(250.0)
    assert _metric("device.idle_share.train")(rec) == pytest.approx(75.0)
    assert _metric("device.peak_mem_gib")(rec) == pytest.approx(2.0)
    flops = 2 * arch_gcn.step_flops(rec["config"], 5, 2, 6)
    assert _metric("step.mfu")(rec) == pytest.approx(
        100 * flops / (2.0 * yardstick.F32_FLOPS_PER_S))
    least = 2 * sum(yardstick.least_seconds(*yardstick.spmm_work(5, 6, w))
                    for w in (2, 3, 3))
    assert _metric("kernel.spmm_roofline")(rec) == pytest.approx(
        100 * least / 1e-6)
    least = 2 * 3 * yardstick.least_seconds(*yardstick.compensate_work(3, 3))
    assert _metric("kernel.compensate_roofline")(rec) == pytest.approx(
        100 * least / 2e-6)


def test_readers_find_nothing_to_read():
    rec = dict(_train_record(), busy_s=0.0, device_ops={})
    for name in ("step.device_ms", "step.mfu", "kernel.spmm_roofline",
                 "kernel.compensate_roofline", "device.idle_share.train"):
        assert _metric(name)(rec) is None, name
    serve = {"kind": "serve", "busy_s": 0.0, "window_s": 1.0, "batches": 0,
             "submitted": 0, "late_ms": []}
    for name in ("serve.requests_per_batch", "serve.infer_device_ms",
                 "device.idle_share.serve", "loadgen.late_p99_ms",
                 "trainer.batch_wait_share"):
        assert _metric(name)(serve) is None, name


def test_serve_readers_on_a_made_record():
    rec = {"kind": "serve", "busy_s": 0.5, "window_s": 2.0, "batches": 10,
           "submitted": 25, "late_ms": [float(i) for i in range(100)]}
    assert _metric("serve.requests_per_batch")(rec) == 2.5
    assert _metric("serve.infer_device_ms")(rec) == pytest.approx(50.0)
    assert _metric("device.idle_share.serve")(rec) == pytest.approx(75.0)
    assert _metric("loadgen.late_p99_ms")(rec) == 98.0
