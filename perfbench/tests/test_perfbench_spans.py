"""The readers of the program's spans and counters: the median over the
window's step records that carry the field, and None where none does (a
program without the spans)."""
import pytest

from perfbench import harness

MiB = 2**20
STEPS = [
    {"step": 1, "time_s": 1.0, "host_s": 0.5,
     "slot": {"index": 0, "t_ns": (1, 2), "sample_ms": 300.0,
              "bucket_ms": 700.0, "pin_ms": 80.0, "copy_bytes": 540 * MiB,
              "copy_ms": 13.0},
     "device_ms": {"optimizer": 0.4, "commit": 0.2}},
    {"step": 2, "time_s": 1.0, "host_s": 0.5,
     "slot": {"index": 1, "t_ns": (3, 4), "sample_ms": 340.0,
              "bucket_ms": 760.0, "pin_ms": 100.0, "copy_bytes": 560 * MiB,
              "copy_ms": 15.0},
     "device_ms": {"optimizer": 0.6, "commit": 0.4}},
    {"step": 3, "time_s": 1.0, "host_s": 0.5,
     "slot": {"index": 2, "t_ns": (5, 6), "sample_ms": 320.0,
              "bucket_ms": 800.0, "pin_ms": 90.0, "copy_bytes": 550 * MiB,
              "copy_ms": 14.0},
     "device_ms": {"optimizer": 0.5}},   # no commit
    {"step": 4, "time_s": 1.0, "host_s": 0.5},         # a recycled step
]
WANT = {"pipeline.sample_ms": 320.0, "pipeline.bucket_ms": 760.0,
        "pipeline.pin_ms": 90.0, "pipeline.copy_ms": 14.0,
        "pipeline.copy_mib": 550.0, "step.optimizer_ms": 0.5,
        "step.commit_ms": 0.3}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reads_the_median_of_the_steps_that_carry_it(name):
    rec = {"kind": "train", "steps": STEPS}
    assert harness.read_metric(name, rec) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_none_without_the_fields(name):
    bare = [{k: s[k] for k in ("step", "time_s", "host_s")} for s in STEPS]
    assert harness.read_metric(name, {"kind": "train", "steps": bare}) is None
    assert harness.read_metric(name, {"kind": "train", "steps": []}) is None
    assert harness.read_metric(name, {"kind": "serve", "steps": STEPS}) \
        is None


def test_each_listed_in_the_benchmark():
    from perfbench.tests.test_perfbench_spec import SPEC
    listed = {m["name"]: m for m in SPEC["per_layer"]}
    for name in WANT:
        m = listed[name]
        assert m["moves"] == "train_nodes_per_s"
        assert m["workloads"] == ["gcnii-ppi.train"]
        twin = listed[name + ".host_paced"]
        assert twin["moves"] == "train_peak_mem_gib"
        assert twin["workloads"] == ["gcn-arxiv.train"]
        assert m["source"] == ("program_counter" if name.endswith("_mib")
                               else "program_span")


def test_a_traced_small_run_reads_the_host_spans(cache):
    """A traced training run at the CPU's size: the builders' spans and the
    batch bytes are read; pinning, the side-stream copy and the device
    spans exist only on a card, so their metrics are left out."""
    from perfbench.drivers import train
    from perfbench.tests._small import small_ctx
    res = train.run(small_ctx("gcn-arxiv.train", trace=True))
    assert res["correct"], res["checks"]
    got = {n: harness.read_metric(n, res["records"]) for n in WANT}
    assert {n for n, v in got.items() if v is not None} == {
        "pipeline.sample_ms", "pipeline.bucket_ms", "pipeline.copy_mib"}
    assert all(got[n] > 0 for n in ("pipeline.sample_ms",
                                    "pipeline.bucket_ms",
                                    "pipeline.copy_mib"))
