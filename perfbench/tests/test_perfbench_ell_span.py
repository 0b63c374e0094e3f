"""The reader of the device build of a slot's ELL buckets
(``pipeline.ell_ms``): the median over the window's step records that carry
it, and None for a serving record or a program without the span."""
import pytest

from perfbench import harness
from perfbench.tests.test_perfbench_spans import STEPS

ELL_MS = [1.2, 0.9, 1.5]   # the three fresh slots of STEPS, in order


def _steps():
    out = []
    for s, ms in zip(STEPS, ELL_MS + [None]):
        s = {**s}
        if ms is not None:
            s["slot"] = {**s["slot"], "ell_ms": ms, "ell_launches": 2}
        out.append(s)
    return out


def test_reads_the_median_of_the_slots_that_carry_it():
    rec = {"kind": "train", "steps": _steps()}
    assert harness.read_metric("pipeline.ell_ms", rec) == pytest.approx(1.2)


def test_none_for_serving_and_without_the_span():
    assert harness.read_metric("pipeline.ell_ms",
                               {"kind": "serve", "steps": _steps()}) is None
    assert harness.read_metric("pipeline.ell_ms",
                               {"kind": "train", "steps": STEPS}) is None
    assert harness.read_metric("pipeline.ell_ms",
                               {"kind": "train", "steps": []}) is None


def test_listed_in_the_benchmark_beside_the_build_spans():
    from perfbench.tests.test_perfbench_spec import SPEC
    listed = {m["name"]: m for m in SPEC["per_layer"]}
    m, bucket = listed["pipeline.ell_ms"], listed["pipeline.bucket_ms"]
    assert (m["source"], m["unit"], m["moves"]) == (
        "program_span", "ms", "train_nodes_per_s")
    assert m["layer"] == bucket["layer"]
    assert m["workloads"] == ["gcnii-ppi.train"]
    twin = listed["pipeline.ell_ms.host_paced"]
    assert (twin["layer"], twin["moves"], twin["workloads"]) == (
        m["layer"], "train_peak_mem_gib", ["gcn-arxiv.train"])
