"""``step.spmm_launches``: the ELL SpMM launches of a step, the median of
the window's step records' ``spmm_launches``, read on the device-paced
cell alone; None on records without the field (a program without the
counter) and on serving records."""
import pytest

from perfbench import harness
from perfbench.tests.test_perfbench_spec import SPEC

NAME = "step.spmm_launches"
CELL = "gcnii-ppi.train"
LISTED = {m["name"]: m for m in SPEC["per_layer"]}


def _record(launches):
    steps = [{"step": i, "host_s": 0.0, "time_s": 0.5}
             | ({} if n is None else {"spmm_launches": n})
             for i, n in enumerate(launches)]
    return {"kind": "train", "steps": steps}


def test_listed_on_the_device_paced_cell_alone():
    m = LISTED[NAME]
    assert m["workloads"] == [CELL]
    assert (m["unit"], m["better"], m["source"], m["moves"]) == (
        "count", "lower", "program_counter", "train_nodes_per_s")
    assert m["layer"] == LISTED["kernel.spmm_roofline"]["layer"]
    assert NAME in harness.per_layer_names(SPEC, CELL)
    for cell in ("gcn-arxiv.train", "gat-ppi.train"):
        assert NAME not in harness.per_layer_names(SPEC, cell)


@pytest.mark.parametrize("launches,want", [
    ([54, 54, 54], 54.0),
    ([81, 54, 54, 54], 54.0),
    ([None, 54, 55], 54.5),   # steps without the field are left out
    ([0, 0], 0.0),            # the plain twins: no kernel launched
])
def test_reads_the_median_of_the_steps(launches, want):
    assert harness.read_metric(NAME, _record(launches)) == want


def test_none_without_the_field_or_off_training():
    assert harness.read_metric(NAME, _record([None, None])) is None
    assert harness.read_metric(NAME, _record([])) is None
    assert harness.read_metric(
        NAME, {"kind": "serve", "steps": _record([54])["steps"]}) is None


def test_a_small_traced_run_reads_the_twins_zero(cache):
    """The cell at the CPU's size on the program: every step carries the
    count, 0 where the wrappers ran their plain twins."""
    from perfbench.drivers import train
    from perfbench.tests._small import small_ctx
    res = train.run(small_ctx(CELL, trace=True))
    assert res["correct"], res["checks"]
    steps = res["records"]["steps"]
    assert steps and all(s["spmm_launches"] == 0 for s in steps)
    assert harness.read_metric(NAME, res["records"]) == 0.0
