"""The host-paced training cell (PERF.md §2): its throughput spreads with
the shared host too widely to hold a bound, so it reports the training's
device memory peak end to end, and its throughput and every per-layer
reading of the training cells under names of their own (``.host_paced``)
whose ``moves`` names that peak. Each such reader reads exactly what its
base does."""
import pytest

from perfbench import harness
from perfbench.tests.test_perfbench_spec import SPEC

HOST_PACED = "gcn-arxiv.train"
LISTED = {m["name"]: m for m in SPEC["per_layer"]}
TWINS = sorted(n for n in LISTED if n.endswith(".host_paced")
               and n[:-len(".host_paced")] in LISTED)
E2E = {m["name"]: m for m in SPEC["end_to_end"]}


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """A traced training run at the CPU's size: real records to read."""
    from perfbench.drivers import train
    from perfbench.tests._small import small_ctx
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "CACHE", tmp_path_factory.mktemp("cache"))
        res = train.run(small_ctx(HOST_PACED, trace=True))
    assert res["correct"], res["checks"]
    return res


def test_the_host_paced_cell_reports_its_peak_not_its_pace():
    assert harness.end_to_end_names(SPEC, HOST_PACED) == [
        "train_peak_mem_gib", "setup_s"]
    assert HOST_PACED not in E2E["train_nodes_per_s"]["workloads"]
    mem = E2E["train_peak_mem_gib"]
    assert (mem["unit"], mem["better"], mem["bound"]) == ("GiB", "lower",
                                                          0.01)
    assert set(harness.per_layer_names(SPEC, HOST_PACED)) == set(TWINS) | {
        "train_nodes_per_s.host_paced"}


@pytest.mark.parametrize("name", TWINS)
def test_twin_mirrors_its_base(name):
    base = LISTED[name[:-len(".host_paced")]]
    twin = LISTED[name]
    same = ("unit", "better", "source", "layer")
    assert {k: twin[k] for k in same} == {k: base[k] for k in same}
    assert twin["moves"] == "train_peak_mem_gib"
    assert twin["workloads"] == [HOST_PACED]
    assert HOST_PACED not in base["workloads"]


@pytest.mark.parametrize("name", TWINS)
def test_twin_reads_as_its_base(name, traced):
    rec = traced["records"]
    assert harness.read_metric(name, rec) == harness.read_metric(
        name[:-len(".host_paced")], rec)
    serve = {"kind": "serve", "steps": []}
    assert harness.read_metric(name, serve) is None


def test_throughput_reads_the_windows_nodes(traced):
    rec = traced["records"]
    got = harness.read_metric("train_nodes_per_s.host_paced", rec)
    assert got == pytest.approx(traced["e2e"]["train_nodes_per_s"])
    assert got > 0
    assert harness.read_metric("train_nodes_per_s.host_paced",
                               dict(rec, steps=[])) is None
    assert harness.read_metric("train_nodes_per_s.host_paced",
                               {"kind": "serve", "steps": rec["steps"]}) \
        is None
