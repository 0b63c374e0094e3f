"""``gat-ppi.train`` at a size the CPU runs in seconds: three LMC steps of
``GNNTrainer`` on the pipeline path (the attention kernels' plain twins
over the ELL) against the plain reference's GAT; the cell's three
attention readers on records with and without the attention kernels; and
the training cells' readings under the cell's own names (``.gat``), each
reading what its base reads."""
import pytest

from perfbench import harness, yardstick
from perfbench.drivers import train
from perfbench.reference import arch_gat
from perfbench.tests._small import small_ctx
from perfbench.tests.test_perfbench_spec import SPEC

CELL = "gat-ppi.train"
# sound CPU runs read 0 to ~2e-7 (f32 sums in another order)
AGREE = 1e-5
NAMES = ("kernel.attention_roofline", "step.attention_ms",
         "step.attention_launches")
LISTED = {m["name"]: m for m in SPEC["per_layer"]}
TWINS = sorted(n for n in LISTED if n.endswith(".gat"))


def _base(name: str) -> str:
    """The reader a ``.gat`` twin reads through: the plain name, or its
    ``.host_paced`` twin where the plain name is an end-to-end metric."""
    base = name[:-len(".gat")]
    return base if base in LISTED else base + ".host_paced"


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The cell at the CPU's size, traced, at the agreement limits."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "CACHE", tmp_path_factory.mktemp("cache"))
        ctx = small_ctx(CELL, trace=True)
        ctx.config["limits"] = dict.fromkeys(ctx.config["limits"], AGREE)
        return train.run(ctx)


def test_gat_cell_agrees_with_the_reference(traced):
    assert traced["correct"], traced["checks"]
    assert traced["attempted"] >= 1 \
        and traced["e2e"]["train_nodes_per_s"] > 0


def test_the_gat_cell_reports_its_peak_and_its_own_readings():
    assert harness.end_to_end_names(SPEC, CELL) == [
        "train_peak_mem_gib", "setup_s"]
    assert set(harness.per_layer_names(SPEC, CELL)) == set(NAMES) | set(
        TWINS)
    assert {_base(n) for n in TWINS} >= {
        "step.mfu", "step.device_ms", "device.idle_share.train",
        "step.commit_ms", "train_nodes_per_s.host_paced"}


@pytest.mark.parametrize("name", TWINS)
def test_gat_twin_mirrors_its_base(name):
    base, twin = LISTED[_base(name)], LISTED[name]
    same = ("unit", "better", "source", "layer")
    assert {k: twin[k] for k in same} == {k: base[k] for k in same}
    assert twin["moves"] == "train_peak_mem_gib"
    assert twin["workloads"] == [CELL]
    assert CELL not in base["workloads"]


@pytest.mark.parametrize("name", TWINS)
def test_gat_twin_reads_as_its_base(name, traced):
    rec = traced["records"]
    assert harness.read_metric(name, rec) == harness.read_metric(
        _base(name), rec)
    assert harness.read_metric(name, {"kind": "serve", "steps": []}) is None


def _record(arch, launches, kernel_s):
    cfg = {"arch": arch, "feature_dim": 50, "hidden_dim": 1024,
           "num_layers": 3, "num_classes": 121,
           "arch_kw": {"heads": 4, "out_heads": 6}}
    steps = [{"step": i, "host_s": 0.0, "time_s": 0.1}
             | ({} if launches is None else {"attn_launches": launches})
             for i in range(4)]
    ops = {"volta_sgemm": 1.0}
    if kernel_s:
        ops["void (anonymous namespace)::gat_attn_fwd_kernel<8>(Fwd)"] = \
            kernel_s / 2
        ops["void (anonymous namespace)::gat_attn_src_kernel<4>(Bwd)"] = \
            kernel_s / 2
    return {"kind": "train", "config": cfg, "steps": steps,
            "device_ops": ops, "step_stats": [(7000, 26000, 620000)] * 4,
            "busy_s": 1.0, "window_s": 2.0}


@pytest.mark.parametrize("name", NAMES)
def test_attention_readers_read_nothing_without_the_kernels(name):
    for rec in (_record("gcn", None, 0.0), _record("gcn", 0, 0.0),
                _record("gat", None, 0.0)):
        assert harness.read_metric(name, rec) is None


def test_attention_readers_on_a_synthetic_record():
    rec = _record("gat", 15, 0.04)
    assert harness.read_metric("step.attention_launches", rec) == 15.0
    assert harness.read_metric("step.attention_ms", rec) == \
        pytest.approx(1e3 * 0.04 / 4)
    least = 0.0
    for heads, width, out, backwards in arch_gat.attention_widths(
            rec["config"]):
        args = (33000, 620000, heads, width, out)
        least += yardstick.least_seconds(*yardstick.attention_work(*args))
        least += backwards * yardstick.least_seconds(
            *yardstick.attention_vjp_work(*args))
    assert harness.read_metric("kernel.attention_roofline", rec) == \
        pytest.approx(100.0 * 4 * least / 0.04)
    assert 0 < harness.read_metric("kernel.attention_roofline", rec) <= 100
