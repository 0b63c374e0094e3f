"""BENCHMARK.json keeps to the contract's shape, and every file a cell
needs is found by its name; so do the serving cell's entries that wait
beside it (``serve_cell.json``)."""
import json
import re
from pathlib import Path

import pytest

from perfbench.tests._small import spec_with_serving

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
FULL = spec_with_serving()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _names():
    out = [c["name"] for c in FULL["configs"]]
    out += [k for c in FULL["configs"] for k in c["reduced"]]
    for w in FULL["workloads"]:
        out += [w["name"], w["config"], w["traffic"]]
    out += [m["name"] for m in FULL["end_to_end"] + FULL["per_layer"]]
    return out


@pytest.mark.parametrize("name", _names())
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", FULL["end_to_end"] + FULL["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    from perfbench import harness
    assert UNIT.match(metric["unit"]), metric
    assert metric["better"] in ("lower", "higher")
    assert set(metric) <= {"name", "unit", "better", "bound", "source",
                           "layer", "moves", "workloads"}
    cells = {w["name"] for w in FULL["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        e2e = {m["name"] for m in FULL["end_to_end"]}
        assert metric["moves"] in e2e
        # each lists its cells, and each of them reports what it moves
        assert metric["workloads"]
        for cell in metric["workloads"]:
            assert metric["moves"] in harness.end_to_end_names(FULL, cell)
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]


def test_top_level_and_budget():
    assert set(SPEC) == TOP
    assert SPEC["command"][1].startswith(SPEC["paths"][0] + "/")
    assert 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) \
        == len(SPEC["workloads"])
    assert len(json.dumps(SPEC)) < 64 * 1024
    # the benchmark's own metrics name only its own cells and metrics
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", [])) <= cells, m["name"]
    assert {m["moves"] for m in SPEC["per_layer"]} <= e2e


@pytest.mark.parametrize("cell", FULL["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(cell):
    from perfbench import harness
    _, cfg, mix = harness.cell_files(FULL, cell["name"])
    bench = ROOT / "perfbench"
    assert (bench / "drivers" / f"{mix['driver']}.py").is_file()
    assert (bench / "reference" / f"arch_{cfg['arch']}.py").is_file()
    e2e = harness.end_to_end_names(FULL, cell["name"])
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.per_layer_names(FULL, cell["name"])
    assert layer
    for name in layer:
        assert (bench / "metrics" / f"{name}.py").is_file(), name
    conf = {c["name"]: c for c in FULL["configs"]}[cell["config"]]
    assert conf["file"].startswith(FULL["paths"][0] + "/")
    assert set(cfg["limits"]) >= ({"logits"} if mix["driver"] == "serve"
                                  else {"loss", "grad", "update", "store"})
