"""The dry run's GNN-LMC cell (``repro_torch.launch.dryrun.run_gnn_cell``,
``--gnn``): the reference's cell at its own sizes, uncut — GCNII with
16·2^20 nodes, d = 512, 4 layers, 64 classes; per data rank 4096 batch
rows, 8192 halo rows and 262,144 edges — traced on meta tensors over a
fake world of 256 (16×16) or 512 (2×16×16) ranks, each in a subprocess.

Its argument bytes a device must equal the reference's record
``experiments/dryrun/gnn_lmc_16x16.json`` on 16×16, and the same count by
hand on both meshes (no record exists for 2×16×16). Every collective the
grid step issues (its row exchanges, the feature gather, the gradient
all-reduce) must read non-zero in the tally, the exchanges at the bytes of
the uniform owner spread the cell gives them.
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, DX, D, L, CLASSES = 16 * 2**20, 512, 512, 4, 64
NB, NH, NE = 4096, 8192, 262144
GCNII_PARAMS = 1_344_064
MESHES = {"16x16": (16, 16), "2x16x16": (32, 16)}   # (data ranks, model)


def _by_hand(ndp: int, nm: int) -> int:
    """Argument bytes a device: the stores' row and feature block, x and
    self_w's row block, one data rank's batch, the replicated parameters."""
    rows, feats = N // ndp, D // nm
    stores = (L + L - 1) * rows * feats * 4
    features = rows * DX * 4 + rows * 4
    ints = (NB + NH + 2 * NE + NB + NH) * 4          # gids, edges, labels
    floats = (NB + NH + NE + NB + NH + NH + 2) * 4   # masks, w, β, scales
    return stores + features + ints + floats + GCNII_PARAMS * 4


def _exchanged(ndp: int, nm: int) -> int:
    """All-to-all bytes a device: the gids (int64) and the rows of x,
    self_w, h and v (its feature block) of the fetch; the gids and h and v
    rows of the route."""
    fetch = (NB + NH) * (8 + DX * 4 + 4 + (2 * L - 1) * (D // nm) * 4)
    route = NB * (8 + (2 * L - 1) * (D // nm) * 4)
    return fetch + route


def _run(args) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, timeout=300, cwd=REPO)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """16×16 through the example script (its last line, JSON), 2×16×16
    through ``python -m repro_torch.launch.dryrun`` (its JSON file), at
    once."""
    out = tmp_path_factory.mktemp("gnn")
    with ThreadPoolExecutor(2) as ex:
        ex_run = ex.submit(_run, [
            "examples/multipod_dryrun_torch.py", "--gnn", "--single-pod",
            "--device", "cpu", "--json"])
        cli = ex.submit(_run, [
            "-m", "repro_torch.launch.dryrun", "--gnn", "--multi-pod",
            "--device", "cpu", "--out", str(out)])
        a, b = ex_run.result(), cli.result()
    assert a.returncode == 0, a.stderr[-3000:]
    assert b.returncode == 0, b.stderr[-3000:]
    return {"16x16": json.loads(a.stdout.strip().splitlines()[-1]),
            "2x16x16": json.loads((out / "gnn_lmc_2x16x16.json").read_text())}


def test_gnn_cell_16x16_argument_bytes_equal_the_reference_record(cells):
    with open(os.path.join(REPO, "experiments", "dryrun",
                           "gnn_lmc_16x16.json")) as f:
        ref = json.load(f)
    got = cells["16x16"]
    assert got["status"] == "ok" and got["shape"] == ref["shape"]
    assert got["memory"]["argument_bytes"] == \
        ref["memory"]["argument_bytes"] == 3_099_953_416


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_gnn_cell_argument_bytes_equal_the_count_by_hand(cells, mesh):
    want = {"16x16": 3_099_953_416, "2x16x16": 1_554_352_392}[mesh]
    assert _by_hand(*MESHES[mesh]) == want
    assert cells[mesh]["memory"]["argument_bytes"] == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_gnn_cell_counts_every_collective(cells, mesh):
    """Eight all-to-alls (the fetch: ids, x, self_w, h, v; the route: ids,
    h, v), the feature gather of h and v over ``model``, one all-reduce of
    the loss, counts and gradients over the rows."""
    ndp, nm = MESHES[mesh]
    coll, mem = cells[mesh]["collectives"], cells[mesh]["memory"]
    assert coll["num_ops"] == 11, coll
    assert coll["all-to-all"] == _exchanged(ndp, nm)
    assert coll["all-gather"] == (NB + NH) * (2 * L - 1) * D * 4
    assert coll["all-reduce"] == (3 + GCNII_PARAMS) * 4
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert cells[mesh]["flops"] > 0
