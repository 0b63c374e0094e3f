"""The port's format-2 checkpoint manager: the reference's own manager cases
(tests/test_supervisor.py, tests/test_fault_tolerance.py), then checkpoints
across packages — the port renders the reference's treedef string without
JAX, a checkpoint written by either trainer restores in the other and
continues within rtol 1e-5, and a reference checkpoint saved again by the
port is byte-identical."""
import json
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import graph as jgraph
from repro.core import LMC as J_LMC
from repro.models import make_gnn as j_make_gnn
from repro.optim import adamw as j_adamw
from repro.optim import sgd as j_sgd
from repro.train import GNNTrainer as JTrainer

from repro_torch import graph as tgraph
from repro_torch.checkpoint import (CheckpointError, CheckpointManager,
                                    crc32_array)
from repro_torch.checkpoint.manager import treedef_str, tree_unflatten
from repro_torch.optim import adamw, sgd, tree_leaves

from _torch_port import (NO_STRAGGLERS, PARTS, losses, port_trainer,
                         tiny_graph, tiny_parts)

LOSS = dict(rtol=1e-5, atol=0)


def _tree():
    return {"a": np.arange(10.0), "b": {"c": np.ones((3, 3))}}


# ------------------------------------------------------ the manager alone
def test_checkpoint_roundtrip_and_retention(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    for step in (10, 20, 30):
        cm.save(step, _tree(), {"step": step})
    assert cm.all_steps() == [20, 30] and cm.latest_step() == 30
    restored, extras, step = cm.restore(_tree())
    assert step == 30 and extras["step"] == 30
    np.testing.assert_array_equal(restored["a"], _tree()["a"])
    np.testing.assert_array_equal(restored["b"]["c"], _tree()["b"]["c"])


def test_corrupt_latest_truncated_leaf_falls_back(tmp_path):
    cm = CheckpointManager(tmp_path, keep=3)
    for s in (10, 20, 30):
        cm.save(s, _tree(), {"step": s})
    f = tmp_path / "step_0000000030" / "arr_0.npy"
    f.write_bytes(f.read_bytes()[:40])            # truncate
    restored, extras, step = cm.restore(_tree())
    assert step == 20 and extras["step"] == 20
    np.testing.assert_array_equal(restored["a"], _tree()["a"])
    assert not cm.verify(30) and cm.verify(20)


def test_corrupt_checksum_falls_back(tmp_path):
    cm = CheckpointManager(tmp_path, keep=3)
    for s in (10, 20):
        cm.save(s, _tree(), {"step": s})
    f = tmp_path / "step_0000000020" / "arr_1.npy"
    raw = bytearray(f.read_bytes())
    raw[-1] ^= 0xFF                               # bit-flip payload, same size
    f.write_bytes(bytes(raw))
    _, _, step = cm.restore(_tree())
    assert step == 10
    with pytest.raises(CheckpointError, match="checksum"):
        cm.restore(_tree(), step=20)


def test_mangled_manifest_falls_back(tmp_path):
    cm = CheckpointManager(tmp_path, keep=3)
    for s in (10, 20):
        cm.save(s, _tree(), {"step": s})
    (tmp_path / "step_0000000020" / "manifest.json").write_text("{not json")
    _, _, step = cm.restore(_tree())
    assert step == 10


def test_missing_leaf_raises_named_error(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(10, _tree(), {"step": 10})
    (tmp_path / "step_0000000010" / "arr_1.npy").unlink()
    with pytest.raises(CheckpointError, match=r"step 10.*arr_1\.npy"):
        cm.restore(_tree(), step=10)


def test_num_leaves_mismatch_raises_clear_error(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(10, _tree(), {"step": 10})
    bigger = {**_tree(), "d": np.zeros(4)}
    with pytest.raises(CheckpointError, match="2 leaves.*expects 3"):
        cm.restore(bigger, step=10)


def test_treedef_mismatch_raises(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(10, _tree(), {"step": 10})
    other = {"a": np.arange(10.0), "b": [np.ones((3, 3))]}
    with pytest.raises(CheckpointError, match="tree structure mismatch"):
        cm.restore(other, step=10)


def test_no_verifiable_checkpoint_raises(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(10, _tree(), {"step": 10})
    f = tmp_path / "step_0000000010" / "arr_0.npy"
    f.write_bytes(f.read_bytes()[:10])
    with pytest.raises(CheckpointError, match="no verifiable checkpoint"):
        cm.restore(_tree())


def test_orphaned_tmp_dir_gc(tmp_path):
    orphan = tmp_path / "step_0000000099.tmp.abc123"
    orphan.mkdir(parents=True)
    (orphan / "arr_0.npy").write_bytes(b"partial")
    cm = CheckpointManager(tmp_path)               # init-time GC
    assert not orphan.exists()
    orphan2 = tmp_path / "step_0000000098.tmp.xyz"
    orphan2.mkdir()
    cm.save(10, _tree(), {"step": 10})             # post-save GC
    assert not orphan2.exists()
    assert cm.all_steps() == [10]


def test_manifest_records_leaf_metadata(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(10, _tree(), {"step": 10})
    man = json.loads((tmp_path / "step_0000000010" / "manifest.json")
                     .read_text())
    assert man["format"] == 2 and man["num_leaves"] == 2
    assert man["treedef"] == "PyTreeDef({'a': *, 'b': {'c': *}})"
    assert [m["shape"] for m in man["leaves"]] == [[10], [3, 3]]
    assert [m["dtype"] for m in man["leaves"]] == ["float64", "float64"]
    arr = np.load(tmp_path / "step_0000000010" / "arr_0.npy")
    assert man["leaves"][0]["crc32"] == crc32_array(arr) == \
        zlib.crc32(np.ascontiguousarray(arr).tobytes())


def test_legacy_manifest_still_restores(tmp_path):
    """Format-1 manifests (no leaf metadata, no treedef) restore without
    verification."""
    cm = CheckpointManager(tmp_path)
    cm.save(10, _tree(), {"step": 10})
    mpath = tmp_path / "step_0000000010" / "manifest.json"
    man = json.loads(mpath.read_text())
    del man["leaves"], man["format"], man["treedef"]
    mpath.write_text(json.dumps(man))
    restored, _, step = cm.restore(_tree())
    assert step == 10
    np.testing.assert_array_equal(restored["b"]["c"], np.ones((3, 3)))


def test_async_save_byte_identical(tmp_path):
    tree = {**_tree(), "t": torch.arange(6, dtype=torch.float32)}
    sync = CheckpointManager(tmp_path / "sync")
    sync.save(5, tree, {"step": 5})
    asy = CheckpointManager(tmp_path / "async")
    asy.save(5, tree, {"step": 5}, background=True)
    asy.wait()
    sdir, adir = tmp_path / "sync/step_0000000005", \
        tmp_path / "async/step_0000000005"
    files = sorted(p.name for p in sdir.iterdir())
    assert files == sorted(p.name for p in adir.iterdir())
    for name in files:
        assert (sdir / name).read_bytes() == (adir / name).read_bytes()
    assert set(asy.times[-1]) == {"step", "snapshot", "crc32", "np_save"}
    asy.close()


def test_async_save_failure_surfaces_on_wait(tmp_path):
    def hook(step, phase):
        if phase == "manifest":
            raise OSError("disk full (injected)")
    cm = CheckpointManager(tmp_path, fault_hook=hook)
    cm.save(5, _tree(), {}, background=True)
    with pytest.raises(OSError, match="disk full"):
        cm.wait()
    assert cm.all_steps() == [] and not list(tmp_path.glob("*.tmp.*"))
    cm.close()


@pytest.mark.parametrize("call", ["save", "close"])
def test_async_save_failure_surfaces_on_next_call(tmp_path, call):
    def hook(step, phase):
        if step == 5 and phase == "leaf_1":
            raise OSError("injected")
    cm = CheckpointManager(tmp_path, fault_hook=hook)
    cm.save(5, _tree(), {}, background=True)
    with pytest.raises(OSError, match="injected"):
        cm.save(6, _tree(), {}) if call == "save" else cm.close()
    cm.close()
    assert not list(tmp_path.glob("*.tmp.*"))


def test_async_snapshot_of_a_cpu_tensor_is_a_copy(tmp_path):
    """``Tensor.numpy()`` shares a CPU tensor's memory; the background write
    must see the values at ``save``, not the ones written after it."""
    t = torch.zeros(1 << 16)
    cm = CheckpointManager(tmp_path)
    cm.save(1, {"t": t}, {}, background=True)
    t.fill_(1.0)
    cm.close()
    assert cm.verify(1)
    tree, _, _ = cm.restore({"t": t})
    assert not tree["t"].any()


# --------------------------------------------------------- the treedef
@pytest.mark.parametrize("tree", [
    _tree(), {"x": [1, 2], "y": (3, 4), "z": {}}, {"k": (5,)}, [{"a": 1}],
    {"n": None, "m": [None, 2]}, 7],
    ids=["nested", "list-tuple-empty", "one-tuple", "list", "none", "leaf"])
def test_treedef_str_equals_jax(tree):
    assert treedef_str(tree) == str(jax.tree.structure(tree))
    leaves = jax.tree.leaves(tree)
    assert tree_unflatten(tree, leaves) == tree


# ----------------------------------------------------- across packages
@pytest.fixture(scope="module")
def graphs():
    return tiny_graph(jgraph), tiny_graph(tgraph), tiny_parts()


def _pair(graphs, tmp_path, arch="gcn", opt="sgd"):
    """(reference trainer, port trainer) from the same parameters, sharing
    one checkpoint directory."""
    jgr, tgr, parts = graphs
    gnn = j_make_gnn(arch, jgr.feature_dim, 16, jgr.num_classes, 2)
    params = jax.tree.map(np.asarray, gnn.init_params(jax.random.key(0)))
    jopt, topt = ((j_sgd(lr=0.2), sgd(lr=0.2)) if opt == "sgd"
                  else (j_adamw(lr=0.01), adamw(lr=0.01)))
    jt = JTrainer(gnn, J_LMC, jgr,
                  jgraph.ClusterSampler(jgr, PARTS, 1, parts=parts, seed=1),
                  jopt, seed=0, ckpt_dir=str(tmp_path),
                  straggler_deadline=NO_STRAGGLERS)
    tt = port_trainer(tgr, parts, str(tmp_path), arch=arch, params=params,
                      optimizer=topt)
    return jt, tt


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
@pytest.mark.parametrize("arch", ["gcn", "gcnii", "sage", "gin"])
def test_treedef_matches_reference_trainer(graphs, tmp_path, arch, opt):
    jt, tt = _pair(graphs, tmp_path, arch, opt)
    assert treedef_str(tt._state_tree()) == \
        str(jax.tree.structure(jt._state_tree()))
    assert [tuple(x.shape) for x in jax.tree.leaves(jt._state_tree())] == \
        [tuple(x.shape) for x in tree_leaves(tt._state_tree())]


def _last5(tr):
    got = losses(tr)
    return [got[s] for s in sorted(got)[-5:]]


@pytest.mark.parametrize("arch,opt", [("gcn", "sgd"), ("sage", "adamw")])
def test_reference_checkpoint_restores_in_the_port(graphs, tmp_path, arch,
                                                   opt):
    jt, tt = _pair(graphs, tmp_path, arch, opt)
    jt.run(6)
    jt.save()
    assert tt.restore() and tt.step_num == 6 and tt.lr == jt.lr
    jt.run(5)
    tt.run(5)
    np.testing.assert_allclose(_last5(tt), _last5(jt), **LOSS)


@pytest.mark.parametrize("arch,opt", [("gcn", "sgd"), ("sage", "adamw")])
def test_port_checkpoint_restores_in_the_reference(graphs, tmp_path, arch,
                                                   opt):
    jt, tt = _pair(graphs, tmp_path, arch, opt)
    tt.run(6)
    tt.save()
    assert jt.restore() and jt.step_num == 6
    tt.run(5)
    jt.run(5)
    np.testing.assert_allclose(_last5(jt), _last5(tt), **LOSS)


def test_port_resaves_a_reference_checkpoint_byte_for_byte(graphs, tmp_path):
    jt, _ = _pair(graphs, tmp_path / "ref")
    jt.run(4)
    jt.save()
    _, tt = _pair(graphs, tmp_path / "port")
    tt.ckpt = CheckpointManager(tmp_path / "ref")
    assert tt.restore()
    tt.ckpt = CheckpointManager(tmp_path / "port")
    tt.save()
    ref, port = (Path(tmp_path / d / "step_0000000004") for d in ("ref",
                                                                  "port"))
    names = sorted(p.name for p in ref.iterdir())
    assert names == sorted(p.name for p in port.iterdir())
    for name in names:
        if name.startswith("arr_"):
            assert (ref / name).read_bytes() == (port / name).read_bytes(), \
                name
    assert json.loads((ref / "manifest.json").read_text()) == \
        json.loads((port / "manifest.json").read_text())
