"""Port parity, distributed LMC on a row × feature process grid: the stores
split over ``data`` (rows) and ``model`` (features), as the reference's
``spmd_shardings`` places them.

Spawned gloo ranks (``tests/_torch_grid.py``, joined on progress by
``tests/_torch_ranks.py``) run ``make_distributed_train_step`` with a row
group and a feature group from a ``DeviceMesh`` (``dist.mesh.grid_groups``);
rank (r, c) holds ``(L, n_r, d_c)`` of each store. Graph, model and
clusters are the reference test's (tests/test_distributed.py:11-49):
``ppi-cpu`` seed 3, 8 parts, GCN 2×32, one cluster per data rank.

Bars (those of the row-sharded step on the card): loss rtol 1e-4 and
every gradient leaf 2e-4 in norm against the plain step on the stacked
batch; the committed h and v bit for bit against the plain step of each
data rank's cluster, committed; the (4, 1) grid bit for bit against the
1-D row step. Against the reference's step jitted on a (2, 2) ``data`` ×
``model`` mesh, its own bars (loss 1e-4, gradients and stores rtol 2e-3,
atol 2e-4). A checkpoint saved under (2, 2)
restores to (4, 1) and to one process, at the bars of
tests/test_torch_distributed.py's resharded restore.
"""
import concurrent.futures as cf
import json

import jax
import numpy as np
import pytest
import torch

from repro import graph as jgraph
from repro.models import make_gnn as j_make_gnn

from _spmd import run_spmd
from _torch_dist import HIDDEN, LAYERS, LR, batch_of, setup
from _torch_grid import run_grid
from repro_torch.checkpoint import CheckpointManager, reshard
from repro_torch.core import (LMC, HistoricalState, commit_rows, host_batch,
                              make_train_step)
from repro_torch.core.distributed import (commit_owned_rows,
                                          make_distributed_train_step,
                                          stack_batches)
from repro_torch.convert import params_from_reference, state_from_reference
from repro_torch.dist import lmc_placement, row_block
from repro_torch.optim import sgd, tree_leaves, tree_map

LOSS_RTOL, LEAF_RTOL = 1e-4, 2e-4
TOL = dict(rtol=2e-4, atol=1e-6)
GRIDS = {"2x2": ((2, 2), "segment"), "4x1": ((4, 1), "ell")}
RESUME = [2, 3, 4, 5]      # the clusters of the step after the checkpoint

REFERENCE = """
    import json
    import numpy as np, jax, jax.numpy as jnp
    from repro.graph import make_sbm_dataset, partition_graph, ClusterSampler
    from repro.core import make_train_step, from_graph, LMC
    from repro.core.distributed import stack_batches, spmd_shardings
    from repro.core.history import HistoricalState
    from repro.launch.mesh import make_mesh
    from repro.models import make_gnn

    path = json.loads(%r)
    inp = np.load(path + "/in.npz")
    g = make_sbm_dataset("ppi-cpu", seed=3)
    data = from_graph(g)
    parts = partition_graph(g, 8, seed=0)
    gnn = make_gnn("gcn", g.feature_dim, 32, g.num_classes, 2)
    params = gnn.init_params(jax.random.key(0))
    s = ClusterSampler(g, 8, 1, parts=parts, seed=1)
    flat = stack_batches([s.build_batch(np.array([d])) for d in (0, 1)])
    step = make_train_step(gnn, LMC, g.num_nodes)
    store = HistoricalState(jnp.asarray(inp["h0"]), jnp.asarray(inp["v0"]))

    # 2 data shards x 2 model shards: the stores' features over "model"
    mesh = make_mesh((2, 2), ("data", "model"))
    bsh, ssh, xsh, swsh, psh = spmd_shardings(mesh)
    store_sh = HistoricalState(h=ssh["h"], v=ssh["v"])
    params_sh = jax.tree.map(lambda _: psh, params)
    with mesh:
        jstep = jax.jit(step, in_shardings=(params_sh, store_sh, bsh, xsh,
                                            swsh))
        loss, grads, st, _ = jstep(params, store, flat, data.x, data.self_w)
    leaves = [np.asarray(a) for a in jax.tree.leaves(grads)]
    np.savez(path + "/out.npz", loss=np.asarray(loss), h=np.asarray(st.h),
             v=np.asarray(st.v), **{f"g{i}": a for i, a in enumerate(leaves)})
    print("GRID-REF-OK")
"""


def _norm_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(tree) -> list:
    return [np.asarray(t.detach() if isinstance(t, torch.Tensor) else t,
                       np.float32) for t in tree_leaves(tree)]


@pytest.fixture(scope="module")
def world():
    """The reference's parameters (as numpy), random non-zero stores, and
    the port's graph, sampler, GNN and full-graph data."""
    jg = jgraph.make_sbm_dataset("ppi-cpu", seed=3)
    jgnn = j_make_gnn("gcn", jg.feature_dim, HIDDEN, jg.num_classes, LAYERS)
    jp = jax.tree.map(np.asarray, jgnn.init_params(jax.random.key(0)))
    g, sampler, gnn, data = setup()
    rng = np.random.default_rng(2)
    n = g.num_nodes
    h0 = rng.normal(size=(LAYERS, n, HIDDEN)).astype(np.float32)
    v0 = 1e-2 * rng.normal(size=(LAYERS - 1, n, HIDDEN)).astype(np.float32)
    return dict(jp=jp, g=g, sampler=sampler, gnn=gnn, data=data,
                params=params_from_reference(gnn, jp), h0=h0, v0=v0, n=n)


def _flat(w, clusters, backend, params=None, h=None, v=None):
    """The plain step on the stacked batch of ``clusters``, its rows
    committed: (loss, grads, h, v)."""
    store = state_from_reference(w["h0"] if h is None else h,
                                 w["v0"] if v is None else v, device="cpu")
    flat = stack_batches([batch_of(w["sampler"], c) for c in clusters],
                         backend=backend)
    loss, grads, rows, _ = make_train_step(w["gnn"], LMC, w["n"],
                                           backend=backend)(
        w["params"] if params is None else params, store, flat,
        w["data"].x, w["data"].self_w)
    commit_rows(store, flat, rows, w["n"])
    return float(loss), grads, store.h.numpy(), store.v.numpy()


def _plain_rows(w, clusters, backend):
    """Each cluster's plain step on its own batch from the pre-step stores,
    its rows then committed into one copy of them, at one thread as the
    ranks run: the h and v a grid step must commit bit for bit."""
    pre = state_from_reference(w["h0"], w["v0"], device="cpu")
    store = state_from_reference(w["h0"], w["v0"], device="cpu")
    step = make_train_step(w["gnn"], LMC, w["n"], backend=backend)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for c in clusters:
            batch = host_batch(batch_of(w["sampler"], c), backend=backend)
            _, _, rows, _ = step(w["params"], pre, batch, w["data"].x,
                                 w["data"].self_w)
            commit_rows(store, batch, rows, w["n"])
    finally:
        torch.set_num_threads(threads)
    return store.h.numpy(), store.v.numpy()


def _assemble(out, grid, n, d, key) -> np.ndarray:
    """The whole store ``key`` from every rank's (L, n_r, d_c) block."""
    R, M = grid
    whole = np.full(out[0][key].shape[:1] + (n, d), np.nan, np.float32)
    for res in out:
        r, c = res["coords"]
        (a, b), (p, q) = row_block(n, R, r), row_block(d, M, c)
        assert res[key].shape == (whole.shape[0], b - a, q - p), res[key].shape
        whole[:, a:b, p:q] = res[key]
    return whole


@pytest.fixture(scope="module")
def runs(world, tmp_path_factory):
    """The reference's (2, 2) SPMD step in its subprocess, beside the (2, 2)
    grid (which saves a checkpoint after its update), then the (4, 1) grid
    (its row step too, then a resume from that checkpoint)."""
    tmp = tmp_path_factory.mktemp("grid")
    np.savez(tmp / "in.npz", h0=world["h0"], v0=world["v0"])
    base = dict(params=world["jp"], h0=world["h0"], v0=world["v0"])
    ckpt = str(tmp / "ckpt")
    with cf.ThreadPoolExecutor(1) as ex:
        ref = ex.submit(run_spmd, REFERENCE % json.dumps(str(tmp)),
                        devices=4)
        grid, backend = GRIDS["2x2"]
        out = {"2x2": run_grid(grid, dict(base, backend=backend,
                                          clusters=[0, 1], ckpt_out=ckpt),
                               tmp)}
        grid, backend = GRIDS["4x1"]
        out["4x1"] = run_grid(grid, dict(base, backend=backend,
                                         clusters=[0, 1, 2, 3],
                                         row_step=True, ckpt_in=ckpt,
                                         resume=RESUME), tmp)
        resume = [dict(r["resume"], coords=r["coords"]) for r in out["4x1"]]
        assert "GRID-REF-OK" in ref.result()
    with np.load(tmp / "out.npz") as f:
        reference = {k: f[k] for k in f.files}
    return out, resume, reference, ckpt


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_grid_step_matches_plain_step(world, runs, name):
    """Each rank: the mean loss and gradients of the stacked batch; the
    stores, split over rows and features, as each data rank's plain step
    commits them, bit for bit."""
    (grid, backend), out = GRIDS[name], runs[0][name]
    clusters = list(range(grid[0]))
    loss, grads, _, _ = _flat(world, clusters, backend)
    for res in out:
        np.testing.assert_allclose(res["loss"], loss, rtol=LOSS_RTOL)
        errs = [_norm_rel(a, b) for a, b in zip(_leaves(res["grads"]),
                                                _leaves(grads), strict=True)]
        assert max(errs) <= LEAF_RTOL, errs
    h, v = _plain_rows(world, clusters, backend)
    n, d = world["n"], world["gnn"].hidden_dim
    assert np.array_equal(_assemble(out, grid, n, d, "h"), h)
    assert np.array_equal(_assemble(out, grid, n, d, "v"), v)
    assert not np.array_equal(h, world["h0"])


def test_grid_with_one_feature_block_is_the_row_step(runs):
    """On (4, 1) every rank's grid step equals the 1-D row step of the same
    ranks bit for bit: loss, gradients, accuracy and committed blocks."""
    for res in runs[0]["4x1"]:
        row = res["row"]
        assert res["loss"] == row["loss"] and res["acc"] == row["acc"]
        for a, b in zip(_leaves(res["grads"]), _leaves(row["grads"]),
                        strict=True):
            assert np.array_equal(a, b)
        assert np.array_equal(res["h"], row["h"])
        assert np.array_equal(res["v"], row["v"])


def test_grid_step_matches_reference_spmd_step(world, runs):
    """The (2, 2) grid against the reference's step jitted under
    ``spmd_shardings`` of a (2, 2) ``data`` × ``model`` mesh, on the stacked
    batch of the same two clusters: loss, every gradient leaf, and the
    stores after the step (the refreshed rows and the rest)."""
    out, _, ref, _ = runs
    n, d = world["n"], world["gnn"].hidden_dim
    for res in out["2x2"]:
        assert abs(res["loss"] - float(ref["loss"])) < 1e-4
        grads = _leaves(res["grads"])
        assert len(grads) == len([k for k in ref if k.startswith("g")])
        for i, a in enumerate(grads):
            np.testing.assert_allclose(a, ref[f"g{i}"], rtol=2e-3, atol=2e-4)
    for key in ("h", "v"):
        np.testing.assert_allclose(_assemble(out["2x2"], (2, 2), n, d, key),
                                   ref[key], rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("target", ["4x1", "one process"])
def test_grid_checkpoint_restores_to_another_grid(world, runs, target):
    """Saved by rank 0 of the (2, 2) grid after its update (features
    gathered within each feature group, then rows within each row group),
    restored to a (4, 1) grid or one process: the next step matches the
    uninterrupted flat run's next step."""
    _, resume, _, ckpt = runs
    loss, grads, h, v = _flat(world, [0, 1], "segment")
    opt = sgd(lr=LR)
    params, opt_state, _ = opt.update(grads, opt.init(world["params"]),
                                      world["params"], LR)
    like = {"params": world["params"], "opt": opt_state,
            "store": (torch.zeros(1), torch.zeros(1))}
    tree, _, step = CheckpointManager(ckpt).restore(like)
    assert step == 1
    for a, b in zip(_leaves(tree["params"]), _leaves(params), strict=True):
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_allclose(tree["store"][0], h, **TOL)
    np.testing.assert_allclose(tree["store"][1], v, **TOL)
    # the (4, 1) grid resumes on its own backend (ell), one process on
    # segment
    want = _flat(world, RESUME, GRIDS["4x1"][1] if target == "4x1"
                 else "segment", params=params, h=h, v=v)
    if target == "4x1":
        n, d = world["n"], world["gnn"].hidden_dim
        got = [(r["loss"], r["grads"]) for r in resume]
        got_h = _assemble(resume, (4, 1), n, d, "h")
        got_v = _assemble(resume, (4, 1), n, d, "v")
    else:   # no group: the whole tree is this process's share
        mine = reshard(tree, lmc_placement(tree, features=True),
                       device="cpu")
        store = HistoricalState(*mine["store"])
        l1, g1, owned, _ = make_distributed_train_step(
            world["gnn"], LMC, world["n"])(
            mine["params"], store,
            stack_batches([batch_of(world["sampler"], c) for c in RESUME]),
            world["data"].x, world["data"].self_w)
        commit_owned_rows(store, owned, world["n"])
        got = [(float(l1), g1)]
        got_h, got_v = store.h.numpy(), store.v.numpy()
    for loss1, grads1 in got:
        np.testing.assert_allclose(loss1, want[0], rtol=LOSS_RTOL)
        for a, b in zip(_leaves(grads1), _leaves(want[1]), strict=True):
            np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_allclose(got_h, want[2], **TOL)
    np.testing.assert_allclose(got_v, want[3], **TOL)


def test_grid_placement_blocks_stores_on_both_axes(world):
    """``lmc_placement(features=True)`` cuts the stores into (L, n_r, d_c)
    blocks by the ceil rule on both axes, and ``x`` and ``self_w`` into
    row blocks only; without groups every leaf is whole."""
    tree = {"params": world["params"], "store": (world["h0"], world["v0"]),
            "x": world["data"].x}
    grid = lmc_placement(tree, features=True)
    whole = reshard(tree, grid, device="cpu")
    assert np.array_equal(whole["store"][0].numpy(), world["h0"])
    from repro_torch.dist import take_block
    n, d = world["n"], HIDDEN
    for r in range(3):
        for c in range(3):
            blk = take_block(torch.from_numpy(world["h0"]), grid["store"][0],
                             3, r, 3, c)
            (a, b), (p, q) = row_block(n, 3, r), row_block(d, 3, c)
            assert torch.equal(blk, torch.from_numpy(world["h0"][:, a:b, p:q]))
    assert take_block(world["data"].x, grid["x"], 3, 2, 3, 1).shape == (
        n - 2 * (-(-n // 3)), world["data"].x.shape[1])
    assert tree_map(lambda _: None, world["params"]) == grid["params"]
