"""Port parity, distributed LMC: ``stack_batches`` and the flat multi-cluster
step against the reference's (tests/test_distributed.py builds the same
batches), and the port's row-sharded ``make_distributed_train_step`` on 2
and 4 gloo CPU processes against the single-process flat step, with a
checkpoint saved under one world and resharded to others.

Graph: ``ppi-cpu`` (seed 3), 8 parts, one cluster per device, GCN 2×32.
Tolerances (those of tests/test_torch_train.py): loss rtol 1e-5; grads and
the h/v stores after the step's commit rtol 2e-4, atol 1e-6; ``train_acc``
equal. The spawned ranks run ``tests/_torch_dist.py``, which imports no
JAX; each run is joined on progress (``tests/_torch_ranks.py``: it fails
when a rank exits non-zero or no rank beats its heartbeat for ``JOIN_S``
seconds).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import graph as jgraph
from repro.core import LMC as J_LMC
from repro.core import exact as jexact
from repro.core import make_train_step as j_make_train_step
from repro.core.distributed import stack_batches as j_stack_batches
from repro.core.history import HistoricalState as JState
from repro.kernels import ell_from_coo as j_ell_from_coo
from repro.models import make_gnn as j_make_gnn

from _torch_dist import HIDDEN, LAYERS, LR, PARTS, batch_of, run_ranks, setup
from repro_torch.checkpoint import CheckpointManager, reshard, unshard
from repro_torch.convert import params_from_reference, state_from_reference
from repro_torch.core import (LMC, HistoricalState, commit_rows, host_batch,
                              make_train_step)
from repro_torch.core.distributed import (commit_owned_rows,
                                          make_distributed_train_step,
                                          stack_batches)
from repro_torch.dist import (fetch_rows, lmc_placement, owner_of, route_rows,
                              row_block, take_block)
from repro_torch.optim import sgd, tree_map
from repro_torch.train import rescale_lmc_state

torch.backends.cuda.matmul.allow_tf32 = False
LOSS = dict(rtol=1e-5, atol=0)
TOL = dict(rtol=2e-4, atol=1e-6)


@pytest.fixture(scope="module")
def world():
    """Both packages' graph, sampler and parameters, random non-zero
    stores, and the port's GNN and full-graph data."""
    jg = jgraph.make_sbm_dataset("ppi-cpu", seed=3)
    jparts = jgraph.partition_graph(jg, PARTS, seed=0)
    jsampler = jgraph.ClusterSampler(jg, PARTS, 1, parts=jparts, seed=1)
    jgnn = j_make_gnn("gcn", jg.feature_dim, HIDDEN, jg.num_classes, LAYERS)
    jp = jax.tree.map(np.asarray, jgnn.init_params(jax.random.key(0)))
    g, sampler, gnn, data = setup()
    params = params_from_reference(gnn, jp)
    rng = np.random.default_rng(2)
    n = g.num_nodes
    h0 = rng.normal(size=(LAYERS, n, HIDDEN)).astype(np.float32)
    v0 = 1e-2 * rng.normal(size=(LAYERS - 1, n, HIDDEN)).astype(np.float32)
    return dict(jg=jg, jsampler=jsampler, jgnn=jgnn, jp=jp, g=g,
                sampler=sampler, gnn=gnn, data=data, params=params, h0=h0,
                v0=v0, n=n)


def _leaves(tree, path=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _leaves(sub, path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _leaves(sub, path + (i,)).items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach()
    return {path: np.asarray(tree, np.float32)}


def _assert_trees_close(got, want, **tol):
    a, b = _leaves(got), _leaves(want)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], err_msg=str(k), **tol)


def _flat_step(w, clusters, backend, params=None, h=None, v=None):
    """The port's flat step on the stacked batch of ``clusters``, its rows
    committed: (loss, grads, acc, h, v)."""
    sgs = [batch_of(w["sampler"], c) for c in clusters]
    store = state_from_reference(w["h0"] if h is None else h,
                                 w["v0"] if v is None else v, device="cpu")
    flat = stack_batches(sgs, backend=backend)
    loss, grads, rows, metrics = make_train_step(
        w["gnn"], LMC, w["n"], backend=backend)(
        w["params"] if params is None else params, store, flat,
        w["data"].x, w["data"].self_w)
    commit_rows(store, flat, rows, w["n"])
    return (float(loss), grads, float(metrics["train_acc"]),
            store.h.numpy(), store.v.numpy())


# ------------------------------------------------------------ stack_batches
@pytest.mark.parametrize("devices", [1, 2, 4])
def test_stack_batches_matches_reference(world, devices):
    jsgs = [world["jsampler"].build_batch(np.array([d]))
            for d in range(devices)]
    want = j_stack_batches(jsgs)
    got = stack_batches([batch_of(world["sampler"], d)
                         for d in range(devices)])
    assert got.ell is None and got.ti_scale is None
    for name in want._fields:
        a = getattr(want, name)
        if a is None:
            continue
        b = getattr(got, name)
        assert np.asarray(a).dtype == b.numpy().dtype, name
        assert np.array_equal(np.asarray(a), b.numpy()), name


def test_stack_batches_ell_buckets_the_flat_edges(world):
    sgs = [batch_of(world["sampler"], d) for d in range(3)]
    flat = stack_batches(sgs, backend="ell")
    ti = stack_batches(sgs, backend="ti")
    want = j_ell_from_coo(flat.edge_src.numpy(), flat.edge_dst.numpy(),
                          flat.edge_w.numpy(), 3 * (sgs[0].n_ext),
                          as_jax=False)
    assert flat.ell.transpose is not None
    for x, y in zip(want.bucket_idx + want.bucket_w + want.bucket_rows,
                    flat.ell.bucket_idx + flat.ell.bucket_w
                    + flat.ell.bucket_rows, strict=True):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    np.testing.assert_array_equal(
        ti.ti_scale.numpy(), np.concatenate([sg.ti_scale for sg in sgs]))
    bad = dataclasses.replace(sgs[0], halo_gids=sgs[0].halo_gids[:-1])
    with pytest.raises(ValueError, match="uniform padding"):
        stack_batches([sgs[0], bad])


# ------------------------------------------------ flat step vs the reference
@pytest.mark.parametrize("backend", ["segment", "ell"])
def test_flat_step_matches_reference(world, backend):
    clusters = range(4)
    flat_j = j_stack_batches([world["jsampler"].build_batch(np.array([d]))
                              for d in clusters])
    if backend == "ell":
        flat_j = flat_j._replace(ell=j_ell_from_coo(
            np.asarray(flat_j.edge_src), np.asarray(flat_j.edge_dst),
            np.asarray(flat_j.edge_w), int(flat_j.labels.shape[0])))
    jd = jexact.from_graph(world["jg"])
    j_loss, j_grads, j_store, j_m = j_make_train_step(
        world["jgnn"], J_LMC, world["n"], backend=backend)(
        world["jp"], JState(jnp.asarray(world["h0"]),
                            jnp.asarray(world["v0"])),
        flat_j, jd.x, jd.self_w)
    loss, grads, acc, h, v = _flat_step(world, clusters, backend)
    np.testing.assert_allclose(loss, float(j_loss), **LOSS)
    _assert_trees_close(grads, jax.tree.map(np.asarray, j_grads), **TOL)
    np.testing.assert_allclose(h, np.asarray(j_store.h), **TOL)
    np.testing.assert_allclose(v, np.asarray(j_store.v), **TOL)
    assert acc == float(j_m["train_acc"])


# ------------------------------------------------- row blocks and exchanges
@pytest.mark.parametrize("n,ranks", [(10, 1), (10, 3), (9, 4), (2000, 4)])
def test_row_blocks_cover_every_row_once(n, ranks):
    blocks = [row_block(n, ranks, r) for r in range(ranks)]
    assert blocks[0][0] == 0 and blocks[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    sizes = [b - a for a, b in blocks]
    assert sizes[:-1] == [sizes[0]] * (ranks - 1) and sizes[-1] <= sizes[0]
    gids = np.arange(n)
    own = owner_of(gids, n, ranks)
    assert np.array_equal(own, owner_of(torch.from_numpy(gids), n,
                                        ranks).numpy())
    for r, (a, b) in enumerate(blocks):
        assert (own[a:b] == r).all()


def test_exchanges_without_a_group_are_local_indexing():
    x = torch.arange(30.0).reshape(10, 3)
    gids = torch.tensor([7, 0, 7, 3], dtype=torch.int32)
    got = fetch_rows((x, x[:, 0]), gids, 10)
    assert torch.equal(got[0], x[gids.long()]) and torch.equal(
        got[1], x[gids.long(), 0])
    ids, rows = route_rows(x[:4], torch.tensor([9, 2, 10, 5]),
                           torch.tensor([1.0, 0.0, 1.0, 1.0]), 10)
    assert ids.tolist() == [9, 5] and torch.equal(rows, x[[0, 3]])
    with pytest.raises(ValueError, match="row ids"):
        fetch_rows(x, torch.tensor([10]), 10)


# ------------------------------------------- the row-sharded step on ranks
def _job(world, ranks, backend, kind="step", **kw):
    return dict(kind=kind, backend=backend, clusters=list(range(ranks)),
                params=world["jp"], h0=world["h0"], v0=world["v0"], **kw)


def _assert_matches_flat(out, flat, grads_tol=TOL):
    loss, grads, acc, h, v = flat
    for r in out:
        np.testing.assert_allclose(r["loss"], loss, **LOSS)
        _assert_trees_close(r["grads"], grads, **grads_tol)
        assert r["acc"] == acc
    np.testing.assert_allclose(np.concatenate([r["h"] for r in out], 1), h,
                               **TOL)
    np.testing.assert_allclose(np.concatenate([r["v"] for r in out], 1), v,
                               **TOL)


@pytest.mark.parametrize("ranks,backend", [(2, "segment"), (4, "segment"),
                                           (2, "ell")])
def test_distributed_step_matches_flat_step(world, tmp_path, ranks, backend):
    """Each rank: one cluster, its store blocks; all-reduced loss and grads
    and the committed blocks against the flat step on the stacked batch."""
    out = run_ranks(ranks, _job(world, ranks, backend), tmp_path)
    _assert_matches_flat(out, _flat_step(world, range(ranks), backend))


def test_distributed_step_in_one_process_is_the_plain_step(world):
    """Without a process group the distributed step is the plain step on
    the same batch: equal loss, grads and committed rows."""
    batch = host_batch(batch_of(world["sampler"], 5), backend="ell")
    n = world["n"]
    plain = state_from_reference(world["h0"], world["v0"], device="cpu")
    mine = state_from_reference(world["h0"], world["v0"], device="cpu")
    args = (batch, world["data"].x, world["data"].self_w)
    l1, g1, rows, _ = make_train_step(world["gnn"], LMC, n, backend="ell")(
        world["params"], plain, *args)
    commit_rows(plain, batch, rows, n)
    l2, g2, owned, _ = make_distributed_train_step(
        world["gnn"], LMC, n, backend="ell")(world["params"], mine, *args)
    commit_owned_rows(mine, owned, n)
    assert torch.equal(l1, l2)
    _assert_trees_close(g2, g1, rtol=0, atol=0)
    assert torch.equal(plain.h, mine.h) and torch.equal(plain.v, mine.v)


# --------------------------------------------------- resharding a checkpoint
@pytest.fixture(scope="module")
def saved(world, tmp_path_factory):
    """A whole-tree checkpoint of step 1 saved by rank 0 of a 2-rank run
    (params after the update, momentum, the store gathered from both
    blocks), and the uninterrupted flat run's state after its step 1."""
    tmp = tmp_path_factory.mktemp("reshard")
    ckpt = str(tmp / "ckpt")
    run_ranks(2, _job(world, 2, "segment", kind="save", ckpt=ckpt), tmp)
    loss, grads, _, h, v = _flat_step(world, range(2), "segment")
    opt = sgd(lr=LR)
    params, opt_state, _ = opt.update(
        grads, opt.init(world["params"]), world["params"], LR)
    return ckpt, params, opt_state, h, v


@pytest.mark.parametrize("ranks", [1, 3])
def test_checkpoint_resharded_to_another_world_continues(world, saved,
                                                         tmp_path, ranks):
    """Saved under world 2, restored and resharded under ``ranks``: the
    next step matches the uninterrupted flat run's next step."""
    ckpt, params, opt_state, h, v = saved
    like = {"params": world["params"], "opt": opt_state,
            "store": (torch.zeros(1), torch.zeros(1))}
    tree, _, step = CheckpointManager(ckpt).restore(like)
    assert step == 1
    _assert_trees_close(tree["params"], params, **TOL)
    np.testing.assert_allclose(tree["store"][0], h, **TOL)
    clusters = list(range(2, 2 + ranks))
    want = _flat_step(world, clusters, "segment", params=params, h=h, v=v)
    if ranks > 1:
        out = run_ranks(ranks, _job(world, ranks, "segment", kind="resume",
                                    ckpt=ckpt) | {"clusters": clusters},
                        tmp_path)
    else:   # one process, no group: the whole tree is this rank's share
        mine = reshard(tree, lmc_placement(tree), device="cpu")
        store = HistoricalState(*mine["store"])
        loss, grads, owned, m = make_distributed_train_step(
            world["gnn"], LMC, world["n"])(
            mine["params"], store,
            stack_batches([batch_of(world["sampler"], c) for c in clusters]),
            world["data"].x, world["data"].self_w)
        commit_owned_rows(store, owned, world["n"])
        out = [{"loss": float(loss), "grads": grads,
                "acc": float(m["train_acc"]), "h": store.h.numpy(),
                "v": store.v.numpy()}]
    _assert_matches_flat(out, want)


def test_reshard_and_unshard_in_one_process(world):
    """World 1: reshard gives fresh copies of every leaf on the device,
    unshard gives them back; a reused store is carried through
    rescale_lmc_state, a reset one is zeros of the same shape."""
    tree = {"params": world["params"], "store": (world["h0"], world["v0"]),
            "x": world["data"].x}
    placement = lmc_placement(tree)
    assert placement["store"] == (1, 1) and placement["x"] == 0
    assert placement["params"] == tree_map(lambda _: None, world["params"])
    mine = reshard(tree, placement, device="cpu")
    assert mine["x"] is not world["data"].x and torch.equal(
        mine["x"], world["data"].x)
    back = unshard(mine, placement, world["n"])
    np.testing.assert_array_equal(back["store"][0].numpy(), world["h0"])
    assert take_block(mine["x"], 0, 3, 2).shape[0] == world["n"] - 2 * (
        -(-world["n"] // 3))
    store = HistoricalState(*mine["store"])
    _, kept = rescale_lmc_state(world["g"], store, old_num_parts=PARTS,
                                new_num_parts=4)
    assert kept is store
    _, cold = rescale_lmc_state(world["g"], store, old_num_parts=PARTS,
                                new_num_parts=4, reuse_store=False)
    assert cold.h.shape == store.h.shape and not cold.h.any()


def test_rescale_under_a_group_refuses_a_store_block(world, tmp_path):
    """With a process group the elastic path reshards the *whole* store; a
    block (of any world) is refused instead of being cut again."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'i'}",
                            world_size=1, rank=0)
    try:
        block = HistoricalState(*(torch.from_numpy(a[:, :100])
                                  for a in (world["h0"], world["v0"])))
        with pytest.raises(ValueError, match="whole store"):
            rescale_lmc_state(world["g"], block, old_num_parts=2,
                              new_num_parts=PARTS)
        whole = state_from_reference(world["h0"], world["v0"], device="cpu")
        _, mine = rescale_lmc_state(world["g"], whole, old_num_parts=2,
                                    new_num_parts=PARTS)
        assert mine.h is not whole.h and torch.equal(mine.h, whole.h)
    finally:
        dist.destroy_process_group()
