"""Port parity, training: ``make_train_step`` and ``GNNTrainer`` against the
reference on identical graphs, sampler batches, parameters and stores.

Both packages build the same tiny graph and cluster batches from one numpy
seed; the reference's parameters are copied leaf for leaf and its random,
non-zero stores carried over with ``state_from_reference``. The reference's
Pallas kernels run in interpret mode on the CPU, as its own tests run them;
the port's kernels run their plain PyTorch twins.

Tolerances: loss rtol 1e-5; grads and committed h/v stores rtol 2e-4, atol
1e-6 (the reference's own ell-vs-segment bar: the same f32 sums in another
order, through up to three layers of vjps). Matmuls in full f32 (TF32 off).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import graph as jgraph
from repro.core import METHODS as J_METHODS
from repro.core import exact as jexact
from repro.core import make_train_step as j_make_train_step
from repro.core import to_device_batch as j_to_device_batch
from repro.core.history import HistoricalState as JState
from repro.models import make_gnn as j_make_gnn
from repro.optim import sgd as j_sgd
from repro.train import GNNTrainer as JTrainer

from repro_torch import graph as tgraph
from repro_torch.convert import params_from_reference, state_from_reference
from repro_torch.core import (METHODS, TI, commit_rows, host_batch,
                              make_train_step)
from repro_torch.core import exact as texact
from repro_torch.models import make_gnn
from repro_torch.optim import sgd
from repro_torch.train import GNNTrainer

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
LOSS = dict(rtol=1e-5, atol=0)
TOL = dict(rtol=2e-4, atol=1e-6)
ARCHS = ["gcn", "gcnii", "sage", "gin"]
N, PARTS = 300, 4


def _tiny_graph(lib):
    """The reference's ``tiny_graph`` fixture (tests/test_ell_backend.py),
    built by either package."""
    rng = np.random.default_rng(0)
    n, e = N, 1200
    x = rng.normal(size=(n, 12)).astype(np.float32)
    y = rng.integers(0, 5, n).astype(np.int32)
    tm = rng.random(n) < 0.6
    vm = (~tm) & (rng.random(n) < 0.5)
    return lib.Graph.from_edges(n, rng.integers(0, n, e),
                                rng.integers(0, n, e), x, y, tm, vm,
                                ~(tm | vm))


@pytest.fixture(scope="module")
def graphs():
    parts = np.random.default_rng(1).integers(0, PARTS, N).astype(np.int32)
    return _tiny_graph(jgraph), _tiny_graph(tgraph), parts


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


def _pair(arch, g, hidden=16, layers=2):
    jg = j_make_gnn(arch, g.feature_dim, hidden, g.num_classes, layers)
    jp = jg.init_params(jax.random.key(0))
    tg = make_gnn(arch, g.feature_dim, hidden, g.num_classes, layers)
    return jg, jp, tg, params_from_reference(tg, jax.tree.map(np.asarray, jp))


def _step_pair(graphs, arch, method, backend, stream=None, layers=2,
               hidden=16):
    """One step of each package on the same batch and non-zero stores:
    (reference (loss, grads, new store), port (loss, grads, committed
    store))."""
    jgr, tgr, parts = graphs
    jg, jp, tg, tp = _pair(arch, jgr, hidden, layers)
    m = J_METHODS[method]
    kw = dict(parts=parts, seed=0, include_halo=m.include_halo,
              edge_weight_mode=m.edge_weight_mode)
    jsg = jgraph.ClusterSampler(jgr, PARTS, 1, **kw).sample()
    tsg = tgraph.ClusterSampler(tgr, PARTS, 1, **kw).sample()
    rng = np.random.default_rng(2)
    h0 = rng.normal(size=(layers, N, hidden)).astype(np.float32)
    v0 = rng.normal(size=(max(layers - 1, 1), N, hidden)).astype(np.float32)
    jd, td = jexact.from_graph(jgr), texact.from_graph(tgr, device="cpu")

    j_loss, j_grads, j_store, _ = j_make_train_step(
        jg, m, N, backend=backend, stream=stream)(
        jp, JState(jnp.asarray(h0), jnp.asarray(v0)),
        j_to_device_batch(jsg, backend=backend), jd.x, jd.self_w)
    store = state_from_reference(h0, v0, device="cpu")
    batch = host_batch(tsg, backend=backend)
    t_loss, t_grads, rows, _ = make_train_step(
        tg, METHODS[method], N, backend=backend, stream=stream)(
        tp, store, batch, td.x, td.self_w)
    # the step itself never writes the store; the caller commits its rows
    assert torch.equal(store.h, torch.from_numpy(h0))
    assert (rows is None) == (not METHODS[method].store_writes)
    if rows is not None:
        commit_rows(store, batch, rows, N)
    return (j_loss, j_grads, j_store), (t_loss, t_grads, store)


def _assert_step_parity(ref, port):
    (j_loss, j_grads, j_store), (t_loss, t_grads, store) = ref, port
    np.testing.assert_allclose(float(t_loss), float(j_loss), **LOSS)
    _assert_trees_close(t_grads, j_grads, **TOL)
    np.testing.assert_allclose(store.h.numpy(), np.asarray(j_store.h), **TOL)
    np.testing.assert_allclose(store.v.numpy(), np.asarray(j_store.v), **TOL)


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_segment_matches_reference(graphs, arch, method):
    _assert_step_parity(*_step_pair(graphs, arch, method, "segment"))


@pytest.mark.parametrize("stream", [None, False], ids=["stream", "resident"])
@pytest.mark.parametrize("method", ["lmc", "gas"])
def test_train_step_ell_matches_reference(graphs, method, stream):
    """The reference runs its Pallas bodies (streaming or resident) in
    interpret mode; the port its kernels' plain twins."""
    _assert_step_parity(*_step_pair(graphs, "gcn", method, "ell", stream))


def test_train_step_ti_matches_reference(graphs):
    _assert_step_parity(*_step_pair(graphs, "gcn", "ti", "ti"))


def test_train_step_three_layers_matches_reference(graphs):
    """Three layers: the adjoint recursion crosses a middle layer, whose
    V̂ compensation reads ``store.v[1]``, and ``h``/``v`` both commit."""
    _assert_step_parity(*_step_pair(graphs, "gcnii", "lmc", "segment",
                                    layers=3))


def test_ti_step_ignores_a_poisoned_store(graphs):
    """``backend="ti"`` never reads the store: a NaN-poisoned store gives a
    bit-identical, finite loss and grads, and TI writes nothing."""
    _, tgr, parts = graphs
    tg = make_gnn("gcn", tgr.feature_dim, 16, tgr.num_classes, 2,
                  generator=torch.Generator().manual_seed(0))
    sg = tgraph.ClusterSampler(tgr, PARTS, 1, parts=parts, seed=0).sample()
    assert sg.n_halo_real > 0
    batch = host_batch(sg, backend="ti")
    td = texact.from_graph(tgr, device="cpu")
    step = make_train_step(tg, TI, N, backend="ti")
    zero = state_from_reference(np.zeros((2, N, 16), np.float32),
                                np.zeros((1, N, 16), np.float32), "cpu")
    nan = state_from_reference(np.full((2, N, 16), np.nan, np.float32),
                               np.full((1, N, 16), np.nan, np.float32), "cpu")
    l0, g0, rows0, _ = step(tg.params(), zero, batch, td.x, td.self_w)
    l1, g1, rows1, _ = step(tg.params(), nan, batch, td.x, td.self_w)
    assert torch.equal(l0, l1) and torch.isfinite(l0)
    for a, b in zip(_leaves(g0).values(), _leaves(g1).values()):
        np.testing.assert_array_equal(a, b)
    assert rows0 is None and rows1 is None
    l2, g2, _, _ = step(tg.params(), None, batch, td.x, td.self_w)
    assert torch.equal(l0, l2)


def test_train_step_requires_ell_batch_with_transpose(graphs):
    _, tgr, parts = graphs
    tg = make_gnn("gcn", tgr.feature_dim, 16, tgr.num_classes, 2)
    sg = tgraph.ClusterSampler(tgr, PARTS, 1, parts=parts, seed=0).sample()
    td = texact.from_graph(tgr, device="cpu")
    store = state_from_reference(np.zeros((2, N, 16), np.float32),
                                 np.zeros((1, N, 16), np.float32), "cpu")
    step = make_train_step(tg, METHODS["lmc"], N, backend="ell")
    with pytest.raises(ValueError, match="batch.ell"):
        step(tg.params(), store, host_batch(sg), td.x, td.self_w)
    forward_only = host_batch(sg, backend="ell", with_transpose=False)
    with pytest.raises(ValueError, match="with_transpose=False"):
        step(tg.params(), store, forward_only, td.x, td.self_w)


def test_full_grads_and_backward_sgd_match_reference(graphs):
    jgr, tgr, _ = graphs
    jg, jp, tg, tp = _pair("gcn", jgr, layers=3)
    jd, td = jexact.from_graph(jgr), texact.from_graph(tgr, device="cpu")
    j_loss, j_grads = jexact.full_grads(jg, jp, jd)
    t_loss, t_grads = texact.full_grads(tg, tp, td)
    np.testing.assert_allclose(float(t_loss), float(j_loss), **LOSS)
    _assert_trees_close(t_grads, j_grads, **TOL)
    jhs, jvs = jexact.exact_layer_values(jg, jp, jd)
    ths, tvs = texact.exact_layer_values(tg, tp, td)
    nodes = np.arange(0, N, 3, dtype=np.int32)
    want = jexact.backward_sgd_grads(jg, jp, jd, jhs, jvs,
                                     jnp.asarray(nodes), 3.0)
    got = texact.backward_sgd_grads(tg, tp, td, ths, tvs,
                                    torch.from_numpy(nodes), 3.0)
    _assert_trees_close(got, want, **TOL)


@pytest.mark.parametrize("backend", ["segment", "ell"])
def test_trainer_matches_reference_trainer(graphs, backend):
    """Five synchronous SGD steps from the reference trainer's initial
    parameters: the same losses within 1e-5 and the same accuracies."""
    jgr, tgr, parts = graphs
    jg = j_make_gnn("gcn", jgr.feature_dim, 16, jgr.num_classes, 2)
    tg = make_gnn("gcn", tgr.feature_dim, 16, tgr.num_classes, 2)
    params_from_reference(tg, jax.tree.map(
        np.asarray, jg.init_params(jax.random.key(0))))
    jt = JTrainer(jg, J_METHODS["lmc"], jgr,
                  jgraph.ClusterSampler(jgr, PARTS, 1, parts=parts, seed=1),
                  j_sgd(lr=0.2), seed=0, backend=backend)
    tt = GNNTrainer(tg, METHODS["lmc"], tgr,
                    tgraph.ClusterSampler(tgr, PARTS, 1, parts=parts, seed=1),
                    sgd(lr=0.2), backend=backend, device="cpu")
    jh, th = jt.run(5, eval_every=5), tt.run(5, eval_every=5)
    assert [r["step"] for r in th] == [r["step"] for r in jh]
    losses = [(a["loss"], b["loss"]) for a, b in zip(th, jh) if "loss" in a]
    assert len(losses) == 5
    np.testing.assert_allclose(*zip(*losses), **LOSS)
    assert th[-1]["val_acc"] == float(jh[-1]["val_acc"])
    for split in ("train", "test"):
        assert tt.eval(split) == float(jt.eval(split))
    np.testing.assert_allclose(tt.store.h.cpu().numpy(),
                               np.asarray(jt.store.h), **TOL)


def test_trainer_refuses_unported_options(graphs):
    _, tgr, parts = graphs
    tg = make_gnn("gcn", tgr.feature_dim, 8, tgr.num_classes, 2)
    s = tgraph.ClusterSampler(tgr, PARTS, 1, parts=parts, seed=1)
    for kw, item in ((dict(ckpt_dir="ckpt"), "item 2"),
                     (dict(health=object()), "item 1"),
                     (dict(failure_injector=object()), "item 1"),
                     (dict(prefetch=2), "item 4"),
                     (dict(recycle=2), "item 4")):
        with pytest.raises(NotImplementedError, match=item):
            GNNTrainer(tg, METHODS["lmc"], tgr, s, sgd(), device="cpu", **kw)


def test_trainer_straggler_skips_the_store_commit(graphs):
    """A step past the deadline keeps its optimizer update but drops its
    store rows (``straggler_policy="skip-store"``)."""
    _, tgr, parts = graphs
    tg = make_gnn("gcn", tgr.feature_dim, 8, tgr.num_classes, 2,
                  generator=torch.Generator().manual_seed(0))
    tt = GNNTrainer(tg, METHODS["lmc"], tgr,
                    tgraph.ClusterSampler(tgr, PARTS, 1, parts=parts, seed=1),
                    sgd(lr=0.2), device="cpu", straggler_deadline=1.0)
    tt._step_times.extend([1e-9] * 8)   # any real step is a straggler now
    before = tt.store.h.clone()
    params_before = tt.params["head"]["w"].clone()
    tt.run(1)
    assert tt.history[-1]["straggler"]
    assert torch.equal(tt.store.h, before)
    assert not torch.equal(tt.params["head"]["w"], params_before)
