"""LMC's backward walks each layer's autograd graph only for what a
cotangent feeds, and gives what the two-call formulation gave.

The oracle, :func:`two_call_step`, is the step as it was written before:
one ``torch.func.vjp`` a layer, called on ``[V̄; 0]`` for the θ-gradient
and again on ``[V̄; V̂]`` for the input adjoints, each call computing every
output. The step under test must match it (loss, every gradient leaf, the
refreshed ``h``/``v`` rows) on every arch, a method with and without the
backward compensation, and both aggregation paths; it must do so under
``torch.no_grad()`` too; and it must run only the needed products: 3 GEMMs
a GCNII layer where the oracle runs 5, no input walk at GCN's layer 0, and
one walk a layer where ``bwd_mode="none"``. Runs on the CPU (the kernels'
plain twins), in f32 with the same arithmetic as the oracle: the kept
products are the oracle's, on the same operands, so the results are equal
bit for bit. On one thread: the CPU's ``index_add_`` and
``scatter_reduce`` split their sums across threads in no fixed order, so
with more the plain GAT aggregation does not repeat even against itself.
"""
import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from _torch_port import N, PARTS, tiny_graph, tiny_parts

from repro_torch import graph as tgraph
from repro_torch.core import GAS, LMC, exact, host_batch, make_train_step
from repro_torch.core.history import HistoricalState, gather_rows
from repro_torch.core.lmc import _compensate
from repro_torch.models import make_gnn
from repro_torch.models.gnn import EdgeList, LayerAux
from repro_torch.optim.optimizers import tree_map

ARCHS = ["gcn", "gcnii", "sage", "gin", "gat"]
METHODS = {"lmc": LMC, "gas": GAS}   # bwd_mode "lmc" and "none"
LAYERS, HIDDEN = 3, 16
BUCKETS = 3   # host_batch's default ELL buckets: 8, 32, 128 wide
SPMM = importlib.import_module("repro_torch.kernels.ell_spmm")
OPS = importlib.import_module("repro_torch.kernels.ops")


def two_call_step(gnn, method, backend):
    """The oracle: the step with one ``torch.func.vjp`` a layer, called
    twice where ``bwd_mode != "none"`` (``[V̄; 0]`` kept for θ, ``[V̄; V̂]``
    for the inputs), layer 0's input adjoint always taken."""
    L = gnn.num_layers
    layer0_input_is_h0 = gnn.arch == "gcnii"

    def step(params, store, batch, x_full, self_w_full):
        batch = batch.bucketed()
        nb = batch.batch_gids.shape[0]
        params = tree_map(torch.Tensor.detach, params)
        ext_gids = torch.cat([batch.batch_gids, batch.halo_gids])
        x_ext = gather_rows(x_full, ext_gids)
        self_w_ext = gather_rows(self_w_full, ext_gids)
        edges = EdgeList(batch.edge_src, batch.edge_dst, batch.edge_w)
        vjp_emb = None
        if params["embed"]:
            h0_ext, vjp_emb = torch.func.vjp(
                lambda e: gnn.embed_apply(e, x_ext), params["embed"])
        else:
            h0_ext = gnn.embed_apply(params["embed"], x_ext)
        aux = gnn.prepare(LayerAux(
            edges=edges, x=x_ext, h0=h0_ext, self_w=self_w_ext,
            ell=batch.ell if backend in ("ell", "ti") else None))
        bmask = batch.batch_mask[:, None]
        hmask = batch.halo_mask[:, None]
        h_in = h0_ext
        vjps, h_rows = [], []
        for l in range(L):
            def f(lp_, hin_, h0_, _l=l):
                return gnn.layer_apply(lp_, _l, hin_, aux._replace(h0=h0_))

            h_out, vjp_fn = torch.func.vjp(f, gnn.layer_params(params, l),
                                           h_in, h0_ext)
            vjps.append(vjp_fn)
            h_bar_batch = h_out[:nb] * bmask
            h_hat_halo = _compensate(method.fwd_mode, backend,
                                     None if backend == "ti" else store.h[l],
                                     batch.halo_gids, batch.beta, h_out[nb:],
                                     batch.halo_mask, None, batch.ti_scale)
            h_rows.append(h_bar_batch)
            h_in = torch.cat([h_bar_batch, h_hat_halo])

        inv_vl = batch.loss_scale / batch.grad_scale
        labels = batch.labels.long()[:, None]
        mask_b = batch.labeled_mask.clone()
        mask_b[nb:] = 0.0
        mask_h = batch.labeled_mask.clone()
        mask_h[:nb] = 0.0

        def unit_loss(head, h_rows_, m):
            logits = gnn.head_apply(head, h_rows_)
            ll = F.log_softmax(logits, dim=-1).gather(1, labels)[:, 0]
            return -(ll * m).sum() * inv_vl, logits

        f1, vjp1, _ = torch.func.vjp(
            lambda hd, h: unit_loss(hd, h, mask_b), params["head"], h_in,
            has_aux=True)
        one = torch.ones_like(f1)
        g_head_unit, V1 = vjp1(one)
        V_bar = V1[:nb] * bmask
        if method.bwd_mode == "none":
            V_hat = torch.zeros_like(V1[nb:])
        else:
            _, vjp2, _ = torch.func.vjp(
                lambda h: unit_loss(params["head"], h, mask_h), h_in,
                has_aux=True)
            (V2,) = vjp2(one)
            V_hat = V2[nb:] * hmask

        grads_layers = [None] * L
        v_rows = [None] * (L - 1)
        v0_acc = torch.zeros_like(h0_ext)
        for l in reversed(range(L)):
            g_lp, hgrad, h0grad = vjps[l](
                torch.cat([V_bar, torch.zeros_like(V_hat)]))
            grads_layers[l] = g_lp
            if method.bwd_mode != "none":
                _, hgrad, h0grad = vjps[l](torch.cat([V_bar, V_hat]))
            v0_acc = v0_acc + h0grad
            if l >= 1:
                V_bar_next = hgrad[:nb] * bmask
                V_hat = _compensate(method.bwd_mode, backend,
                                    None if backend == "ti" else store.v[l - 1],
                                    batch.halo_gids, batch.beta, hgrad[nb:],
                                    batch.halo_mask, None, batch.ti_scale)
                v_rows[l - 1] = V_bar_next
                V_bar = V_bar_next
            elif layer0_input_is_h0:
                v0_acc = v0_acc + hgrad

        scale = batch.grad_scale
        grads = {
            "layers": {k: [scale * grads_layers[l][k] for l in range(L)]
                       for k in params["layers"]},
            "head": {k: scale * g for k, g in g_head_unit.items()},
            "embed": {},
        }
        if vjp_emb is not None:
            (g_emb,) = vjp_emb(v0_acc * torch.cat(
                [bmask, torch.zeros_like(hmask)]))
            grads["embed"] = {k: scale * g for k, g in g_emb.items()}
        rows = HistoricalState(h=tuple(h_rows), v=tuple(v_rows))
        return f1 * scale, grads, rows

    return step


@pytest.fixture(scope="module")
def graph():
    return tiny_graph(tgraph)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(graph, arch, method, backend):
    """(gnn, params, store, batch, data) on the CPU: seeded weights, random
    non-zero stores of the GNN's widths, the first cluster batch."""
    gnn = make_gnn(arch, graph.feature_dim, HIDDEN, graph.num_classes,
                   LAYERS, heads=4, out_heads=2,
                   generator=torch.Generator().manual_seed(0))
    params = tree_map(torch.Tensor.detach, gnn.params())
    gen = torch.Generator().manual_seed(2)
    widths = gnn.store_widths()
    store = HistoricalState(
        h=tuple(torch.randn((N, w), generator=gen) for w in widths),
        v=tuple(torch.randn((N, w), generator=gen) for w in widths[:-1]))
    sg = tgraph.ClusterSampler(
        graph, PARTS, 1, parts=tiny_parts(), seed=0,
        include_halo=method.include_halo,
        edge_weight_mode=method.edge_weight_mode).sample()
    data = exact.from_graph(graph, device="cpu")
    return gnn, params, store, host_batch(sg, backend=backend), data


def _flat(tree, path=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, path + (i,)).items()}
    return {path: tree}


def _run(step, setup):
    _, params, store, batch, data = setup
    loss, grads, rows, *_ = step(params, store, batch, data.x, data.self_w)
    return {"loss": loss, "grads": grads, "h": rows.h, "v": rows.v}


def _assert_equal(got, want):
    a, b = _flat(got), _flat(want)
    assert a.keys() == b.keys()
    for k in a:
        assert not a[k].requires_grad, k
        assert torch.equal(a[k], b[k]), (k, (a[k] - b[k]).abs().max())


@pytest.mark.parametrize("backend", ["segment", "ti"])
@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("arch", ARCHS)
def test_step_matches_the_two_call_oracle(graph, arch, method, backend):
    m = METHODS[method]
    setup = _setup(graph, arch, m, backend)
    gnn = setup[0]
    got = _run(make_train_step(gnn, m, N, backend=backend), setup)
    want = _run(two_call_step(gnn, m, backend), setup)
    _assert_equal(got, want)
    assert all(torch.isfinite(t).all() for t in _flat(got).values())


@pytest.mark.parametrize("arch", ["gcnii", "gat"])
def test_step_under_no_grad_is_the_same(graph, arch):
    """The step records its layers' graphs under an outer ``no_grad``, as
    ``torch.func.vjp`` did, and gives the same result."""
    setup = _setup(graph, arch, LMC, "ti")
    step = make_train_step(setup[0], LMC, N, backend="ti")
    with torch.no_grad():
        quiet = _run(step, setup)
    _assert_equal(quiet, _run(step, setup))


def _count_ops(step, setup) -> dict:
    """aten::mm/addmm and ELL SpMM bucket calls of one step, on the CPU
    profiler's record and on a counting stand-in for the SpMM kernel."""
    calls = []
    plain = OPS.ell_spmm_scatter

    def counted(*a):
        calls.append(1)
        return plain(*a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(OPS, "ell_spmm_scatter", counted)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _run(step, setup)
    names = [e.name for e in prof.events()]
    return {"gemm": sum(n in ("aten::mm", "aten::addmm") for n in names),
            "spmm": len(calls)}


# GEMMs outside the layers: the embedding (GCNII: its forward and its
# weight's VJP) and the head (its forward and VJP on the batch rows' loss,
# 1 + 2, and where V̂ is taken, on the halo rows' loss, 1 + 1)
OUTSIDE = {("gcnii", "lmc"): 2 + 5, ("gcnii", "gas"): 2 + 3,
           ("gcn", "lmc"): 5, ("gcn", "gas"): 3}


@pytest.mark.parametrize("arch,method,layer_gemms,oracle_gemms", [
    # GCNII: sup @ W forward, supᵀ·g for θ, g·Wᵀ for the input: 3 a layer
    # where the oracle's second call redoes both halves (5); GAS walks once
    ("gcnii", "lmc", 3 * LAYERS, 5 * LAYERS),
    ("gcnii", "gas", 3 * LAYERS, 3 * LAYERS),
    # GCN: layer 0 takes no input adjoint (the features have none)
    ("gcn", "lmc", 3 * LAYERS - 1, 5 * LAYERS),
    ("gcn", "gas", 3 * LAYERS - 1, 3 * LAYERS),
], ids=lambda v: str(v))
def test_the_step_runs_only_the_needed_products(graph, arch, method,
                                                layer_gemms, oracle_gemms):
    m = METHODS[method]
    setup = _setup(graph, arch, m, "ti")
    gnn = setup[0]
    got = _count_ops(make_train_step(gnn, m, N, backend="ti"), setup)
    want = _count_ops(two_call_step(gnn, m, "ti"), setup)
    outside = OUTSIDE[arch, method]
    assert got["gemm"] == layer_gemms + outside, got
    assert want["gemm"] == oracle_gemms + outside, want
    # SpMMs: every layer forward, and over Aᵀ for each input adjoint taken
    # (GCNII: every layer, h0 is its layer 0's input; GCN: layers 1..L-1);
    # the oracle: every layer, once for each call of its VJP
    adjoints = LAYERS if arch == "gcnii" else LAYERS - 1
    assert got["spmm"] == BUCKETS * (LAYERS + adjoints), got
    calls = 2 if method == "lmc" else 1
    assert want["spmm"] == BUCKETS * (LAYERS + calls * LAYERS), want


@pytest.mark.parametrize("arch", ["gcn", "gcnii"])
def test_each_step_records_its_spmm_launches(graph, arch, monkeypatch):
    """``spmm_launches`` a step: 0 on the CPU, where the wrappers run their
    plain twins; with the twins standing in as launches (the counter
    bumped), the step's launches: each layer's buckets forward and over Aᵀ
    for each input adjoint taken."""
    from repro_torch.core import LMC
    from repro_torch.optim import sgd
    from repro_torch.train import GNNTrainer

    def trainer():
        gnn = make_gnn(arch, graph.feature_dim, HIDDEN, graph.num_classes,
                       LAYERS, generator=torch.Generator().manual_seed(0))
        return GNNTrainer(gnn, LMC, graph, tgraph.ClusterSampler(
            graph, PARTS, 1, parts=tiny_parts(), seed=1), sgd(lr=0.1),
            backend="ell", device="cpu", straggler_deadline=float("inf"))

    tr = trainer()
    tr.run(2)
    assert [r["spmm_launches"] for r in tr.history] == [0, 0]

    plain = OPS.ell_spmm_scatter

    def launched(*a):
        SPMM.LAUNCHES += 1
        return plain(*a)

    monkeypatch.setattr(OPS, "ell_spmm_scatter", launched)
    tr = trainer()
    tr.run(2)
    adjoints = LAYERS if arch == "gcnii" else LAYERS - 1
    want = BUCKETS * (LAYERS + adjoints)
    assert [r["spmm_launches"] for r in tr.history] == [want, want]
    assert all(np.isfinite(r["loss"]) for r in tr.history)
