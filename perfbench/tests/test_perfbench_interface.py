"""The plain reference's architecture interface (``reference/lmc.py``): the
aggregation's edges on ``Agg``, per-layer stores sized from the module's
widths, the optional head; LMC's step with every cluster in one batch
(no halo) equal to the exact full-graph gradient, in f64, for every
architecture; and the training driver passing a configuration's
``arch_kw`` to the program."""
import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.data.sbm import make_sbm
from perfbench.drivers import train
from perfbench.reference import graph as rgraph
from perfbench.reference.lmc import Agg, RefLMC, arch_module, linear_head
from perfbench.tests._small import small_ctx

ARCHS = {
    "gcn": {"arch": "gcn", "num_layers": 2, "hidden_dim": 8},
    "gcnii": {"arch": "gcnii", "num_layers": 3, "hidden_dim": 8,
              "alpha": 0.1, "lam": 0.5},
    "gat": {"arch": "gat", "num_layers": 3, "hidden_dim": 8,
            "arch_kw": {"heads": 2, "out_heads": 3}},
}
PARTS = 4


@pytest.fixture(scope="module")
def ppi():
    """ppi-cpu (2,048 nodes, degree 28, 50 features, 16 classes)."""
    return make_sbm("ppi-cpu", seed=0)


def _cfg(arch, arrays):
    return dict(ARCHS[arch], feature_dim=arrays["x"].shape[1],
                num_classes=int(arrays["y"].max()) + 1)


def _full_graph_grads(cfg, arrays, weights):
    """The loss and gradients of the full graph by ``torch.autograd`` through
    the architecture's own forward, f64: every node, every edge, GCN weights
    from the degrees (rounded to f32, as the subgraph gives them), the mean
    cross-entropy over the training nodes."""
    arch = arch_module(cfg["arch"])
    indptr, indices = arrays["indptr"], arrays["indices"]
    n, deg = indptr.shape[0] - 1, np.diff(indptr)
    src = indices.astype(np.int64)
    dst = np.repeat(np.arange(n, dtype=np.int64), deg)
    dp1 = deg + 1.0
    w = (1.0 / np.sqrt(dp1[src] * dp1[dst])).astype(np.float32)
    agg = Agg(src, dst, w.astype(np.float64), n, "cpu")
    s = torch.from_numpy((1.0 / dp1).astype(np.float32)).double()
    p = {k: v.double().requires_grad_() for k, v in weights.items()}
    x = torch.from_numpy(arrays["x"]).double()
    h = h0 = arch.embed(p, x)
    for l in range(cfg["num_layers"]):
        h, _ = arch.layer(p, cfg, l, agg, s, h, h0)
    logits = getattr(arch, "head", linear_head)(p, h)
    y = torch.from_numpy(arrays["y"].astype(np.int64))
    tm = torch.from_numpy(arrays["train_mask"]).double()
    logp = torch.log_softmax(logits, -1).gather(1, y[:, None])[:, 0]
    loss = -(logp * tm).sum() / tm.sum()
    grads = torch.autograd.grad(loss, list(p.values()))
    return float(loss.detach()), dict(zip(p, grads))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_full_batch_step_is_the_exact_gradient(arch, ppi):
    cfg = _cfg(arch, ppi)
    weights = harness.make_weights(cfg, 2**31 + 5, torch.device("cpu"))
    parts = rgraph.partition(ppi["indptr"], ppi["indices"], PARTS)
    cids = rgraph.epoch_clusters(7, 0, PARTS, PARTS)
    nodes = np.concatenate([np.flatnonzero(parts == c) for c in cids])
    ref = RefLMC(cfg, ppi, weights, num_parts=PARTS, per_batch=PARTS,
                 lr=0.1, device="cpu", dtype=torch.float64)
    out = ref.step(nodes)
    loss, want = _full_graph_grads(cfg, ppi, weights)
    assert out["loss"] == pytest.approx(loss, rel=1e-12)
    assert sorted(out["raw"]) == sorted(want)
    for k, g in want.items():
        torch.testing.assert_close(out["raw"][k], g, rtol=0, atol=1e-10,
                                   msg=k)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_stores_take_each_layers_width(arch, ppi):
    cfg = _cfg(arch, ppi)
    widths = arch_module(arch).widths(cfg)
    ref = RefLMC(cfg, ppi, harness.make_weights(cfg, 1, torch.device("cpu")),
                 num_parts=PARTS, per_batch=1, lr=0.1, device="cpu")
    n, L = ppi["x"].shape[0], cfg["num_layers"]
    assert [tuple(t.shape) for t in ref.H] == [(n, widths[l + 1])
                                               for l in range(L)]
    assert [tuple(t.shape) for t in ref.V] == [(n, widths[l + 1])
                                               for l in range(L - 1)]
    if arch != "gat":   # one width, as the single (L, n, d) store had
        assert {t.shape[1] for t in ref.H + ref.V} == {cfg["hidden_dim"]}
    else:
        assert ref.H[-1].shape[1] == cfg["num_classes"]


def test_agg_carries_the_edges_and_aggregates_by_them():
    src = np.array([0, 2, 2, 3], np.int64)
    dst = np.array([1, 0, 1, 1], np.int64)
    w = np.array([0.5, 2.0, -1.0, 3.0])
    agg, agg_t = Agg(src, dst, w, 4, "cpu"), Agg(dst, src, w, 4, "cpu")
    dense = torch.zeros((4, 4), dtype=torch.float64)
    dense[torch.from_numpy(dst), torch.from_numpy(src)] = torch.from_numpy(w)
    h = torch.arange(8, dtype=torch.float64).reshape(4, 2)
    torch.testing.assert_close(agg(h), dense @ h, rtol=0, atol=0)
    torch.testing.assert_close(agg_t(h), dense.T @ h, rtol=0, atol=0)
    assert agg.n == agg_t.n == 4 and agg.src.dtype == torch.int64
    assert torch.equal(agg.src, agg_t.dst) and torch.equal(agg.dst, agg_t.src)
    assert torch.equal(agg.w, torch.from_numpy(w))


class _Stop(Exception):
    pass


@pytest.mark.parametrize("arch_kw", [None, {"heads": 2, "out_heads": 3}],
                         ids=["none", "gat-heads"])
def test_program_passes_the_configurations_arch_keys(arch_kw, cache,
                                                     monkeypatch):
    import repro_torch.models
    seen = []

    def make_gnn(*args, **kw):
        seen.append((args, kw))
        raise _Stop

    monkeypatch.setattr(repro_torch.models, "make_gnn", make_gnn)
    ctx = small_ctx("gcn-arxiv.train")
    if arch_kw is not None:
        ctx.config = dict(ctx.config, arch="gat", arch_kw=arch_kw)
    cfg = ctx.config
    arrays = harness.dataset(cfg["dataset"])
    parts = np.arange(arrays["x"].shape[0]) % cfg["num_parts"]
    with pytest.raises(_Stop):
        train.Program(ctx, arrays, parts=parts)
    assert seen == [((cfg["arch"], cfg["feature_dim"], cfg["hidden_dim"],
                      cfg["num_classes"], cfg["num_layers"]),
                     {"alpha": 0.1, "lam": 0.5, **(arch_kw or {})})]
