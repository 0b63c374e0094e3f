"""GAT in the port against the plain reference (``perfbench/reference/
arch_gat.py``), on the CPU in f64: one layer's forward and every VJP (the
parameter leaves and ``d h_in``) in its ``segment`` form (``gat_aggregate``
over the edge list) and through the ELL plain twins of the attention kernels
(``kernels.gat_attention``), over a graph with padding edges (``w = 0``)
into row 0, a row with only its self loop and rows split into pieces across
buckets; the parameters' names and shapes at GAT-PPI's widths; the
attention plan; and the count of attention launches a step."""
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# the plain reference lives in the benchmark, at the repository's root
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.reference import arch_gat  # noqa: E402
from perfbench.reference.lmc import Agg  # noqa: E402
from repro_torch.kernels import attention_plan, ell_from_coo  # noqa: E402
from repro_torch.models.gnn import EdgeList, LayerAux, make_gnn  # noqa: E402

GAT = importlib.import_module("repro_torch.kernels.gat_attention")

# averaged last layer 3 heads x 5 and concatenated 2 heads x 3: neither
# width a multiple of 4
CFG = {"feature_dim": 5, "hidden_dim": 6, "num_layers": 2, "num_classes": 5,
       "arch_kw": {"heads": 2, "out_heads": 3}}
N = 9
LONE = 8          # no edge in: its self loop alone
PAD = 5           # padding edges (w = 0) into row 0
BUCKETS = (2, 4)  # small buckets: rows of more than 4 edges split
NAMES = ("w", "att_src", "att_dst", "skip_w", "b", "skip_b")


def _graph():
    """Real edges j→i without duplicates or self loops, none into LONE; then
    ``PAD`` padding edges into row 0."""
    rng = np.random.default_rng(3)
    pairs = sorted({(int(a), int(b)) for a, b in rng.integers(0, N, (40, 2))
                    if a != b and b != LONE})
    src, dst = (np.array(c, np.int64) for c in zip(*pairs))
    psrc = np.concatenate([src, rng.integers(0, N, PAD)])
    pdst = np.concatenate([dst, np.zeros(PAD, np.int64)])
    pw = np.concatenate([np.full(src.shape[0], 0.5), np.zeros(PAD)])
    return src, dst, psrc, pdst, pw


def _gnn():
    return make_gnn("gat", CFG["feature_dim"], CFG["hidden_dim"],
                    CFG["num_classes"], CFG["num_layers"],
                    **CFG["arch_kw"])


def _aux(gnn, form, psrc, pdst, pw, h):
    edges = EdgeList(torch.from_numpy(psrc).int(),
                     torch.from_numpy(pdst).int(), torch.from_numpy(pw))
    ell = (ell_from_coo(psrc, pdst, pw, N, buckets=BUCKETS,
                        with_transpose=True) if form == "ell" else None)
    return gnn.prepare(LayerAux(edges=edges, x=h, h0=h, self_w=None,
                                ell=ell))


def _layer(gnn, form, l, lp, h, graph):
    _, _, psrc, pdst, pw = graph
    aux = _aux(gnn, form, psrc, pdst, pw, h)
    return torch.func.vjp(lambda p, x: gnn.layer_apply(p, l, x, aux), lp, h)


def test_gat_ppi_parameters_are_the_references_leaves():
    with torch.device("meta"):
        gnn = make_gnn("gat", 50, 1024, 121, 3, heads=4, out_heads=6)
    cfg = {"feature_dim": 50, "hidden_dim": 1024, "num_layers": 3,
           "num_classes": 121, "arch_kw": {"heads": 4, "out_heads": 6}}
    got = {k: tuple(v.shape) for k, v in gnn.state_dict().items()}
    assert got == {n: tuple(s) for n, s, _ in arch_gat.leaves(cfg)}
    assert not any(k.startswith(("head.", "embed.")) for k in got)
    assert gnn.store_widths() == (1024, 1024, 121)
    with torch.device("meta"):
        gcn = make_gnn("gcn", 50, 64, 121, 3)
    assert gcn.store_widths() == (64, 64, 64)


@pytest.mark.parametrize("form", ["segment", "ell"])
@pytest.mark.parametrize("l", [0, 1], ids=["concat", "average"])
def test_gat_layer_and_vjps_equal_the_reference(form, l):
    graph = _graph()
    src, dst = graph[:2]
    agg = Agg(src, dst, np.ones(src.shape[0]), N, "cpu")
    gen = torch.Generator().manual_seed(l)
    p = {name: torch.randn(shape, generator=gen, dtype=torch.float64)
         for name, shape, _ in arch_gat.leaves(CFG)}
    h = torch.randn((N, arch_gat.widths(CFG)[l]), generator=gen,
                    dtype=torch.float64)
    ct = torch.randn((N, arch_gat.widths(CFG)[l + 1]), generator=gen,
                     dtype=torch.float64)
    want, ctx = arch_gat.layer(p, CFG, l, agg, None, h, None)
    want_p = arch_gat.layer_vjp_params(p, CFG, l, ctx, ct)
    want_h, _ = arch_gat.layer_vjp_input(p, CFG, l, ctx, ct, None, None)
    lp = {k: p[f"layers.{k}.{l}"] for k in NAMES}
    out, vjp = _layer(_gnn(), form, l, lp, h, graph)
    got_p, got_h = vjp(ct)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-12)
    torch.testing.assert_close(got_h, want_h, rtol=0, atol=1e-12)
    for k in NAMES:
        torch.testing.assert_close(got_p[k], want_p[f"layers.{k}.{l}"],
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("form", ["segment", "ell"])
def test_padding_edges_change_nothing(form):
    """The same layer with and without the padding edges into row 0."""
    src, dst, psrc, pdst, pw = _graph()
    gnn = _gnn()
    gen = torch.Generator().manual_seed(7)
    lp = {k: v.detach().double() for k, v in
          gnn.layer_params(gnn.params(), 1).items()}
    h = torch.randn((N, CFG["hidden_dim"]), generator=gen,
                    dtype=torch.float64)
    ct = torch.randn((N, CFG["num_classes"]), generator=gen,
                     dtype=torch.float64)
    runs = []
    for g in ((src, dst, src, dst, np.full(src.shape[0], 0.5)),
              (src, dst, psrc, pdst, pw)):
        out, vjp = _layer(gnn, form, 1, lp, h, g)
        runs.append((out, *vjp(ct)))
    (o1, p1, h1), (o2, p2, h2) = runs
    torch.testing.assert_close(o1, o2, rtol=0, atol=1e-13)
    torch.testing.assert_close(h1, h2, rtol=0, atol=1e-13)
    for k in NAMES:
        torch.testing.assert_close(p1[k], p2[k], rtol=0, atol=1e-13)


def test_a_layer_over_an_ell_without_its_plan_raises():
    """The kernel takes the batch's attention plan, which ``GNN.prepare``
    makes once a step; a LayerAux that skipped it is refused."""
    _, _, psrc, pdst, pw = _graph()
    gnn = _gnn()
    h = torch.zeros((N, CFG["feature_dim"]))
    aux = _aux(gnn, "ell", psrc, pdst, pw, h)._replace(attn=None)
    with pytest.raises(ValueError, match="GNN.prepare"):
        gnn.layer_apply(gnn.layer_params(gnn.params(), 0), 0, h, aux)


def test_a_row_with_only_its_self_loop_attends_to_itself():
    _, _, psrc, pdst, pw = _graph()
    ell = ell_from_coo(psrc, pdst, pw, N, buckets=BUCKETS,
                       with_transpose=True)
    gen = torch.Generator().manual_seed(1)
    z = torch.randn((N, 2, 3), generator=gen, dtype=torch.float64)
    u, v = torch.randn((2, N, 2), generator=gen, dtype=torch.float64)
    o, lse = GAT.attention_plain(attention_plan(ell).fwd, z, u, v)
    torch.testing.assert_close(o[LONE], z[LONE], rtol=0, atol=0)
    e = torch.nn.functional.leaky_relu(u[LONE] + v[LONE], 0.2)
    torch.testing.assert_close(lse[LONE], e, rtol=0, atol=1e-15)


def test_the_plan_lists_each_rows_pieces_and_drops_padding():
    """A row of 11 edges splits into pieces of 4, 4 and 3 across buckets;
    row 0's padding-only pieces are left out; rows are in order."""
    src = np.concatenate([np.arange(1, 12), [3], np.zeros(9, np.int64)])
    dst = np.concatenate([np.full(11, 2), [1], np.zeros(9, np.int64)])
    w = np.concatenate([np.ones(12), np.zeros(9)])
    ell = ell_from_coo(src, dst, w, 12, buckets=BUCKETS)
    p = attention_plan(ell).fwd
    ptr = p.ptr.tolist()
    assert ptr[0] == ptr[1] == 0          # row 0: padding alone, no piece
    assert ptr[2] - ptr[1] == 1 and ptr[3] - ptr[2] == 3
    assert ptr[-1] == 4 and attention_plan(ell).bwd is None
    codes = p.code[:4].tolist()
    buckets = [c % 4 for c in codes]
    rows = [int(ell.bucket_rows[c % 4][c // 4]) for c in codes]
    assert rows == [1, 2, 2, 2] and buckets == [0, 1, 1, 1]


def _fake_launch(symbol, argtypes, tensors, p, z):
    """The kernels' arithmetic by the plain twins, written into the launch's
    outputs, counted as the wrapper counts a launch."""
    if symbol == "repro_gat_attn_fwd":
        zz, u, v, o, lse = tensors
        for out, val in zip((o, lse), GAT.attention_plain(p, zz, u, v)):
            out.copy_(val)
    elif symbol == "repro_gat_attn_dst":
        zz, u, v, lse, go, d, dv = tensors
        for out, val in zip((d, dv), GAT.dst_plain(p, zz, u, v, lse, go)):
            out.copy_(val)
    else:
        zz, u, v, lse, go, d, dz, du = tensors
        for out, val in zip((dz, du), GAT.src_plain(p, zz, u, v, lse, go,
                                                    d)):
            out.copy_(val)
    GAT.LAUNCHES += 1


@pytest.mark.parametrize("arch", ["gat", "gcn"])
def test_attn_launches_a_step(arch, monkeypatch):
    """A GAT step on the ELL backend records the launches the code
    predicts: a forward each layer, and two VJP calls each layer (its
    parameters' cotangent and its input's), each two launches; a GCN step
    records 0. The kernels are stood in for by their twins."""
    from repro_torch.core import LMC
    from repro_torch.graph import ClusterSampler
    from repro_torch.graph.synthetic import make_sbm_dataset
    from repro_torch.optim import sgd
    from repro_torch.train import GNNTrainer
    monkeypatch.setattr(GAT, "_plain_path", lambda z: False)
    monkeypatch.setattr(GAT, "_launch", _fake_launch)
    graph = make_sbm_dataset("ppi-cpu", seed=0)
    gnn = make_gnn(arch, graph.feature_dim, 16, graph.num_classes, 3,
                   heads=4, out_heads=2,
                   generator=torch.Generator().manual_seed(0))
    tr = GNNTrainer(gnn, LMC, graph, ClusterSampler(graph, 8, 2, seed=1),
                    sgd(lr=0.1), backend="ell", device="cpu",
                    straggler_deadline=float("inf"))
    tr.run(2)
    L = gnn.num_layers
    want = L * (GAT.LAUNCHES_FORWARD + 2 * GAT.LAUNCHES_BACKWARD)
    assert [r["attn_launches"] for r in tr.history] == \
        [want if arch == "gat" else 0] * 2
    assert all(np.isfinite(r["loss"]) for r in tr.history)
