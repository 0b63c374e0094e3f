"""The plain GAT (``reference/arch_gat.py``) against independent forms at a
tiny size, in f64: its layer against a dense formulation (scores as an
(n, n, H) tensor masked by A + I, a softmax along the source axis), its
hand-written VJPs against ``torch.autograd`` of that dense form; and the
attention's work counts and step FLOPs by hand."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from perfbench import yardstick
from perfbench.reference import arch_gat
from perfbench.reference.lmc import Agg

CFG = {"feature_dim": 5, "hidden_dim": 6, "num_layers": 2, "num_classes": 4,
       "arch_kw": {"heads": 2, "out_heads": 3}}
N = 7
LONE = 6          # a row with no edge in: its self loop alone


def _graph():
    """Random edges j→i without duplicates or self loops; no edge into
    ``LONE``."""
    rng = np.random.default_rng(3)
    pairs = {(int(a), int(b)) for a, b in rng.integers(0, N, (24, 2))
             if a != b and b != LONE}
    src, dst = (np.array(c, np.int64) for c in zip(*sorted(pairs)))
    return src, dst


def _params(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {name: torch.randn(shape, generator=gen, dtype=torch.float64)
            for name, shape, _ in arch_gat.leaves(CFG)}


def _dense_layer(p, l, mask, h):
    """The layer by its equations over a dense (n, n) edge mask."""
    H, Fw, concat = ((2, 3, True) if l == 0 else (3, CFG["num_classes"],
                                                  False))
    n = h.shape[0]
    z = (h @ p[f"layers.w.{l}"]).view(n, H, Fw)
    u = torch.einsum("nhf,hf->nh", z, p[f"layers.att_src.{l}"])
    v = torch.einsum("nhf,hf->nh", z, p[f"layers.att_dst.{l}"])
    e = F.leaky_relu(v[:, None, :] + u[None, :, :], 0.2)     # (i, j, H)
    e = e.masked_fill(~mask[:, :, None], float("-inf"))
    alpha = torch.softmax(e, dim=1)
    o = torch.einsum("ijh,jhf->ihf", alpha, z)
    y = o.reshape(n, H * Fw) if concat else o.mean(1)
    t = (y + p[f"layers.b.{l}"] + h @ p[f"layers.skip_w.{l}"]
         + p[f"layers.skip_b.{l}"])
    return t if l == CFG["num_layers"] - 1 else F.elu(t)


def _setup(l):
    src, dst = _graph()
    agg = Agg(src, dst, np.ones(src.shape[0]), N, "cpu")
    mask = torch.eye(N, dtype=torch.bool)
    mask[dst, src] = True
    d_in = arch_gat.widths(CFG)[l]
    h = torch.randn((N, d_in), generator=torch.Generator().manual_seed(l + 1),
                    dtype=torch.float64)
    return agg, mask, h


@pytest.mark.parametrize("l", [0, 1], ids=["concat", "average"])
def test_gat_layer_equals_the_dense_form(l):
    agg, mask, h = _setup(l)
    p = _params()
    out, _ = arch_gat.layer(p, CFG, l, agg, None, h, None)
    torch.testing.assert_close(out, _dense_layer(p, l, mask, h),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("l", [0, 1], ids=["concat", "average"])
def test_gat_vjps_equal_autograd(l):
    agg, mask, h = _setup(l)
    p = _params()
    ct = torch.randn((N, arch_gat.widths(CFG)[l + 1]),
                     generator=torch.Generator().manual_seed(9),
                     dtype=torch.float64)
    names = [k for k in p if k.endswith(f".{l}")]
    pg = {k: v.clone().requires_grad_(k in names) for k, v in p.items()}
    hg = h.clone().requires_grad_()
    want = torch.autograd.grad((_dense_layer(pg, l, mask, hg) * ct).sum(),
                               [pg[k] for k in names] + [hg])
    _, ctx = arch_gat.layer(p, CFG, l, agg, None, h, None)
    got = arch_gat.layer_vjp_params(p, CFG, l, ctx, ct)
    assert sorted(got) == sorted(names)
    for k, w in zip(names, want):
        torch.testing.assert_close(got[k], w, rtol=0, atol=1e-10)
    gh, gh0 = arch_gat.layer_vjp_input(p, CFG, l, ctx, ct, None, None)
    assert gh0 is None
    torch.testing.assert_close(gh, want[-1], rtol=0, atol=1e-10)


def test_gat_head_vjp_equals_autograd():
    h = torch.randn((N, CFG["num_classes"]), dtype=torch.float64,
                    requires_grad=True)
    G = torch.randn((N, CFG["num_classes"]), dtype=torch.float64)
    (want,) = torch.autograd.grad((arch_gat.head({}, h) * G).sum(), [h])
    grads, dh = arch_gat.head_vjp({}, h.detach(), G)
    assert grads == {}
    torch.testing.assert_close(dh, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("l", [0, 1], ids=["concat", "average"])
def test_a_row_with_only_its_self_loop_attends_to_itself(l):
    agg, _, h = _setup(l)
    _, ctx = arch_gat.layer(_params(), CFG, l, agg, None, h, None)
    into = ctx["dst"] == LONE
    assert int(into.sum()) == 1 and int(ctx["src"][into]) == LONE
    torch.testing.assert_close(ctx["alpha"][into],
                               torch.ones_like(ctx["alpha"][into]),
                               rtol=0, atol=0)


def test_attention_work_by_hand():
    # 3 rows, 4 edges + 3 self loops (E' 7), 2 heads of width 5, out 10:
    # z 3*2*5, u and v 3*2 each, out 3*10 (f32), 7 source indices
    assert yardstick.attention_work(3, 4, 2, 5, 10) == (
        (30 + 12 + 30) * 4 + 7 * 4, 7 * 2 * (2 * 5 + 5.0))
    # VJP: z and dz 2*3*2*5, dout 3*10, u, v, du, dv 4*3*2, 7 indices
    assert yardstick.attention_vjp_work(3, 4, 2, 5, 10) == (
        (60 + 30 + 24) * 4 + 7 * 4, 7 * 2 * (4 * 5 + 8.0))


def test_attention_widths_at_gat_ppi():
    cfg = {"feature_dim": 50, "hidden_dim": 1024, "num_layers": 3,
           "num_classes": 121}
    assert arch_gat.widths(cfg) == [50, 1024, 1024, 121]
    assert arch_gat.attention_widths(cfg) == [
        (4, 256, 1024, 1), (4, 256, 1024, 2), (6, 121, 121, 2)]
    assert arch_gat.spmm_widths(cfg) == []


def test_gat_step_flops_by_hand():
    cfg = {"feature_dim": 2, "hidden_dim": 4, "num_layers": 2,
           "num_classes": 3, "arch_kw": {"heads": 2, "out_heads": 2}}
    rows, batch, edges = 5, 2, 6          # E' = 11
    # layer 0: 2 -> 2 heads x 2, concat (4): z and skip GEMMs 2*5*2*4 each;
    # scores 4*5*4; attention 11*2*(2*2+5); params' VJP: attention 11*2*
    # (4*2+8), scores 8*5*4, the GEMMs' weight gradients 2*5*2*4 each
    l0 = (80 + 80) + 80 + 198 + 352 + 160 + (80 + 80)
    # layer 1: 4 -> 2 heads x 3, averaged (3): z GEMM 2*5*4*6, skip 2*5*4*3;
    # scores 4*5*6; attention 11*2*(2*3+5); params' VJP 11*2*(4*3+8) +
    # 8*5*6 + the weight gradients; input's VJP 11*2*(4*3+8) + 4*5*6 + the
    # input gradients (the same sizes as the GEMMs)
    gemms = 240 + 120
    l1 = gemms + 120 + 242 + (440 + 240 + gemms) + (440 + 120 + gemms)
    assert arch_gat.step_flops(cfg, rows, batch, edges) == l0 + l1


def test_heads_must_divide_the_hidden_width():
    with pytest.raises(ValueError, match="multiple of heads"):
        arch_gat.leaves(dict(CFG, hidden_dim=7))
