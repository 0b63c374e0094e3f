"""GAT (Veličković et al., ICLR 2018, §3.3, the inductive PPI model), plain,
with a linear skip beside each attention layer (PyTorch Geometric's
``examples/ppi.py``). Layer l, with ``z = h W_l`` viewed as
``(n, H_l, F_l)``:

* scores ``u = Σ_f z·a_src``, ``v = Σ_f z·a_dst``, and over the subgraph's
  edges j→i plus one self loop a row ``e_ij = LeakyReLU_0.2(u_j + v_i)``;
* ``α`` the softmax of ``e`` over each row's edges (max-subtracted);
* ``o_i = Σ_j α_ij z_j``, heads concatenated (averaged on the last layer),
  ``+ b_l``, plus the skip ``h S_l + c_l``; ELU on every layer but the last,
  whose output is the logits (the head is the identity).

Each layer has ``heads`` heads of ``hidden_dim / heads`` features; the last
``out_heads`` heads of ``num_classes`` features (``cfg["arch_kw"]``). The
edge weights ``w`` are not used. VJPs written by hand.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

EMBED = False          # H^0 is the features
LAYER0_INPUT_IS_H0 = False
SLOPE = 0.2            # LeakyReLU's negative slope
ARCH_KW = {"heads": 4, "out_heads": 6}


def _shape(cfg: dict, l: int) -> tuple:
    """``(heads, width, concat)`` of layer ``l``."""
    kw = {**ARCH_KW, **cfg.get("arch_kw", {})}
    if l == cfg["num_layers"] - 1:
        return kw["out_heads"], cfg["num_classes"], False
    if cfg["hidden_dim"] % kw["heads"]:
        raise ValueError(f"hidden_dim {cfg['hidden_dim']} is not a multiple "
                         f"of heads {kw['heads']}")
    return kw["heads"], cfg["hidden_dim"] // kw["heads"], True


def widths(cfg: dict) -> list:
    """Input width of each layer, then the last layer's output width."""
    return ([cfg["feature_dim"]]
            + [cfg["hidden_dim"]] * (cfg["num_layers"] - 1)
            + [cfg["num_classes"]])


def attention_widths(cfg: dict) -> list:
    """``(heads, width, out_width, backwards)`` of each layer's attention
    aggregation: ``out_width`` is ``heads × width`` where the heads are
    concatenated, ``width`` where averaged; ``backwards`` counts the
    aggregation's VJPs one LMC step needs: one for every layer (its
    parameters' cotangent [V̄; 0], since ``dz`` gives W's gradient and the
    scores' gradients a_src's and a_dst's), and a second past the first layer
    (the adjoints' cotangent [V̄; V̂]; layer 0's input, the features, has
    none)."""
    out = []
    for l in range(cfg["num_layers"]):
        H, Fw, concat = _shape(cfg, l)
        out.append((H, Fw, H * Fw if concat else Fw, 1 if l == 0 else 2))
    return out


def leaves(cfg: dict) -> list:
    """``(name, shape, init)`` of every parameter, in the program's names."""
    dims, L = widths(cfg), cfg["num_layers"]
    hf = [_shape(cfg, l)[:2] for l in range(L)]
    out = [(f"layers.w.{l}", (dims[l], hf[l][0] * hf[l][1]), "glorot")
           for l in range(L)]
    out += [(f"layers.att_src.{l}", hf[l], "glorot") for l in range(L)]
    out += [(f"layers.att_dst.{l}", hf[l], "glorot") for l in range(L)]
    out += [(f"layers.skip_w.{l}", (dims[l], dims[l + 1]), "glorot")
            for l in range(L)]
    out += [(f"layers.b.{l}", (dims[l + 1],), "zeros") for l in range(L)]
    out += [(f"layers.skip_b.{l}", (dims[l + 1],), "zeros") for l in range(L)]
    return out


def embed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """H^0 = X."""
    return x


def _softmax_by_row(e: torch.Tensor, dst: torch.Tensor, n: int):
    """Each head's softmax of the edge scores ``e`` (E, H) over the edges
    sharing a destination row, the row's max subtracted first."""
    m = torch.full((n, e.shape[1]), float("-inf"), dtype=e.dtype,
                   device=e.device)
    m = m.scatter_reduce(0, dst[:, None].expand_as(e), e, "amax")
    ex = torch.exp(e - m[dst])
    den = torch.zeros_like(m).index_add_(0, dst, ex)
    return ex / den[dst]


def layer(p: dict, cfg: dict, l: int, agg, s, h: torch.Tensor, h0):
    """Layer ``l`` over the rows of ``h``; the edges are ``agg.src`` →
    ``agg.dst`` (its CSR and weights are not used). Returns (output, VJP
    context)."""
    H, Fw, concat = _shape(cfg, l)
    n = h.shape[0]
    loop = torch.arange(n, device=h.device)
    src, dst = torch.cat([agg.src, loop]), torch.cat([agg.dst, loop])
    z = (h @ p[f"layers.w.{l}"]).view(n, H, Fw)
    u = (z * p[f"layers.att_src.{l}"]).sum(-1)
    v = (z * p[f"layers.att_dst.{l}"]).sum(-1)
    pre = u[src] + v[dst]
    alpha = _softmax_by_row(F.leaky_relu(pre, SLOPE), dst, n)
    o = torch.zeros_like(z).index_add_(0, dst, alpha[..., None] * z[src])
    y = o.reshape(n, H * Fw) if concat else o.mean(1)
    t = (y + p[f"layers.b.{l}"] + h @ p[f"layers.skip_w.{l}"]
         + p[f"layers.skip_b.{l}"])
    last = l == cfg["num_layers"] - 1
    ctx = {"h": h, "z": z, "src": src, "dst": dst, "pre": pre,
           "alpha": alpha, "t": t, "last": last}
    return (t if last else F.elu(t)), ctx


def _vjp(p: dict, cfg: dict, l: int, ctx: dict, ct: torch.Tensor) -> tuple:
    """``(gt, gz, gu, gv)``: the cotangent of the pre-activation ``t``, and
    of ``z`` (through the attention and the scores) and of the scores."""
    H, Fw, concat = _shape(cfg, l)
    z, src, dst, alpha = ctx["z"], ctx["src"], ctx["dst"], ctx["alpha"]
    n, t = z.shape[0], ctx["t"]
    gt = ct if ctx["last"] else torch.where(t > 0, ct, ct * torch.exp(t))
    go = (gt.view(n, H, Fw) if concat
          else (gt / H)[:, None, :].expand(n, H, Fw))
    g_alpha = (go[dst] * z[src]).sum(-1)
    gz = torch.zeros_like(z).index_add_(0, src, alpha[..., None] * go[dst])
    dot = torch.zeros((n, H), dtype=z.dtype, device=z.device).index_add_(
        0, dst, alpha * g_alpha)
    ge = alpha * (g_alpha - dot[dst])
    gpre = torch.where(ctx["pre"] > 0, ge, SLOPE * ge)
    gu = torch.zeros_like(dot).index_add_(0, src, gpre)
    gv = torch.zeros_like(dot).index_add_(0, dst, gpre)
    gz = (gz + gu[..., None] * p[f"layers.att_src.{l}"]
          + gv[..., None] * p[f"layers.att_dst.{l}"])
    return gt, gz, gu, gv


def layer_vjp_params(p: dict, cfg: dict, l: int, ctx, ct) -> dict:
    """Layer ``l``'s parameter gradients for cotangent ``ct``."""
    gt, gz, gu, gv = _vjp(p, cfg, l, ctx, ct)
    h, z = ctx["h"], ctx["z"]
    gb = gt.sum(0)
    return {f"layers.w.{l}": h.T @ gz.reshape(z.shape[0], -1),
            f"layers.att_src.{l}": (gu[..., None] * z).sum(0),
            f"layers.att_dst.{l}": (gv[..., None] * z).sum(0),
            f"layers.b.{l}": gb, f"layers.skip_w.{l}": h.T @ gt,
            f"layers.skip_b.{l}": gb}


def layer_vjp_input(p: dict, cfg: dict, l: int, ctx, ct, agg_t, s):
    """(d h_in, d h0) for cotangent ``ct``; the edges come from ``ctx``."""
    gt, gz, _, _ = _vjp(p, cfg, l, ctx, ct)
    gh = (gz.reshape(gz.shape[0], -1) @ p[f"layers.w.{l}"].T
          + gt @ p[f"layers.skip_w.{l}"].T)
    return gh, None


def embed_vjp(p: dict, x: torch.Tensor, v0: torch.Tensor) -> dict:
    """No embedding parameters."""
    return {}


def head(p: dict, h: torch.Tensor) -> torch.Tensor:
    """The last layer's output is the logits."""
    return h


def head_vjp(p: dict, h: torch.Tensor, G: torch.Tensor) -> tuple:
    """No head parameters; the cotangent passes through."""
    return {}, G


def spmm_widths(cfg: dict) -> list:
    """None: GAT aggregates with learned weights, not the fixed-weight SpMM
    (``attention_widths`` lists its aggregations)."""
    return []


def step_flops(cfg: dict, rows: int, batch_rows: int, edges: int) -> float:
    """Model FLOPs of one LMC step over ``rows`` real batch + halo rows and
    ``edges`` real edges (E' = edges + rows with the self loops): per layer
    the GEMMs ``z = h W`` and the skip ``h S``, the scores ``u``, ``v``
    (a multiply-add per element of ``z`` each) and the attention
    aggregation (``yardstick.attention_work``'s E'·H·(2F + 5)); the
    parameters' VJP: the attention's VJP (E'·H·(4F + 8)), the scores'
    cotangent into ``dz`` and their parameters' gradients (2 × 2 per
    element of ``z``), and the GEMMs' weight gradients; past the first layer
    the input's VJP: the attention's VJP again, the scores into ``dz``, and
    the two GEMMs' input gradients. The head is the identity. Elementwise
    work (softmax normalisation aside), padding and recomputation are not
    counted."""
    dims, f = widths(cfg), 0.0
    e = edges + rows
    for l, (H, Fw, do, _) in enumerate(attention_widths(cfg)):
        di, hf = dims[l], H * Fw
        gemms = 2.0 * rows * di * hf + 2.0 * rows * di * do
        f += gemms + 4.0 * rows * hf + e * H * (2.0 * Fw + 5.0)
        f += e * H * (4.0 * Fw + 8.0) + 8.0 * rows * hf + gemms
        if l >= 1:
            f += e * H * (4.0 * Fw + 8.0) + 4.0 * rows * hf + gemms
    return f
