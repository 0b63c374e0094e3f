"""GCNII (Chen et al., ICML 2020, Eq. 5), plain, with one weight a layer:
``h0 = relu(x W_e + b_e)``; layer l: ``sup = (1-α) Â h + α h0``,
``h' = relu((1-β_l) sup + β_l sup W_l)``, ``β_l = ln(λ/(l+1) + 1)``; a
linear head. VJPs written by hand.
"""
from __future__ import annotations

import math

import torch

EMBED = True
LAYER0_INPUT_IS_H0 = True


def widths(cfg: dict) -> list:
    """Every layer's input width, then the output width."""
    return [cfg["hidden_dim"]] * (cfg["num_layers"] + 1)


def leaves(cfg: dict) -> list:
    """``(name, shape, init)`` of every parameter, in the program's names."""
    d, L = cfg["hidden_dim"], cfg["num_layers"]
    return ([(f"layers.w.{l}", (d, d), "glorot") for l in range(L)]
            + [("embed.w", (cfg["feature_dim"], d), "glorot"),
               ("embed.b", (d,), "zeros"),
               ("head.w", (d, cfg["num_classes"]), "glorot"),
               ("head.b", (cfg["num_classes"],), "zeros")])


def _beta(cfg: dict, l: int) -> float:
    return math.log(cfg["lam"] / (l + 1) + 1.0)


def embed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """H^0 = relu(X W_e + b_e)."""
    return torch.relu(x @ p["embed.w"] + p["embed.b"])


def layer(p: dict, cfg: dict, l: int, agg, s, h, h0):
    """Layer ``l`` over the rows of ``h``; returns (output, VJP context)."""
    a = agg(h) + s[:, None] * h
    alpha, b = cfg["alpha"], _beta(cfg, l)
    sup = (1 - alpha) * a + alpha * h0
    t = (1 - b) * sup + b * (sup @ p[f"layers.w.{l}"])
    pos = t > 0
    return torch.where(pos, t, torch.zeros((), dtype=t.dtype,
                                           device=t.device)), (sup, pos)


def layer_vjp_params(p: dict, cfg: dict, l: int, ctx, ct) -> dict:
    """Layer ``l``'s weight gradient for cotangent ``ct``."""
    sup, pos = ctx
    return {f"layers.w.{l}": _beta(cfg, l) * (sup.T @ (ct * pos))}


def layer_vjp_input(p: dict, cfg: dict, l: int, ctx, ct, agg_t, s):
    """(d h_in, d h0) for cotangent ``ct``; ``agg_t(g) = Aᵀ g``."""
    _, pos = ctx
    alpha, b = cfg["alpha"], _beta(cfg, l)
    gt = ct * pos
    gsup = (1 - b) * gt + b * (gt @ p[f"layers.w.{l}"].T)
    ga = (1 - alpha) * gsup
    return agg_t(ga) + s[:, None] * ga, alpha * gsup


def embed_vjp(p: dict, x: torch.Tensor, v0: torch.Tensor) -> dict:
    """The embedding's gradients for the adjoint ``v0`` of H^0."""
    h0 = torch.relu(x @ p["embed.w"] + p["embed.b"])
    g = v0 * (h0 > 0)
    return {"embed.w": x.T @ g, "embed.b": g.sum(0)}


def spmm_widths(cfg: dict) -> list:
    """Every layer's forward aggregation and its backward over Aᵀ (layer
    0's input is h0, whose adjoint feeds the embedding's gradient)."""
    return [cfg["hidden_dim"]] * (2 * cfg["num_layers"])


def step_flops(cfg: dict, rows: int, batch_rows: int, edges: int) -> float:
    """Model FLOPs of one LMC step (see ``arch_gcn.step_flops``): the
    embedding forward over every row and its weight gradient over the batch
    rows; per layer the aggregation, the self loop and the GEMM forward, the
    weight gradient, the input gradient's GEMM and the aggregation over Aᵀ;
    the head as in GCN."""
    d, dx, c, L = (cfg["hidden_dim"], cfg["feature_dim"],
                   cfg["num_classes"], cfg["num_layers"])
    f = 2.0 * rows * dx * d + 2.0 * batch_rows * dx * d
    per_layer = (2.0 * edges * d + 2.0 * rows * d + 2.0 * rows * d * d
                 + 2.0 * rows * d * d
                 + 2.0 * rows * d * d + 2.0 * edges * d + 2.0 * rows * d)
    f += L * per_layer
    f += 2.0 * rows * d * c + 2.0 * batch_rows * d * c + 2.0 * rows * d * c
    return f
