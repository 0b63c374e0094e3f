"""GCN (Kipf & Welling, 2017), plain: ``h' = relu((Â h) W + b)`` with
``Â = D̃^-1/2 (A + I) D̃^-1/2``, the self loop applied as ``s ⊙ h``; the
input layer reads the features, a linear head gives the logits.

Each layer function takes the aggregation ``agg(h) = A h`` (the edges, not
the self loop) and returns what its VJP needs; the VJPs are written by hand.
"""
from __future__ import annotations

import torch

EMBED = False          # H^0 is the features
LAYER0_INPUT_IS_H0 = False


def widths(cfg: dict) -> list:
    """Input width of each layer, then the last layer's output width."""
    return [cfg["feature_dim"]] + [cfg["hidden_dim"]] * cfg["num_layers"]


def leaves(cfg: dict) -> list:
    """``(name, shape, init)`` of every parameter, in the program's names."""
    dims, L = widths(cfg), cfg["num_layers"]
    out = [(f"layers.w.{l}", (dims[l], dims[l + 1]), "glorot")
           for l in range(L)]
    out += [(f"layers.b.{l}", (dims[l + 1],), "zeros") for l in range(L)]
    out += [("head.w", (cfg["hidden_dim"], cfg["num_classes"]), "glorot"),
            ("head.b", (cfg["num_classes"],), "zeros")]
    return out


def embed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """H^0 = X."""
    return x


def layer(p: dict, cfg: dict, l: int, agg, s: torch.Tensor, h: torch.Tensor,
          h0: torch.Tensor):
    """Layer ``l`` over the rows of ``h``; returns (output, VJP context)."""
    a = agg(h) + s[:, None] * h
    z = a @ p[f"layers.w.{l}"] + p[f"layers.b.{l}"]
    pos = z > 0
    return torch.where(pos, z, torch.zeros((), dtype=z.dtype,
                                           device=z.device)), (a, pos)


def layer_vjp_params(p: dict, cfg: dict, l: int, ctx, ct) -> dict:
    """Layer ``l``'s parameter gradients for cotangent ``ct``."""
    a, pos = ctx
    gz = ct * pos
    return {f"layers.w.{l}": a.T @ gz, f"layers.b.{l}": gz.sum(0)}


def layer_vjp_input(p: dict, cfg: dict, l: int, ctx, ct, agg_t, s):
    """(d h_in, d h0) for cotangent ``ct``; ``agg_t(g) = Aᵀ g``."""
    _, pos = ctx
    ga = (ct * pos) @ p[f"layers.w.{l}"].T
    return agg_t(ga) + s[:, None] * ga, None


def embed_vjp(p: dict, x: torch.Tensor, v0: torch.Tensor) -> dict:
    """No embedding parameters."""
    return {}


def spmm_widths(cfg: dict) -> list:
    """Widths of the aggregations one LMC step needs: every layer's forward,
    and the backward over Aᵀ of every layer whose input has an adjoint
    (not layer 0: the features have none)."""
    dims, L = widths(cfg), cfg["num_layers"]
    return [dims[l] for l in range(L)] + [dims[l] for l in range(1, L)]


def step_flops(cfg: dict, rows: int, batch_rows: int, edges: int) -> float:
    """Model FLOPs of one LMC step over ``rows`` real batch + halo rows and
    ``edges`` real edges: per layer the aggregation, the self loop and the
    GEMM forward, the GEMM's weight gradient, and (layers past the first)
    its input gradient with the aggregation over Aᵀ; the head forward over
    every row (the halo's logits feed V̂), its weight gradient over the
    batch rows and its input gradient over every row. Elementwise work,
    padding and recomputation are not counted."""
    dims, L, c = widths(cfg), cfg["num_layers"], cfg["num_classes"]
    f = 0.0
    for l in range(L):
        di, do = dims[l], dims[l + 1]
        f += 2.0 * edges * di + 2.0 * rows * di + 2.0 * rows * di * do
        f += 2.0 * rows * di * do
        if l >= 1:
            f += 2.0 * rows * di * do + 2.0 * edges * di + 2.0 * rows * di
    d = dims[-1]
    f += 2.0 * rows * d * c + 2.0 * batch_rows * d * c + 2.0 * rows * d * c
    return f
