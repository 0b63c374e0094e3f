"""Gradient compression for cross-pod reduction: top-k sparsification with
error feedback (Stich et al. 2018) and symmetric int8 quantization, as the
reference's ``repro.optim.compression`` computes them.

Top-k keeps the reference's order among equal magnitudes: ``jax.lax.top_k``
returns the lower index first, and a stable descending sort does too
(``torch.topk`` promises no order among ties).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class TopKPayload(NamedTuple):
    values: torch.Tensor
    indices: torch.Tensor
    shape: tuple


def topk_compress(g: torch.Tensor, frac: float = 0.01,
                  error: Optional[torch.Tensor] = None):
    """Keep the top ``frac`` entries by magnitude (at least one); return
    (payload, new error: the entries not sent, in ``g``'s shape)."""
    flat = g.float().reshape(-1)
    if error is not None:
        flat = flat + error.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    picked = flat[idx]
    new_error = flat.clone()
    new_error[idx] = 0.0
    return (TopKPayload(values=picked, indices=idx, shape=tuple(g.shape)),
            new_error.reshape(g.shape))


def topk_decompress(payload: TopKPayload) -> torch.Tensor:
    n = 1
    for s in payload.shape:
        n *= s
    out = torch.zeros((n,), dtype=torch.float32,
                      device=payload.values.device)
    out[payload.indices] = payload.values
    return out.reshape(payload.shape)


def int8_compress(g: torch.Tensor):
    """Symmetric per-tensor int8 quantization; returns (q, scale)."""
    gf = g.float()
    scale = gf.abs().max() / 127.0
    q = torch.round(gf / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
