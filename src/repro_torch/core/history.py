"""Historical value stores (H̄^l and V̄^l of Section 5).

The stores are plain device tensors shaped ``(L, n, d)`` / ``(L-1, n, d)``;
a serving store has no ``v`` (only the training backward reads it).
Unlike the reference, which threads them functionally through its jitted
steps, the port updates them in place: a full-graph store is hundreds of MB
and a copy per batch would cost more than the batch.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.device import resolve_device


class HistoricalState(NamedTuple):
    h: torch.Tensor  # (L, n, d)   historical embeddings  H̄^l, l = 1..L
    # (L-1, n, d) historical aux vars V̄^l, l = 1..L-1; None when serving
    v: Optional[torch.Tensor] = None

    @property
    def num_layers(self) -> int:
        return int(self.h.shape[0])


def init_history(num_layers: int, num_nodes: int, hidden_dim: int,
                 dtype=torch.float32, device=None) -> HistoricalState:
    """Zero stores on ``device`` (None: the CUDA card)."""
    dev = resolve_device(device)
    return HistoricalState(
        h=torch.zeros((num_layers, num_nodes, hidden_dim), dtype=dtype,
                      device=dev),
        v=torch.zeros((max(num_layers - 1, 1), num_nodes, hidden_dim),
                      dtype=dtype, device=dev),
    )


def scatter_rows(buf: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor,
                 rows: torch.Tensor, n: int) -> torch.Tensor:
    """In place: buf[gids] <- rows where mask==1; returns ``buf``.

    Padded rows (mask 0) are dropped, and so is any gid outside ``[0, n)`` —
    the reference's scatter to index n with ``mode="drop"``.
    """
    keep = (mask > 0) & (gids >= 0) & (gids < n)
    return buf.index_copy_(0, gids[keep].long(), rows[keep].to(buf.dtype))


def gather_rows(buf: torch.Tensor, gids: torch.Tensor) -> torch.Tensor:
    """buf[gids] with gids clipped into ``[0, len(buf))`` (reference clip)."""
    return buf.index_select(0, gids.clamp(0, buf.shape[0] - 1))
