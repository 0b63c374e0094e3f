"""Historical value stores (H̄^l and V̄^l of Section 5).

``h`` and ``v`` are per-layer sequences: ``h[l]`` is H̄ of layer l, ``(n,
d_l)`` with ``d_l`` the layer's output width, and ``v[l]`` is V̄ of layer
l + 1's input, as wide. Where every layer has one width (GCN, GCNII, SAGE,
GIN) the sequence is one ``(L, n, d)`` / ``(L-1, n, d)`` tensor, whose
``[l]`` is that layer's view; where the widths differ (GAT: 1024, 1024,
121) it is a tuple of ``(n, d_l)`` tensors. The per-layer code of the
training path takes either (``core/lmc.py``'s steps and ``commit_rows``,
``train/loop.py``, ``train/health.py``). The code that needs one tensor
checks :func:`one_width` or calls :func:`stacked` (which raises
``ValueError`` on layers of different widths) once at its entry:
``serve/server.py`` (``warm_store``, ``GNNServer``), ``core/distributed.py``
(its steps move a row's layers as one slab), ``train/elastic.py``
(``rescale_lmc_state``), ``convert.py`` (``state_from_reference``) and
``make_infer_step``'s refreshed rows. A serving store has
no ``v`` (only the training backward reads it). Unlike the reference,
which threads them functionally through its jitted steps, the port updates
them in place: a full-graph store is hundreds of MB and a copy per batch
would cost more than the batch.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch

from repro_torch.device import resolve_device

Layers = Union[torch.Tensor, Sequence[torch.Tensor]]


class HistoricalState(NamedTuple):
    h: Layers   # per layer (n, d_l): historical embeddings H̄^l, l = 1..L
    # per layer (n, d_l): historical aux vars V̄^l, l = 1..L-1; None when
    # serving
    v: Optional[Layers] = None

    @property
    def num_layers(self) -> int:
        return len(self.h)


def one_width(widths: Sequence[int], what: str = "the store") -> int:
    """The layers' one width; ValueError where they differ (GAT's)."""
    widths = [int(w) for w in widths]
    if len(set(widths)) != 1:
        raise ValueError(f"{what} takes layers of one width; these are "
                         f"{widths} wide")
    return widths[0]


def stacked(layers: Optional[Layers], what: str = "the store"):
    """``layers`` as one ``(L, n, d)`` tensor: a stacked store itself (the
    same memory), equal-width layers stacked (a copy); None stays None.
    Raises ValueError where the layers' widths differ, which one tensor
    cannot hold."""
    if layers is None or isinstance(layers, torch.Tensor):
        return layers
    one_width([t.shape[-1] for t in layers], what)
    return torch.stack(list(layers))


def init_history(num_layers: int, num_nodes: int,
                 widths: Union[int, Sequence[int]], dtype=torch.float32,
                 device=None) -> HistoricalState:
    """Zero stores on ``device`` (None: the CUDA card). ``widths``: one
    width for every layer, or each layer's output width
    (``GNN.store_widths()``); equal widths give stacked tensors."""
    ws = ([int(widths)] * num_layers if isinstance(widths, int)
          else [int(w) for w in widths])
    if len(ws) != num_layers:
        raise ValueError(f"init_history: {len(ws)} widths for {num_layers} "
                         f"layers")
    dev = resolve_device(device)
    nv = max(num_layers - 1, 1)
    if len(set(ws)) == 1:
        return HistoricalState(
            h=torch.zeros((num_layers, num_nodes, ws[0]), dtype=dtype,
                          device=dev),
            v=torch.zeros((nv, num_nodes, ws[0]), dtype=dtype, device=dev))
    return HistoricalState(
        h=tuple(torch.zeros((num_nodes, w), dtype=dtype, device=dev)
                for w in ws),
        v=tuple(torch.zeros((num_nodes, w), dtype=dtype, device=dev)
                for w in ws[:nv]))


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
