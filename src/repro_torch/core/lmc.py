"""Local Message Compensation — the forward (serving) half of Algorithm 1.

``make_infer_step`` is the forward-only entry point over the historical
store: batch rows aggregate their complete neighbourhood, halo rows are
compensated (Eq. 9) from the store or, store-free, by the message-invariance
transform. The training step (the explicit backward message passing of
Eqs. 11-13) comes with the training port.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.history import HistoricalState, gather_rows, scatter_rows
from repro_torch.device import resolve_device
from repro_torch.graph.structure import PaddedSubgraph
from repro_torch.kernels import ELLGraph, ell_from_coo, lmc_compensate
from repro_torch.models.gnn import GNN, EdgeList, LayerAux

AGG_BACKENDS = ("segment", "ell", "ti")


class Batch(NamedTuple):
    """A PaddedSubgraph as tensors (CPU from ``host_batch``; ``.to(device)``).

    ``ell`` (optional) carries the batch-local adjacency re-bucketed into the
    ELL layout of the CUDA SpMM, with fixed per-bucket capacities so every
    batch of a sampler or serving bucket has one shape; required by
    ``backend="ell"``. ``ti_scale`` (optional) carries the per-halo-row
    message-invariance scales α; required by ``compensation="ti"``.
    """
    batch_gids: torch.Tensor
    halo_gids: torch.Tensor
    batch_mask: torch.Tensor
    halo_mask: torch.Tensor
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    edge_w: torch.Tensor
    labels: torch.Tensor
    labeled_mask: torch.Tensor
    beta: torch.Tensor
    loss_scale: torch.Tensor
    grad_scale: torch.Tensor
    ell: Optional[ELLGraph] = None
    ti_scale: Optional[torch.Tensor] = None

    def to(self, device) -> "Batch":
        """This batch with every tensor (and the ELL graph) on ``device``."""
        return Batch(*(None if f is None else f.to(device) for f in self))


def host_batch(sg: PaddedSubgraph, *, backend: str = "segment",
               ell_buckets=(8, 32, 128)) -> Batch:
    """A Batch of CPU tensors, with the re-bucketed ELL adjacency for
    ``backend="ell"|"ti"`` and the α scales for ``backend="ti"``."""
    assert backend in AGG_BACKENDS, backend
    ell = None
    ti_scale = None
    if backend in ("ell", "ti"):
        ell = ell_from_coo(sg.edge_src, sg.edge_dst, sg.edge_w, sg.n_ext,
                           buckets=ell_buckets)
    if backend == "ti":
        if sg.ti_scale is None:
            raise ValueError(
                'backend="ti" needs PaddedSubgraph.ti_scale; rebuild the '
                "subgraph with graph.structure.build_subgraph")
        ti_scale = sg.ti_scale

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    return Batch(
        batch_gids=t(sg.batch_gids), halo_gids=t(sg.halo_gids),
        batch_mask=t(sg.batch_mask), halo_mask=t(sg.halo_mask),
        edge_src=t(sg.edge_src), edge_dst=t(sg.edge_dst),
        edge_w=t(sg.edge_w), labels=t(sg.labels),
        labeled_mask=t(sg.labeled_mask), beta=t(sg.beta),
        loss_scale=t(sg.loss_scale), grad_scale=t(sg.grad_scale),
        ell=ell, ti_scale=None if ti_scale is None else t(ti_scale))


def to_device_batch(sg: PaddedSubgraph, *, backend: str = "segment",
                    ell_buckets=(8, 32, 128), device=None) -> Batch:
    """Host subgraph -> Batch on ``device`` (None: the card)."""
    return host_batch(sg, backend=backend,
                      ell_buckets=ell_buckets).to(resolve_device(device))


def _combine(mode: str, beta: torch.Tensor, hist: torch.Tensor,
             fresh: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex combination of historical and incomplete-fresh values (Eq. 9/12)."""
    if mode == "lmc":
        out = (1.0 - beta) * hist + beta * fresh
    elif mode == "historical":
        out = hist
    elif mode == "fresh":
        out = fresh
    elif mode == "none":
        out = torch.zeros_like(fresh)
    else:
        raise ValueError(mode)
    return out * mask


def _effective_beta(mode: str, beta1d: torch.Tensor) -> torch.Tensor:
    """Every mode as one lerp: lmc -> β, historical -> 0, fresh -> 1."""
    if mode == "lmc":
        return beta1d
    if mode == "historical":
        return torch.zeros_like(beta1d)
    if mode == "fresh":
        return torch.ones_like(beta1d)
    raise ValueError(mode)


def _compensate(mode: str, backend: str, store_l: Optional[torch.Tensor],
                halo_gids: torch.Tensor, beta1d: torch.Tensor,
                fresh: torch.Tensor, mask1d: torch.Tensor,
                stream: Optional[bool] = None,
                ti_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Halo compensation ĥ/V̂ (Eq. 9/12).

    backend="segment": gather + lerp in plain PyTorch. backend="ell": one
    fused ``lmc_compensate`` kernel launch with the effective β. backend="ti":
    the message-invariance estimate ``((1-β_eff)·α + β_eff) ⊙ fresh`` — no
    store read at all.
    """
    if mode == "none":
        return torch.zeros_like(fresh)
    if backend == "ti":
        beta_eff = _effective_beta(mode, beta1d)
        coeff = (1.0 - beta_eff) * ti_scale + beta_eff
        return fresh * (coeff * mask1d)[:, None]
    if backend == "ell":
        return lmc_compensate(store_l, halo_gids,
                              _effective_beta(mode, beta1d), fresh, mask1d,
                              stream=stream)
    hist = gather_rows(store_l, halo_gids)
    return _combine(mode, beta1d[:, None], hist, fresh, mask1d[:, None])


def make_infer_step(gnn: GNN, num_nodes: int, *, backend: str = "segment",
                    fwd_mode: str = "historical", compensation: str = "store",
                    refresh: bool = True,
                    stream: Optional[bool] = None) -> Callable:
    """Build ``infer(params, store, batch, x_full, self_w_full)``.

    Returns ``(logits, rows)``: ``logits`` covers the batch's padded target
    rows (mask with ``batch.batch_mask``); ``rows`` is the (L, NB, d) stack
    of fresh batch-row values to write into ``store.h`` (None when
    ``refresh=False``). The step never writes the store: the caller commits
    ``rows`` with :func:`commit_rows` once it has accepted the output, so a
    batch that is discarded (e.g. non-finite output) leaves no trace. That
    deferral is exact: layer l's compensation reads ``store.h[l]`` before
    layer l's own refresh, and no later layer reads ``h[l]``.

    ``compensation="store"`` gathers halo rows from ``store.h``; with
    ``fwd_mode="historical"`` and a store of exact layer values the target
    logits equal the full-graph forward. ``compensation="ti"`` substitutes
    the store-free message-invariance transform α ⊙ fresh. ``backend``
    selects the aggregation ("segment" | "ell", the CUDA SpMM); under
    "ell" the store compensation runs on the CUDA compensation kernel.
    Runs without autograd.
    """
    assert backend in ("segment", "ell"), backend
    assert compensation in ("store", "ti"), compensation
    assert fwd_mode in ("lmc", "historical", "fresh"), fwd_mode
    L = gnn.num_layers

    @torch.no_grad()
    def infer(params: dict, store: HistoricalState, batch: Batch,
              x_full: torch.Tensor, self_w_full: torch.Tensor):
        nb = batch.batch_gids.shape[0]
        if backend == "ell" and batch.ell is None:
            raise ValueError(
                'backend="ell" needs batch.ell; build the batch with '
                'host_batch(sg, backend="ell")')
        if compensation == "ti" and batch.ti_scale is None:
            raise ValueError(
                'compensation="ti" needs batch.ti_scale; attach the '
                "subgraph's α scales (host_batch(sg, backend=\"ti\") or "
                "Batch._replace)")
        ext_gids = torch.cat([batch.batch_gids, batch.halo_gids])
        x_ext = gather_rows(x_full, ext_gids)
        self_w_ext = gather_rows(self_w_full, ext_gids)
        edges = EdgeList(batch.edge_src, batch.edge_dst, batch.edge_w)
        h0_ext = gnn.embed_apply(params["embed"], x_ext)
        aux = LayerAux(edges=edges, x=x_ext, h0=h0_ext, self_w=self_w_ext,
                       ell=batch.ell if backend == "ell" else None,
                       stream=stream)
        bmask = batch.batch_mask[:, None]
        comp_backend = "ti" if compensation == "ti" else backend

        h_in = h0_ext
        rows = []
        for l in range(L):
            h_out = gnn.layer_apply(gnn.layer_params(params, l), l, h_in, aux)
            h_bar_batch = h_out[:nb] * bmask
            h_hat_halo = _compensate(
                fwd_mode, comp_backend,
                None if compensation == "ti" else store.h[l],
                batch.halo_gids, batch.beta, h_out[nb:], batch.halo_mask,
                stream, batch.ti_scale)
            rows.append(h_bar_batch)
            h_in = torch.cat([h_bar_batch, h_hat_halo])

        logits = gnn.head_apply(params["head"], h_in[:nb])
        return logits, (torch.stack(rows) if refresh else None)

    return infer


def commit_rows(store: HistoricalState, batch: Batch, rows: torch.Tensor,
                num_nodes: int) -> HistoricalState:
    """Write an infer step's refreshed batch rows into ``store.h`` in place.

    ``rows[l]`` goes to ``store.h[l][batch_gids]``; padded rows are dropped
    (``scatter_rows``). Returns ``store``.
    """
    for l in range(rows.shape[0]):
        scatter_rows(store.h[l], batch.batch_gids, batch.batch_mask, rows[l],
                     num_nodes)
    return store
