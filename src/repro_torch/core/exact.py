"""Exact full-graph computation: ground-truth gradients and per-layer adjoints.

Provides the full-batch loss, gradients and accuracy, the exact per-node
embeddings H^l and auxiliary variables V^l = ∇_{H^l} L (the vs come through
``torch.autograd``), which also warm the serving store, and the backward-SGD
estimate of Section 4.2 built from them (the ground truth of Fig. 3).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.gnn import GNN, EdgeList, LayerAux
from repro_torch.optim.optimizers import tree_map


class FullGraphData(NamedTuple):
    x: torch.Tensor            # (n, dx)
    edges: EdgeList            # full symmetric edge list
    self_w: torch.Tensor       # (n,)
    labels: torch.Tensor       # (n,)
    labeled_mask: torch.Tensor  # (n,) f32 — train mask

    def to(self, device) -> "FullGraphData":
        """This data with every tensor on ``device``."""
        e = self.edges
        return FullGraphData(
            self.x.to(device), EdgeList(*(t.to(device) for t in e)),
            self.self_w.to(device), self.labels.to(device),
            self.labeled_mask.to(device))


def from_graph(graph, device=None) -> FullGraphData:
    """Full-graph data from a host Graph, on ``device`` (None: the card)."""
    dev = resolve_device(device)
    indptr, indices = graph.indptr, graph.indices
    row = np.repeat(np.arange(graph.num_nodes), np.diff(indptr)).astype(np.int64)
    w = graph.gcn_edge_weights(indices.astype(np.int64), row)
    deg = graph.degrees()

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return FullGraphData(
        x=t(graph.x),
        edges=EdgeList(src=t(indices.astype(np.int32)),
                       dst=t(row.astype(np.int32)), w=t(w)),
        self_w=t((1.0 / (deg + 1.0)).astype(np.float32)),
        labels=t(graph.y.astype(np.int32)),
        labeled_mask=t(graph.train_mask.astype(np.float32)))


def _masked_nll(logits: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    ll = F.log_softmax(logits, dim=-1).gather(1, labels.long()[:, None])[:, 0]
    return -(ll * mask).sum() / mask.sum().clamp_min(1.0)


def full_loss(gnn: GNN, params: dict, data: FullGraphData) -> torch.Tensor:
    """L = (1/|V_L|) Σ_{labeled} ℓ(h_j, y_j) — Section 3.2's objective."""
    logits = gnn.full_forward(params, data.x, data.edges, data.self_w)
    return _masked_nll(logits, data.labels, data.labeled_mask)


def full_grads(gnn: GNN, params: dict, data: FullGraphData):
    """(loss, exact ∇L) by autodiff — the ground truth of Fig. 3."""
    grads, loss = torch.func.grad_and_value(
        lambda p: full_loss(gnn, p, data))(tree_map(torch.Tensor.detach,
                                                    params))
    return loss, grads


def accuracy(gnn: GNN, params: dict, data: FullGraphData,
             mask: torch.Tensor) -> torch.Tensor:
    logits = gnn.full_forward(params, data.x, data.edges, data.self_w)
    pred = logits.argmax(-1)
    return ((pred == data.labels.long()) * mask).sum() / mask.sum().clamp_min(1.0)


def exact_layer_values(gnn: GNN, params: dict, data: FullGraphData):
    """Exact H^l (l=1..L) and V^l (l=1..L-1) for the whole graph.

    The forward runs without autograd; each V^{l-1} is the vjp of layer l
    at its exact input, applied to V^l (one recomputed layer at a time).
    """
    L = gnn.num_layers
    with torch.no_grad():
        h0 = gnn.embed_apply(params["embed"], data.x)
        aux = LayerAux(edges=data.edges, x=data.x, h0=h0, self_w=data.self_w)
        hs = []
        h = h0
        for l in range(L):
            h = gnn.layer_apply(gnn.layer_params(params, l), l, h, aux)
            hs.append(h)

    with torch.enable_grad():
        h_top = hs[-1].detach().requires_grad_()
        loss = _masked_nll(gnn.head_apply(params["head"], h_top),
                           data.labels, data.labeled_mask)
        (V,) = torch.autograd.grad(loss, h_top)
        vs = [None] * L
        vs[L - 1] = V
        for l in reversed(range(1, L)):
            h_in = hs[l - 1].detach().requires_grad_()
            out = gnn.layer_apply(gnn.layer_params(params, l), l, h_in, aux)
            (V,) = torch.autograd.grad(out, h_in, grad_outputs=V)
            vs[l - 1] = V
    return hs, vs


def backward_sgd_grads(gnn: GNN, params: dict, data: FullGraphData,
                       hs, vs, batch_nodes: torch.Tensor, scale: float):
    """Eq. (7)/(15): θ-gradient estimate from exact values on a mini-batch.

    ``scale`` is b/c (App. A.3.1); with exact hs/vs these estimates are
    *unbiased* over uniform batch sampling (Thm 1). Returns the layer
    gradients in the layout of ``params["layers"]``.
    """
    L = gnn.num_layers
    params = tree_map(torch.Tensor.detach, params)
    h0 = gnn.embed_apply(params["embed"], data.x)
    aux = LayerAux(edges=data.edges, x=data.x, h0=h0, self_w=data.self_w)
    sel = torch.zeros(data.x.shape[0], device=data.x.device)
    sel[batch_nodes.long()] = 1.0
    grads = []
    for l in range(L):
        hin = h0 if l == 0 else hs[l - 1]
        _, vjp_fn = torch.func.vjp(
            lambda lp_, _l=l, _hin=hin: gnn.layer_apply(lp_, _l, _hin, aux),
            gnn.layer_params(params, l))
        (g_lp,) = vjp_fn(vs[l] * sel[:, None])
        grads.append({k: scale * g for k, g in g_lp.items()})
    return {k: [g[k] for g in grads] for k in params["layers"]}
