"""GNNs in the paper's aggregate/update message-passing form (Eq. 2).

The same three functions as the reference drive everything, with the
parameters passed explicitly so that the LMC machinery (core/) can take
per-layer values and adjoints:

  embed_apply(params["embed"], x)              -> H^0            (no aggregation)
  layer_apply(layer_params(params, l), l, h, aux) -> h_out        (one MP layer)
  head_apply(params["head"], h)                -> logits         (output layer)

:class:`GNN` is an ``nn.Module`` that owns the parameters in the reference's
layout, ``{"embed": {...}, "layers": {name: [per-layer]}, "head": {...}}``
(``params()`` returns that nested view), with weights applied as ``h @ w``
as in the reference, so converting reference parameters is leaf for leaf.

Aggregation is a weighted segment sum (``segment_spmm``, an ``index_add_``)
unless ``aux.ell`` carries the batch's ``ELLGraph``; then layers aggregate
through ``kernels.bucketed_spmm``, the CUDA ELL SpMM.

Supported: GCN (Kipf & Welling 2017), GCNII (Chen et al. 2020), GraphSAGE
(Hamilton et al. 2017), GIN (Xu et al. 2019).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.kernels.ops import bucketed_spmm


class EdgeList(NamedTuple):
    src: torch.Tensor   # (E,) int32 local source rows
    dst: torch.Tensor   # (E,) int32 local destination rows
    w: torch.Tensor     # (E,) float32 normalized weights (0 = padding)


class LayerAux(NamedTuple):
    edges: EdgeList
    x: torch.Tensor          # (N, dx) raw features of the local rows
    h0: torch.Tensor         # (N, d) initial embedding (GCNII)
    self_w: torch.Tensor     # (N,) self-loop weight 1/(deg+1)
    ell: Optional[Any] = None  # kernels.ELLGraph: aggregate via bucketed_spmm
    stream: Optional[bool] = None  # kernel variant knob (None: streaming)


def segment_spmm(edges: EdgeList, h: torch.Tensor,
                 num_rows: int) -> torch.Tensor:
    """out[i] = Σ_{(j->i)} w_ji * h[j] — the reference aggregation."""
    msgs = h.index_select(0, edges.src) * edges.w[:, None]
    return msgs.new_zeros((num_rows, h.shape[1])).index_add_(
        0, edges.dst, msgs)


AggregateFn = Callable[[EdgeList, torch.Tensor, int], torch.Tensor]


def _glorot(shape: tuple, generator: Optional[torch.Generator]) -> nn.Parameter:
    lim = math.sqrt(6.0 / (shape[-2] + shape[-1]))
    w = torch.empty(shape).uniform_(-lim, lim, generator=generator)
    return nn.Parameter(w)


def _zeros(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


class GNN(nn.Module):
    """A GNN family bound to its hyperparameters, owning its parameters.

    Parameters are created on the CPU with glorot-uniform weights drawn from
    ``generator`` (zero biases); move the module with ``.to(device)``.
    """

    def __init__(self, arch: str, feature_dim: int, hidden_dim: int,
                 num_classes: int, num_layers: int, alpha: float = 0.1,
                 lam: float = 0.5, aggregate: Optional[AggregateFn] = None,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.arch = arch
        self.feature_dim, self.hidden_dim = feature_dim, hidden_dim
        self.num_classes, self.num_layers = num_classes, num_layers
        self.alpha = alpha   # GCNII initial-residual strength
        self.lam = lam       # GCNII identity-map strength
        self.aggregate = aggregate if aggregate is not None else segment_spmm

        dx, d, c, L = feature_dim, hidden_dim, num_classes, num_layers
        g = generator
        dims = [dx] + [d] * L
        embed: dict = {}
        if arch == "gcn":
            layers = {"w": [_glorot((dims[l], dims[l + 1]), g) for l in range(L)],
                      "b": [_zeros(dims[l + 1]) for l in range(L)]}
        elif arch == "gcnii":
            layers = {"w": [_glorot((d, d), g) for _ in range(L)]}
            embed = {"w": _glorot((dx, d), g), "b": _zeros(d)}
        elif arch == "sage":
            layers = {"w_self": [_glorot((dims[l], dims[l + 1]), g)
                                 for l in range(L)],
                      "w_nbr": [_glorot((dims[l], dims[l + 1]), g)
                                for l in range(L)],
                      "b": [_zeros(dims[l + 1]) for l in range(L)]}
        elif arch == "gin":
            layers = {"w1": [_glorot((dims[l], dims[l + 1]), g)
                             for l in range(L)],
                      "b1": [_zeros(dims[l + 1]) for l in range(L)],
                      "w2": [_glorot((dims[l + 1], dims[l + 1]), g)
                             for l in range(L)],
                      "b2": [_zeros(dims[l + 1]) for l in range(L)],
                      "eps": [_zeros() for _ in range(L)]}
        else:
            raise ValueError(arch)
        self.embed = nn.ParameterDict(embed)
        self.layers = nn.ModuleDict(
            {k: nn.ParameterList(v) for k, v in layers.items()})
        self.head = nn.ParameterDict({"w": _glorot((d, c), g), "b": _zeros(c)})

    # ------------------------------------------------------------------ params
    def params(self) -> dict:
        """The parameters in the reference layout (the module's own tensors)."""
        return {"embed": dict(self.embed.items()),
                "layers": {k: list(v) for k, v in self.layers.items()},
                "head": dict(self.head.items())}

    def layer_params(self, params: dict, l: int) -> dict:
        return {k: v[l] for k, v in params["layers"].items()}

    # ------------------------------------------------------------------- fns
    def embed_apply(self, embed: dict, x: torch.Tensor) -> torch.Tensor:
        if self.arch == "gcnii":
            return torch.relu(x @ embed["w"] + embed["b"])
        return x  # H^0 = X for gcn/sage/gin

    def _aggregate(self, aux: LayerAux, h: torch.Tensor, n: int) -> torch.Tensor:
        """CUDA ELL kernel when the batch carries an ELLGraph, else the bound
        AggregateFn."""
        if aux.ell is not None:
            return bucketed_spmm(aux.ell, h, stream=aux.stream)
        return self.aggregate(aux.edges, h, n)

    def layer_apply(self, lp: dict, l: int, h_in: torch.Tensor,
                    aux: LayerAux) -> torch.Tensor:
        """One message-passing layer over the local row set (batch + halo)."""
        n = h_in.shape[0]
        if self.arch == "gcn":
            agg = self._aggregate(aux, h_in, n) + aux.self_w[:, None] * h_in
            return torch.relu(agg @ lp["w"] + lp["b"])
        if self.arch == "gcnii":
            agg = self._aggregate(aux, h_in, n) + aux.self_w[:, None] * h_in
            beta_l = math.log(self.lam / (l + 1) + 1.0)
            sup = (1 - self.alpha) * agg + self.alpha * aux.h0
            out = (1 - beta_l) * sup + beta_l * (sup @ lp["w"])
            return torch.relu(out)
        if self.arch == "sage":
            e = aux.edges
            deg = e.w.new_zeros(n).index_add_(0, e.dst, e.w)
            agg = self._aggregate(aux, h_in, n) / deg.clamp_min(1e-9)[:, None]
            return torch.relu(h_in @ lp["w_self"] + agg @ lp["w_nbr"] + lp["b"])
        if self.arch == "gin":
            agg = self._aggregate(aux, h_in, n) + (1.0 + lp["eps"]) * h_in
            hid = torch.relu(agg @ lp["w1"] + lp["b1"])
            return torch.relu(hid @ lp["w2"] + lp["b2"])
        raise ValueError(self.arch)

    def head_apply(self, head: dict, h: torch.Tensor) -> torch.Tensor:
        return h @ head["w"] + head["b"]

    # ----------------------------------------------------- full-graph forward
    def full_forward(self, params: dict, x: torch.Tensor, edges: EdgeList,
                     self_w: torch.Tensor) -> torch.Tensor:
        """Exact full-batch forward -> logits (evaluation / full-batch GD)."""
        h0 = self.embed_apply(params["embed"], x)
        aux = LayerAux(edges=edges, x=x, h0=h0, self_w=self_w)
        h = h0
        for l in range(self.num_layers):
            h = self.layer_apply(self.layer_params(params, l), l, h, aux)
        return self.head_apply(params["head"], h)

    def forward(self, x: torch.Tensor, edges: EdgeList,
                self_w: torch.Tensor) -> torch.Tensor:
        """``full_forward`` with the module's own parameters."""
        return self.full_forward(self.params(), x, edges, self_w)


def make_gnn(arch: str, feature_dim: int, hidden_dim: int, num_classes: int,
             num_layers: int, aggregate: Optional[AggregateFn] = None,
             **kw: Any) -> GNN:
    return GNN(arch, feature_dim, hidden_dim, num_classes, num_layers,
               aggregate=aggregate, **kw)
