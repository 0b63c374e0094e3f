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
(Hamilton et al. 2017), GIN (Xu et al. 2019), and GAT (Veličković et al.
2018, the inductive PPI model with PyTorch Geometric's linear skips), whose
aggregation weights are a softmax of learned scores: ``gat_aggregate`` in
plain PyTorch over the edge list, or ``kernels.gat_attention`` over the
ELL buckets. GAT's layer widths differ (``store_widths``), it has no
embedding and its last layer's output is the logits (an identity head).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.gat_attention import (SLOPE, AttentionPlan,
                                               attention_plan, gat_attention)
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
    attn: Optional[AttentionPlan] = None  # GAT: the ELL's pieces by row


def segment_spmm(edges: EdgeList, h: torch.Tensor,
                 num_rows: int) -> torch.Tensor:
    """out[i] = Σ_{(j->i)} w_ji * h[j] — the reference aggregation."""
    msgs = h.index_select(0, edges.src) * edges.w[:, None]
    return msgs.new_zeros((num_rows, h.shape[1])).index_add_(
        0, edges.dst, msgs)


def gat_aggregate(edges: EdgeList, z: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """GAT's attention aggregation in plain PyTorch, differentiable by
    autograd: ``o_i = Σ_j α_ij z_j`` over the edges j→i of ``edges`` with
    ``w != 0`` (``w == 0`` marks padding) and one self loop a row, ``α``
    each head's softmax over the row of ``LeakyReLU(u_j + v_i)``. ``z``
    (n, H, F), ``u``/``v`` (n, H) -> (n, H, F)."""
    n = z.shape[0]
    loop = torch.arange(n, device=z.device)
    # lint: ok(R001) a batch's local edge list, a plain tensor: GAT runs on no mesh
    src = torch.cat([edges.src.long(), loop])
    # lint: ok(R001) as above
    dst = torch.cat([edges.dst.long(), loop])
    # lint: ok(R001) as above
    real = torch.cat([edges.w != 0, torch.ones_like(loop, dtype=torch.bool)])
    e = F.leaky_relu(u[src] + v[dst], SLOPE).masked_fill(~real[:, None],
                                                         float("-inf"))
    m = e.new_full(u.shape, float("-inf")).scatter_reduce(
        0, dst[:, None].expand_as(e), e.detach(), "amax")
    ex = torch.exp(e - m[dst])
    den = ex.new_zeros(u.shape).index_add_(0, dst, ex)
    alpha = ex / den[dst]
    return z.new_zeros(z.shape).index_add_(0, dst, alpha[..., None] * z[src])


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
                 *, heads: int = 4, out_heads: int = 6,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.arch = arch
        self.feature_dim, self.hidden_dim = feature_dim, hidden_dim
        self.num_classes, self.num_layers = num_classes, num_layers
        self.alpha = alpha   # GCNII initial-residual strength
        self.lam = lam       # GCNII identity-map strength
        self.heads, self.out_heads = heads, out_heads   # GAT
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
        elif arch == "gat":
            dims = [dx] + [d] * (L - 1) + [c]
            hf = [self._gat_shape(l)[:2] for l in range(L)]
            layers = {"w": [_glorot((dims[l], hf[l][0] * hf[l][1]), g)
                            for l in range(L)],
                      "att_src": [_glorot(hf[l], g) for l in range(L)],
                      "att_dst": [_glorot(hf[l], g) for l in range(L)],
                      "skip_w": [_glorot((dims[l], dims[l + 1]), g)
                                 for l in range(L)],
                      "b": [_zeros(dims[l + 1]) for l in range(L)],
                      "skip_b": [_zeros(dims[l + 1]) for l in range(L)]}
        else:
            raise ValueError(arch)
        self._widths = tuple(dims[1:])
        self.embed = nn.ParameterDict(embed)
        self.layers = nn.ModuleDict(
            {k: nn.ParameterList(v) for k, v in layers.items()})
        self.head = nn.ParameterDict(
            {} if arch == "gat" else {"w": _glorot((d, c), g), "b": _zeros(c)})

    def store_widths(self) -> tuple:
        """Each layer's output width: the width of its store H̄[l] (and of
        V̄[l], the next layer's input adjoint). One width repeated, but for
        GAT (hidden, ..., num_classes)."""
        return self._widths

    def _gat_shape(self, l: int) -> tuple:
        """GAT layer ``l``'s ``(heads, width, concat)``: ``heads`` heads of
        ``hidden_dim / heads`` concatenated, the last layer ``out_heads``
        heads of ``num_classes`` averaged."""
        if l == self.num_layers - 1:
            return self.out_heads, self.num_classes, False
        if self.hidden_dim % self.heads:
            raise ValueError(f"hidden_dim {self.hidden_dim} is not a "
                             f"multiple of heads {self.heads}")
        return self.heads, self.hidden_dim // self.heads, True

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

    def prepare(self, aux: LayerAux) -> LayerAux:
        """``aux`` with what every layer of the batch shares computed once:
        for GAT over an ELL graph, the attention plan (its pieces by row)."""
        if self.arch == "gat" and aux.ell is not None and aux.attn is None:
            return aux._replace(attn=attention_plan(aux.ell))
        return aux

    def _gat_layer(self, lp: dict, l: int, h_in: torch.Tensor,
                   aux: LayerAux) -> torch.Tensor:
        """GAT layer ``l``: ``z = h W`` as (n, H, F), the scores ``u``, ``v``,
        the attention aggregation (the kernel over ``aux.attn``, the plan
        that :meth:`prepare` made of ``aux.ell``, else
        :func:`gat_aggregate`), heads concatenated or averaged, ``+ b``, the
        skip ``h S + c``, ELU but on the last layer."""
        n = h_in.shape[0]
        H, Fw, concat = self._gat_shape(l)
        z = (h_in @ lp["w"]).view(n, H, Fw)
        u = (z * lp["att_src"]).sum(-1)
        v = (z * lp["att_dst"]).sum(-1)
        if aux.ell is not None:
            if aux.attn is None:
                raise ValueError("GAT over an ELL graph needs its attention "
                                 "plan: pass the LayerAux through "
                                 "GNN.prepare")
            y = gat_attention(z, u, v, aux.attn, concat=concat)
        else:
            o = gat_aggregate(aux.edges, z, u, v)
            y = o.reshape(n, H * Fw) if concat else o.mean(1)
        t = y + lp["b"] + h_in @ lp["skip_w"] + lp["skip_b"]
        return t if l == self.num_layers - 1 else F.elu(t)

    def layer_apply(self, lp: dict, l: int, h_in: torch.Tensor,
                    aux: LayerAux) -> torch.Tensor:
        """One message-passing layer over the local row set (batch + halo)."""
        n = h_in.shape[0]
        if self.arch == "gat":
            return self._gat_layer(lp, l, h_in, aux)
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
        if self.arch == "gat":
            return h   # the last layer's output is the logits
        return h @ head["w"] + head["b"]

    # ----------------------------------------------------- full-graph forward
    def full_forward(self, params: dict, x: torch.Tensor, edges: EdgeList,
                     self_w: torch.Tensor) -> torch.Tensor:
        """Exact full-batch forward -> logits (evaluation / full-batch GD)."""
        h0 = self.embed_apply(params["embed"], x)
        aux = self.prepare(LayerAux(edges=edges, x=x, h0=h0, self_w=self_w))
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
