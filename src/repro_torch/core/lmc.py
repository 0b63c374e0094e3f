"""Local Message Compensation — the paper's Algorithm 1, in PyTorch.

``make_train_step`` is one LMC/GAS/Cluster-GCN training step (the method
space of core/methods.py). Its backward pass is *explicit* message passing
(Eqs. 11-13) over one autograd graph per layer, recorded during the forward
pass (the layer's parameters, input and H^0 as leaves) and walked twice,
each walk asking only for what its cotangent feeds:

  * ``[V̄_batch ; 0]``      -> the θ-gradients (Eq. 7 sums in-batch rows only)
  * ``[V̄_batch ; V̂_halo]`` -> the input adjoints, the recursion (Eqs. 11 & 13)

so autograd prunes the other half of each walk (the input-side products
of the first, the weight-side products of the second). GAS and Cluster-GCN
(``bwd_mode="none"``, V̂ = 0) walk once for both; layer 0's input adjoint
is taken only when the embedding has parameters, its one reader.

``make_infer_step`` is the forward-only serving entry point over the
historical store: batch rows aggregate their complete neighbourhood, halo
rows are compensated (Eq. 9) from the store or, store-free, by the
message-invariance transform.

Neither step writes the store. Each returns the batch rows to refresh, and
the caller commits them with :func:`commit_rows` once it accepts the step (a
discarded step leaves no trace). The deferral is exact: layer l's
compensation reads ``store.h[l]`` (and the backward ``store.v[l-1]``) before
that layer's own refresh, and nothing later reads the refreshed layer.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.history import (HistoricalState, gather_rows,
                                      scatter_rows, stacked)
from repro_torch.core.methods import MBMethod
from repro_torch.device import resolve_device
from repro_torch.graph.structure import PaddedSubgraph
from repro_torch.kernels import ELLGraph, ELLPlan, lmc_compensate, plan_ell
from repro_torch.models.gnn import GNN, EdgeList, LayerAux
from repro_torch.optim.optimizers import tree_map

AGG_BACKENDS = ("segment", "ell", "ti")


class Batch(NamedTuple):
    """A PaddedSubgraph as tensors (CPU from ``host_batch``; ``.to(device)``).

    ``ell`` (optional) carries the batch-local adjacency in the degree-
    bucketed ELL layout of the CUDA SpMM, with fixed per-bucket capacities
    so every batch of a sampler or serving bucket has one shape; required by
    ``backend="ell"``. ``host_batch`` leaves it an :class:`ELLPlan` (the
    buckets' row counts, no arrays); ``to`` builds it into an
    :class:`ELLGraph` on the device the batch goes to, from the COO.
    ``ti_scale`` (optional) carries the per-halo-row message-invariance
    scales α; required by ``compensation="ti"``.
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
    ell: Optional[ELLGraph | ELLPlan] = None
    ti_scale: Optional[torch.Tensor] = None

    def to(self, device, non_blocking: bool = False) -> "Batch":
        """This batch with every tensor on ``device`` and its ELL plan
        built there (:meth:`copy_to`, then :meth:`bucketed`)."""
        return self.copy_to(device, non_blocking).bucketed()

    def copy_to(self, device, non_blocking: bool = False) -> "Batch":
        """This batch with every tensor (and a built ELL graph) on
        ``device``; an ELL plan rides along unbuilt. ``non_blocking``
        makes the copies asynchronous from pinned memory."""
        return Batch(*(f if f is None or isinstance(f, ELLPlan)
                       else f.to(device, non_blocking=non_blocking)
                       for f in self))

    def bucketed(self) -> "Batch":
        """This batch with its ELL plan built into the ELLGraph on the
        device its COO lies on (``ELLPlan.build``: the CUDA kernels on a
        card, with no host synchronisation; the numpy builder on the CPU);
        the batch itself where there is no plan."""
        if not isinstance(self.ell, ELLPlan):
            return self
        return self._replace(ell=self.ell.build(self.edge_src, self.edge_dst,
                                                self.edge_w))

    def pin_memory(self) -> "Batch":
        """This (CPU) batch copied into page-locked host memory."""
        return Batch(*(f if f is None or isinstance(f, ELLPlan)
                       else f.pin_memory() for f in self))

    def tensors(self) -> list:
        """Every tensor of the batch, a built ELL graph's included."""
        return [t for f in self
                if f is not None and not isinstance(f, ELLPlan)
                for t in (f.tensors() if isinstance(f, ELLGraph) else [f])]


def host_batch(sg: PaddedSubgraph, *, backend: str = "segment",
               ell_buckets=(8, 32, 128), with_transpose: bool = True) -> Batch:
    """A Batch of CPU tensors, with the plan of the bucketed ELL adjacency
    for ``backend="ell"|"ti"`` and the α scales for ``backend="ti"``.

    The plan (``kernels.plan_ell``: each bucket's real rows and fixed
    capacity, from the COO's row counts) raises ``ELLCapacityError`` here,
    on the host; ``Batch.to`` builds the buckets on the device.
    ``with_transpose`` also plans Aᵀ, which the training step's backward
    SpMM runs over; the forward-only serving path passes False.
    """
    assert backend in AGG_BACKENDS, backend
    ell = None
    ti_scale = None
    if backend in ("ell", "ti"):
        ell = plan_ell(sg.edge_src, sg.edge_dst, sg.n_ext,
                       buckets=ell_buckets, with_transpose=with_transpose)
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
                    ell_buckets=(8, 32, 128), with_transpose: bool = True,
                    device=None) -> Batch:
    """Host subgraph -> Batch on ``device`` (None: the card), its ELL
    buckets built there."""
    return host_batch(sg, backend=backend, ell_buckets=ell_buckets,
                      with_transpose=with_transpose).to(
                          resolve_device(device))


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


def _grads(out: torch.Tensor, leaves: list, cotangent: torch.Tensor,
           retain_graph: bool = False) -> list:
    """The VJP of ``out``'s graph with ``cotangent``, for ``leaves`` alone:
    autograd walks only the nodes that reach one of them, and a product's
    backward computes only the operands' halves asked for. A leaf ``out``
    does not read gets zeros, as ``torch.func.vjp`` gives."""
    gs = torch.autograd.grad(out, leaves, cotangent,
                             retain_graph=retain_graph, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(gs, leaves)]


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
        batch = batch.bucketed()   # a host batch's plan: built here
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
        aux = gnn.prepare(LayerAux(
            edges=edges, x=x_ext, h0=h0_ext, self_w=self_w_ext,
            ell=batch.ell if backend == "ell" else None, stream=stream))
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
        return logits, (stacked(rows, "make_infer_step")
                        if refresh else None)

    return infer


def make_train_step(gnn: GNN, method: MBMethod, num_nodes: int, *,
                    backend: str = "segment",
                    stream: Optional[bool] = None) -> Callable:
    """Build ``step(params, store, batch, x_full, self_w_full)``.

    Returns ``(loss, grads, rows, metrics)``. ``grads`` has the layout of
    ``params`` (``GNN.params()``). ``rows`` is a :class:`HistoricalState` of
    batch rows, tuples of ``h`` (NB, d_l) per layer and ``v`` (NB, d_l) per
    layer but the last (None for L = 1), for the caller to write with
    :func:`commit_rows` once it accepts the step; None when
    ``method.store_writes`` is False.

    ``backend`` selects the aggregation hot path: ``"segment"`` is the plain
    PyTorch gather + ``index_add_``; ``"ell"`` aggregates through the CUDA
    bucketed ELL SpMM (the forward and, through its autograd Function, the
    per-layer vjp cotangents over Aᵀ) and compensates halo rows with the
    fused ``lmc_compensate`` kernel; the batch must carry the bucketed
    adjacency and its transpose (``to_device_batch(sg, backend="ell")``).
    ``backend="ti"`` aggregates on the same SpMM but compensates with the
    message-invariance estimator and never reads ``store`` (it may be None).
    ``stream=False`` runs the resident-source kernels (small graphs only).
    """
    method.validate()
    assert backend in AGG_BACKENDS, backend
    L = gnn.num_layers
    layer0_input_is_h0 = gnn.arch == "gcnii"

    def step(params: dict, store: Optional[HistoricalState], batch: Batch,
             x_full: torch.Tensor, self_w_full: torch.Tensor):
        batch = batch.bucketed()   # a host batch's plan: built here
        nb = batch.batch_gids.shape[0]
        if backend in ("ell", "ti") and batch.ell is None:
            raise ValueError(
                f'backend="{backend}" needs batch.ell; build the batch with '
                f'to_device_batch(sg, backend="{backend}")')
        if backend == "ti" and batch.ti_scale is None:
            raise ValueError(
                'backend="ti" needs batch.ti_scale; build the batch with '
                'to_device_batch(sg, backend="ti")')
        params = tree_map(torch.Tensor.detach, params)
        ext_gids = torch.cat([batch.batch_gids, batch.halo_gids])
        x_ext = gather_rows(x_full, ext_gids)
        self_w_ext = gather_rows(self_w_full, ext_gids)
        edges = EdgeList(batch.edge_src, batch.edge_dst, batch.edge_w)
        vjp_emb = None
        # lint: ok(R004) `params` is a dict: this tests whether the embed subtree is empty (a structure test on the host), never a tensor
        if params["embed"]:
            h0_ext, vjp_emb = torch.func.vjp(
                lambda e: gnn.embed_apply(e, x_ext), params["embed"])
        else:
            h0_ext = gnn.embed_apply(params["embed"], x_ext)
        aux = gnn.prepare(LayerAux(
            edges=edges, x=x_ext, h0=h0_ext, self_w=self_w_ext,
            ell=batch.ell if backend in ("ell", "ti") else None,
            stream=stream))
        bmask = batch.batch_mask[:, None]
        hmask = batch.halo_mask[:, None]

        # ---------------- forward (Eqs. 8-10), one autograd graph per layer --
        # leaves: each layer's parameters and input, and one shared H^0;
        # nothing outside a layer is recorded. enable_grad: the step records
        # its graphs under an outer no_grad too.
        h0_leaf = h0_ext.detach().requires_grad_()
        aux = aux._replace(h0=h0_leaf)
        h_in = h0_ext
        graphs, h_rows = [], []
        for l in range(L):
            lp = {k: v.detach().requires_grad_()
                  for k, v in gnn.layer_params(params, l).items()}
            hin_leaf = h_in.detach().requires_grad_()
            with torch.enable_grad():
                h_out = gnn.layer_apply(lp, l, hin_leaf, aux)
            graphs.append((h_out, lp, hin_leaf))
            h_out = h_out.detach()
            h_bar_batch = h_out[:nb] * bmask
            h_hat_halo = _compensate(method.fwd_mode, backend,
                                     None if backend == "ti" else store.h[l],
                                     batch.halo_gids, batch.beta, h_out[nb:],
                                     batch.halo_mask, stream, batch.ti_scale)
            h_rows.append(h_bar_batch)
            h_in = torch.cat([h_bar_batch, h_hat_halo])

        # ---------------- loss & top-layer adjoints (Eq. 6/14 + V^L init) ----
        inv_vl = batch.loss_scale / batch.grad_scale   # = 1/|V_L|
        labels = batch.labels.long()[:, None]
        mask_b = batch.labeled_mask.clone()
        mask_b[nb:] = 0.0
        mask_h = batch.labeled_mask.clone()
        mask_h[:nb] = 0.0

        def unit_loss(head, h_rows_, m):
            logits = gnn.head_apply(head, h_rows_)
            ll = F.log_softmax(logits, dim=-1).gather(1, labels)[:, 0]
            return -(ll * m).sum() * inv_vl, logits

        f1, vjp1, logits_ext = torch.func.vjp(
            lambda hd, h: unit_loss(hd, h, mask_b), params["head"], h_in,
            has_aux=True)
        one = torch.ones_like(f1)
        g_head_unit, V1 = vjp1(one)
        V_bar = V1[:nb] * bmask
        if method.bwd_mode == "none":
            V_hat = torch.zeros_like(V1[nb:])
        else:
            _, vjp2, _ = torch.func.vjp(
                lambda h: unit_loss(params["head"], h, mask_h), h_in,
                has_aux=True)
            (V2,) = vjp2(one)
            V_hat = V2[nb:] * hmask

        # ---------------- backward message passing (Eqs. 11-13, 7/15) --------
        # Each walk of a layer's graph asks only for what its cotangent
        # feeds: [V̄; 0] the θ-gradient, [V̄; V̂] the input adjoints. v0_acc
        # (H^0's adjoint) feeds the embedding's VJP alone, so without one
        # neither H^0's adjoints nor layer 0's input adjoint are taken.
        feeds_h0 = vjp_emb is not None
        grads_layers = [None] * L
        v_rows = [None] * (L - 1)
        v0_acc = torch.zeros_like(h0_ext)
        for l in reversed(range(L)):
            h_out, lp, hin_leaf = graphs[l]
            graphs[l] = None   # the graph is freed by its last walk
            theta = list(lp.values())
            takes_input = l >= 1 or (feeds_h0 and layer0_input_is_h0)
            inputs = ([hin_leaf] if takes_input else []) \
                + ([h0_leaf] if feeds_h0 else [])
            ct_theta = torch.cat([V_bar, torch.zeros_like(V_hat)])
            if method.bwd_mode == "none":   # V̂ = 0: one walk for both
                g = _grads(h_out, theta + inputs, ct_theta)
                g_theta, g_in = g[:len(theta)], g[len(theta):]
            else:
                g_theta = _grads(h_out, theta, ct_theta,
                                 retain_graph=bool(inputs))
                g_in = (_grads(h_out, inputs, torch.cat([V_bar, V_hat]))
                        if inputs else [])
            grads_layers[l] = dict(zip(lp, g_theta))
            if feeds_h0:
                v0_acc = v0_acc + g_in[-1]
            if l >= 1:
                hgrad = g_in[0]
                V_bar_next = hgrad[:nb] * bmask
                V_hat = _compensate(method.bwd_mode, backend,
                                    None if backend == "ti" else store.v[l - 1],
                                    batch.halo_gids, batch.beta, hgrad[nb:],
                                    batch.halo_mask, stream, batch.ti_scale)
                v_rows[l - 1] = V_bar_next
                V_bar = V_bar_next
            elif takes_input:
                v0_acc = v0_acc + g_in[0]

        # ---------------- parameter gradients (Eq. 7 with A.3.1 scaling) -----
        scale = batch.grad_scale
        grads = {
            "layers": {k: [scale * grads_layers[l][k] for l in range(L)]
                       for k in params["layers"]},
            "head": {k: scale * g for k, g in g_head_unit.items()},
            "embed": {},
        }
        if vjp_emb is not None:
            (g_emb,) = vjp_emb(v0_acc * torch.cat(
                [bmask, torch.zeros_like(hmask)]))
            grads["embed"] = {k: scale * g for k, g in g_emb.items()}

        # ---------------- metrics -------------------------------------------
        loss = f1 * scale
        pred = logits_ext[:nb].argmax(-1)
        lab_b = mask_b[:nb]
        acc = ((pred == labels[:nb, 0]) * lab_b).sum() / lab_b.sum().clamp_min(
            1.0)
        rows = None
        if method.store_writes:
            rows = HistoricalState(h=tuple(h_rows),
                                   v=tuple(v_rows) if L > 1 else None)
        return loss, grads, rows, {"loss": loss, "train_acc": acc}

    return step


def commit_rows(store: HistoricalState, batch: Batch, rows,
                num_nodes: int) -> HistoricalState:
    """Write a step's refreshed batch rows into the store in place.

    ``rows`` is an infer step's (L, NB, d) tensor of ``h`` rows, or a train
    step's :class:`HistoricalState` of ``h`` and ``v`` rows, per layer.
    ``rows.h[l]`` goes to ``store.h[l][batch_gids]`` (and ``rows.v[l]`` to
    ``store.v[l]``); padded rows are dropped (``scatter_rows``). Returns
    ``store``.
    """
    h_rows, v_rows = ((rows.h, rows.v) if isinstance(rows, HistoricalState)
                      else (rows, None))
    for buf, new in ((store.h, h_rows), (store.v, v_rows)):
        if new is None:
            continue
        for l in range(len(new)):
            scatter_rows(buf[l], batch.batch_gids, batch.batch_mask, new[l],
                         num_nodes)
    return store
