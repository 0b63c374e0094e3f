"""Distributed LMC: one cluster per device, compensation across devices.

Per step every device trains on its own sampled cluster; halo values come
from the row-blocked historical stores. Mathematically this is Algorithm 1
with batch = union of the per-device clusters, where *cross-device* boundary
messages are compensated (historical + incomplete fresh) rather than
exchanged fresh — the paper's own "sample more subgraphs to build a large
graph" mode, with the same convergence analysis.

Two ways to run it, with one result up to f32 summation order:

  stack_batches               — the per-device subgraphs stacked host-side
                                into one flat batch (row blocks per device,
                                edge ids offset), which runs through the same
                                ``core.lmc.make_train_step`` on one device;
  make_distributed_train_step — one process per device over a
                                ``torch.distributed`` group, each with its
                                own batch and its row blocks of ``x``,
                                ``self_w`` and the stores (``dist.sharding``).
                                It fetches the rows its batch reads from
                                their owners once, runs ``make_train_step``
                                on them, all-reduces loss and gradients, and
                                routes the refreshed batch rows to the ranks
                                that own them.

One fetch per step is exact because of the deferred-write contract of
``core.lmc``: every store read in a step is of the pre-step store.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.history import HistoricalState
from repro_torch.core.lmc import AGG_BACKENDS, Batch, make_train_step
from repro_torch.core.methods import MBMethod
from repro_torch.dist.collectives import (all_gather_blocks, all_reduce_sum,
                                          fetch_rows, route_rows)
from repro_torch.dist.sharding import dp_axis_size, dp_rank, row_block
from repro_torch.graph.structure import PaddedSubgraph
from repro_torch.kernels import ell_from_coo
from repro_torch.models.gnn import GNN
from repro_torch.optim.optimizers import tree_map


def stack_batches(sgs: Sequence[PaddedSubgraph], *,
                  backend: str = "segment",
                  ell_buckets=(8, 32, 128)) -> Batch:
    """Fuse per-device subgraphs into one flat CPU Batch with remapped
    local ids (the reference's ``stack_batches``).

    Row layout: [dev0 batch rows | dev1 batch rows | ...] then
                [dev0 halo rows | dev1 halo rows | ...].

    ``loss_scale`` and ``grad_scale`` are divided by the device count, so
    the flat step's loss and gradients are the mean of the per-device ones.
    For ``backend="ell"|"ti"`` the flat edges are bucketed into the ELL
    layout (A and Aᵀ) as ``host_batch`` does; ``"ti"`` also stacks the
    subgraphs' α scales. All subgraphs must share one padding.
    """
    assert backend in AGG_BACKENDS, backend
    nd = len(sgs)
    nb, nh = sgs[0].n_batch, sgs[0].n_halo
    for sg in sgs:
        if sg.n_batch != nb or sg.n_halo != nh:
            raise ValueError("stack_batches needs uniform padding: "
                             f"({sg.n_batch}, {sg.n_halo}) != ({nb}, {nh})")

    def cat(attr):
        return np.concatenate([getattr(sg, attr) for sg in sgs])

    def blocks(attr):   # [every device's batch rows | every halo block]
        return np.concatenate([getattr(sg, attr)[:nb] for sg in sgs]
                              + [getattr(sg, attr)[nb:] for sg in sgs])

    edge_src, edge_dst = [], []
    for d, sg in enumerate(sgs):
        for ids, out in ((sg.edge_src, edge_src), (sg.edge_dst, edge_dst)):
            ids = ids.astype(np.int64)
            out.append(np.where(ids < nb, ids + d * nb,
                                nd * nb + d * nh + (ids - nb))
                       .astype(np.int32))
    edge_src, edge_dst = np.concatenate(edge_src), np.concatenate(edge_dst)
    edge_w = cat("edge_w")

    ell = ti_scale = None
    if backend in ("ell", "ti"):
        ell = ell_from_coo(edge_src, edge_dst, edge_w, nd * (nb + nh),
                           buckets=ell_buckets, with_transpose=True)
    if backend == "ti":
        if any(sg.ti_scale is None for sg in sgs):
            raise ValueError(
                'backend="ti" needs PaddedSubgraph.ti_scale; rebuild the '
                "subgraphs with graph.structure.build_subgraph")
        ti_scale = cat("ti_scale")

    def t(a):   # arrays are fresh concatenations; scalars stay 0-d
        return torch.from_numpy(np.asarray(a))

    return Batch(
        batch_gids=t(cat("batch_gids")), halo_gids=t(cat("halo_gids")),
        batch_mask=t(cat("batch_mask")), halo_mask=t(cat("halo_mask")),
        edge_src=t(edge_src), edge_dst=t(edge_dst), edge_w=t(edge_w),
        labels=t(blocks("labels")), labeled_mask=t(blocks("labeled_mask")),
        beta=t(cat("beta")),
        loss_scale=t(np.asarray(sgs[0].loss_scale / nd)),
        grad_scale=t(np.asarray(sgs[0].grad_scale / nd)),
        ell=ell, ti_scale=None if ti_scale is None else t(ti_scale))


class OwnedRows(NamedTuple):
    """Refreshed store rows that this rank owns: global ids and the rows of
    ``h`` (L, k, d) and ``v`` (L-1, k, d; None for L = 1)."""
    gids: torch.Tensor
    h: torch.Tensor
    v: Optional[torch.Tensor]


def make_distributed_train_step(gnn: GNN, method: MBMethod, num_nodes: int,
                                *, group=None, model_group=None,
                                backend: str = "segment",
                                stream: Optional[bool] = None,
                                splits: Optional[tuple] = None) -> Callable:
    """Build ``step(params, store, batch, x, self_w)`` for one rank.

    ``batch`` is this rank's own device batch (its subgraph, with global
    ids); ``store``, ``x`` and ``self_w`` are this rank's row blocks
    (``dist.sharding.row_block``) of the stores, the features and the
    self-loop weights (``store`` may be None on ``backend="ti"``). Every rank
    of ``group`` calls the step once per step; all tensors live on the
    device the group's backend serves.

    On a row × feature grid (``model_group``, the ranks that share this
    rank's row block; ``group`` is then the ranks that share its feature
    block: ``dist.mesh.grid_groups``) the stores are also feature-blocked:
    rank (r, c) holds ``(L, n_r, d_c)``, row block r of feature block c by
    the ceil rule over ``model_group`` (``lmc_placement(features=True)``),
    and the ranks of one feature group hold the same batch and the same
    ``x`` and ``self_w`` blocks. The step fetches feature block c of the
    store rows it reads over ``group``, gathers the full features over
    ``model_group``, runs the step of its row rank on them (so every rank
    of a feature group computes the same step), reduces over ``group``
    only, and routes columns c of its refreshed rows to their owners.

    Returns ``(loss, grads, owned, metrics)``, what ``make_train_step`` on
    the stacked batch (``stack_batches`` of every row rank's subgraph)
    returns up to f32 summation order: ``loss`` and ``grads`` are the mean
    over the row ranks (all-reduced, the same on every rank),
    ``metrics["train_acc"]`` a ratio of summed counts, and ``owned`` the
    :class:`OwnedRows` this rank owns of every rank's refreshed batch rows
    (feature block c of them on a grid; None when the method writes no
    store), for :func:`commit_owned_rows`.

    ``splits``, for the dry run only: ``(fetch, route)``, the rows asked of
    each row rank and sent to each, known in advance; the exchanges then
    skip their size exchange, their id check and the batch mask (see
    ``dist.collectives``).
    """
    inner = make_train_step(gnn, method, num_nodes, backend=backend,
                            stream=stream)
    L = gnn.num_layers
    fetch_splits, route_splits = splits if splits is not None else (None,
                                                                    None)
    d = gnn.hidden_dim
    c0, c1 = row_block(d, dp_axis_size(model_group), dp_rank(model_group))

    def full_features(rows: torch.Tensor) -> torch.Tensor:
        """(k, L, d_c) fetched store rows -> (k, L, d) over the feature
        group, in feature-block order."""
        if model_group is None:
            return rows
        return all_gather_blocks(rows, d, model_group, axis=2)

    def step(params: dict, store: Optional[HistoricalState], batch: Batch,
             x: torch.Tensor, self_w: torch.Tensor):
        nb, nh = batch.batch_gids.shape[0], batch.halo_gids.shape[0]
        # the rows the flat step would gather (ids clipped as gather_rows
        # does), fetched once: x, self_w and the pre-step h and v
        ext = torch.cat([batch.batch_gids, batch.halo_gids]).long().clamp(
            0, num_nodes - 1)
        shards = [x, self_w]
        if backend != "ti":
            shards += [store.h.transpose(0, 1), store.v.transpose(0, 1)]
        got = list(fetch_rows(tuple(shards), ext, num_nodes, group,
                              splits=fetch_splits))
        local_store = None
        if backend != "ti":   # the kernels take contiguous (L, rows, d)
            local_store = HistoricalState(
                h=full_features(got[2]).transpose(0, 1).contiguous(),
                v=full_features(got[3]).transpose(0, 1).contiguous())
        del got[2:]
        # local ids: batch rows 0..nb-1, halo rows nb..nb+nh-1; edges and
        # the ELL are batch-local already
        ids = torch.arange(nb + nh, dtype=batch.batch_gids.dtype,
                           device=batch.batch_gids.device)
        loss, grads, rows, metrics = inner(
            params, local_store,
            batch._replace(batch_gids=ids[:nb], halo_gids=ids[nb:]),
            got[0], got[1])

        # mean loss and gradients, and accuracy as a ratio of summed counts
        # (the inner accuracy is correct / max(labeled, 1) in f32: the count
        # comes back exact by rounding, for counts under 2^24)
        labeled = batch.labeled_mask[:nb].sum()
        correct = torch.round(metrics["train_acc"] * labeled.clamp_min(1.0))
        leaves: list = []
        tree_map(leaves.append, grads)
        summed = all_reduce_sum(
            [loss.reshape(1), correct.reshape(1), labeled.reshape(1)]
            + leaves, group)
        world = dp_axis_size(group)
        it = iter(summed[3:])
        grads = tree_map(lambda _: next(it) / world, grads)
        loss = summed[0].view_as(loss) / world
        acc = summed[1][0] / summed[2][0].clamp_min(1.0)

        owned = None
        if rows is not None:
            cols = slice(c0, c1) if model_group is not None else slice(None)
            payload = (rows.h[..., cols].transpose(0, 1),) + (
                (rows.v[..., cols].transpose(0, 1),) if L > 1 else ())
            gids, got_rows = route_rows(payload, batch.batch_gids,
                                        batch.batch_mask, num_nodes, group,
                                        splits=route_splits)
            owned = OwnedRows(
                gids, got_rows[0].transpose(0, 1),
                got_rows[1].transpose(0, 1) if L > 1 else None)
        return loss, grads, owned, {"loss": loss, "train_acc": acc}

    return step


def commit_owned_rows(store: HistoricalState, owned: OwnedRows,
                      num_nodes: int, group=None) -> HistoricalState:
    """Write a distributed step's :class:`OwnedRows` into this rank's row
    block of the stores in place (``commit_rows``'s semantics, offset by
    the block's start; on a grid ``group`` is the row group and the rows
    are this rank's feature block). Returns ``store``."""
    start, _ = row_block(num_nodes, dp_axis_size(group), dp_rank(group))
    idx = owned.gids.to(store.h.device) - start
    store.h.index_copy_(1, idx, owned.h.to(store.h.dtype))
    if owned.v is not None:
        store.v.index_copy_(1, idx, owned.v.to(store.v.dtype))
    return store
