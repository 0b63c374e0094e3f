"""Row exchanges between the ranks of a row-blocked store.

Each rank owns one contiguous block of node rows (``dist.sharding``). A step
needs rows that other ranks own (its halo, and the features of its batch),
and produces rows that other ranks own (the refreshed batch rows):

  fetch_rows        — ask the owners for rows by global id, get them back in
                      request order;
  route_rows        — the inverse: send rows to the ranks that own them;
  all_gather_blocks — every rank's block, whole (rank 0 saves whole trees).

Each exchange is two ``all_to_all_single`` calls: the split sizes first, then
the payload. A caller that knows the split sizes already (the dry run, which
traces a step on meta tensors, passes a uniform spread) gives them as
``splits``: the size exchange and the id check are skipped.
``rows``/``shard`` may be one tensor or a tuple of tensors whose leading
axis is the row axis; a tuple travels on one plan. Without a process
group the exchanges are local indexing; with one, even of a single rank,
they are the group's collectives. Tensors must be on the device the group's
backend serves (the CPU for gloo, the card for NCCL).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import (block_size, distributed,
                                       dp_axis_size, dp_rank, owner_of,
                                       row_block)

Rows = Union[torch.Tensor, Sequence[torch.Tensor]]


class _Plan(NamedTuple):
    order: torch.Tensor       # requester: request positions sorted by owner
    send: list                # requester: rows asked of each rank
    recv: list                # owner: rows each rank asks of it
    recv_gids: torch.Tensor   # owner: the asked global ids, by asker


def _map(fn, rows: Rows):
    if isinstance(rows, torch.Tensor):
        return fn(rows)
    return tuple(fn(r) for r in rows)


def _all_to_all(x: torch.Tensor, out_rows: int, out_splits: list,
                in_splits: list, group) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((out_rows,) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x, out_splits, in_splits, group=group)
    return out


def _plan(gids: torch.Tensor, n: int, group,
          splits: Optional[Sequence[int]] = None) -> _Plan:
    """Sort the requested ids by owner and tell each owner what it is
    asked. ``splits``, when given, is the number of ids asked of each rank
    and asked by each rank (the same both ways): no sizes are exchanged and
    the ids are not checked."""
    gids = gids.long()
    if splits is None and gids.numel() and (
            int(gids.min()) < 0 or int(gids.max()) >= n):
        raise ValueError(f"row ids must lie in [0, {n})")
    world = dp_axis_size(group)
    owner = owner_of(gids, n, world)
    order = torch.argsort(owner, stable=True)
    if not distributed(group):
        send = [int(gids.numel())]
        return _Plan(order, send, send, gids[order])
    if splits is not None:
        if len(splits) != world:
            raise ValueError(f"{len(splits)} split sizes for a group of "
                             f"{world} ranks")
        send = recv = [int(s) for s in splits]
    else:
        send_t = torch.bincount(owner, minlength=world)
        recv_t = torch.empty_like(send_t)
        dist.all_to_all_single(recv_t, send_t, group=group)
        send, recv = send_t.tolist(), recv_t.tolist()
    recv_gids = _all_to_all(gids[order], sum(recv), recv, send, group)
    return _Plan(order, send, recv, recv_gids)


def fetch_rows(shard: Rows, gids: torch.Tensor, n: int, group=None, *,
               splits: Optional[Sequence[int]] = None) -> Rows:
    """Rows ``gids`` (global ids in ``[0, n)``) of the row-blocked tensor(s)
    ``shard``, of which this rank holds its block, in request order.

    Every rank of ``group`` must call it (with its own ``gids``, possibly
    none). Returns a tensor of ``len(gids)`` rows, or a tuple for a tuple.
    ``splits``: the rows asked of (and by) each rank, known in advance
    (see :func:`_plan`).
    """
    plan = _plan(gids, n, group, splits)
    start, _ = row_block(n, dp_axis_size(group), dp_rank(group))
    local = plan.recv_gids - start

    def one(s: torch.Tensor) -> torch.Tensor:
        asked = s.index_select(0, local)
        got = asked if not distributed(group) else _all_to_all(
            asked, sum(plan.send), plan.send, plan.recv, group)
        out = torch.empty_like(got)
        out[plan.order] = got
        return out

    return _map(one, shard)


def route_rows(rows: Rows, gids: torch.Tensor, mask: torch.Tensor, n: int,
               group=None, *, splits: Optional[Sequence[int]] = None
               ) -> tuple[torch.Tensor, Rows]:
    """Send each row ``rows[i]`` with ``mask[i] > 0`` to the rank that owns
    global id ``gids[i]``; padded rows (mask 0, or an id outside ``[0, n)``)
    have no owner and are dropped.

    Every rank of ``group`` must call it. Returns ``(got_gids, got_rows)``:
    the global ids (int64) and rows this rank owns and was sent, in the
    order of the senders' ranks. With ``splits`` (the rows sent to and by
    each rank, known in advance: see :func:`_plan`) every row is sent, its
    id clipped into ``[0, n)``, and the mask is not read.
    """
    if splits is None:
        keep = (mask > 0) & (gids >= 0) & (gids < n)
        gids = gids[keep].long()
    else:
        keep = slice(None)
        gids = gids.long().clamp(0, n - 1)
    plan = _plan(gids, n, group, splits)

    def one(r: torch.Tensor) -> torch.Tensor:
        sent = r[keep][plan.order]
        if not distributed(group):
            return sent
        return _all_to_all(sent, sum(plan.recv), plan.recv, plan.send, group)

    return plan.recv_gids, _map(one, rows)


def all_gather_blocks(block: torch.Tensor, n: int, group=None,
                      axis: int = 0) -> torch.Tensor:
    """The whole ``n``-row tensor from every rank's row block along
    ``axis`` (each rank gets it). Every rank of ``group`` must call it."""
    if not distributed(group):
        return block
    world = dp_axis_size(group)
    b = block_size(n, world)
    moved = block.movedim(axis, 0)
    padded = moved.new_zeros((b,) + tuple(moved.shape[1:]))
    padded[:moved.shape[0]] = moved
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded, group=group)
    # lint: ok(R001) plain tensors: the GNN's row exchanges run one process per device over torch.distributed, never on DTensors
    return torch.cat(parts)[:n].movedim(0, axis)


def all_reduce_sum(tensors: Sequence[torch.Tensor],
                   group=None) -> list[torch.Tensor]:
    """Each tensor summed over the ranks, in one ``all_reduce`` of their
    flat concatenation (``ReduceOp.SUM``: gloo has no ``AVG``)."""
    if not distributed(group):
        return list(tensors)
    # lint: ok(R001) plain tensors: the GNN's gradients and counts, summed over the ranks of a torch.distributed group, never DTensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return out

