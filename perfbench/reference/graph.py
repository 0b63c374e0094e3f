"""What the program derives from the graph, worked out again in numpy.

* :func:`partition` is a frozen copy of the port's METIS stand-in
  (``repro_torch.graph.partition.partition_graph``: BFS order, linear
  deterministic greedy, boundary refinement). It fixes which nodes form a
  cluster, so it is part of the work's definition and is copied, not
  rewritten.
* :func:`epoch_clusters` is the sampler's ``mode="epoch"`` schedule: slot
  ``i`` of a shuffled epoch of ``B/c`` slots, drawn from ``(seed, tag,
  epoch)``.
* :func:`extended` builds a batch's extended subgraph by LMC's definition
  (Eqs. 8-10): the batch, its 1-hop halo, every edge into a batch node,
  the edges into a halo node from inside the extended set, GCN weights
  from whole-graph degrees and the halo's β = 2x - x² of its local degree
  share (App. A.4).
"""
from __future__ import annotations

from collections import deque

import numpy as np

_EPOCH_TAG = 0x5A3D02


def _bfs_order(indptr, indices, rng):
    n = indptr.shape[0] - 1
    seen = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    q: deque = deque()
    for s in rng.permutation(n):
        if seen[s]:
            continue
        seen[s] = True
        q.append(int(s))
        while q:
            v = q.popleft()
            order[pos] = v
            pos += 1
            for u in indices[indptr[v]:indptr[v + 1]]:
                if not seen[u]:
                    seen[u] = True
                    q.append(int(u))
    return order


def _refine(indptr, indices, parts, fill, cap):
    num_parts = fill.shape[0]
    moved = 0
    gain = np.zeros(num_parts, dtype=np.int64)
    for v in range(indptr.shape[0] - 1):
        nbrs = indices[indptr[v]:indptr[v + 1]]
        if nbrs.size == 0:
            continue
        gain[:] = 0
        np.add.at(gain, parts[nbrs], 1)
        cur = parts[v]
        best = int(np.argmax(gain))
        if best != cur and gain[best] > gain[cur] and fill[best] + 1 <= cap:
            parts[v] = best
            fill[cur] -= 1
            fill[best] += 1
            moved += 1
    return moved


def partition(indptr, indices, num_parts: int, *, seed: int = 0,
              slack: float = 1.05, refine_iters: int = 2) -> np.ndarray:
    """Balanced parts (cap ``slack`` × n / parts) by linear deterministic
    greedy over a BFS order, then boundary refinement."""
    n = indptr.shape[0] - 1
    if num_parts <= 1:
        return np.zeros(n, dtype=np.int32)
    rng = np.random.default_rng(seed)
    cap = max(1.0, slack * n / num_parts)
    parts = np.full(n, -1, dtype=np.int32)
    fill = np.zeros(num_parts, dtype=np.int64)
    nbr_count = np.zeros(num_parts, dtype=np.float64)
    for v in _bfs_order(indptr, indices, rng):
        nbr_count[:] = 0.0
        for u in indices[indptr[v]:indptr[v + 1]]:
            p = parts[u]
            if p >= 0:
                nbr_count[p] += 1.0
        score = nbr_count * (1.0 - fill / cap)
        if nbr_count.max() <= 0.0 or score.max() <= 0.0:
            p = int(np.argmin(fill))
        else:
            p = int(np.argmax(score))
        if fill[p] >= cap:
            avail = np.where(fill < cap)[0]
            p = (int(avail[np.argmax(score[avail])]) if avail.size
                 else int(np.argmin(fill)))
        parts[v] = p
        fill[p] += 1
    for _ in range(refine_iters):
        if _refine(indptr, indices, parts, fill, cap) == 0:
            break
    return parts


def epoch_clusters(seed: int, index: int, num_parts: int,
                   per_batch: int) -> np.ndarray:
    """Cluster ids of schedule slot ``index`` under the epoch schedule."""
    e, s = divmod(int(index), num_parts // per_batch)
    order = np.random.default_rng([int(seed), _EPOCH_TAG, e]).permutation(
        num_parts)
    return order[s * per_batch:(s + 1) * per_batch]


def _neighbours(indptr, indices, nodes):
    """(node repeated per neighbour, neighbour) over ``nodes``' lists."""
    lens = indptr[nodes + 1] - indptr[nodes]
    total = int(lens.sum())
    starts = np.repeat(indptr[nodes] - np.concatenate(
        [[0], np.cumsum(lens)[:-1]]), lens)
    pos = starts + np.arange(total, dtype=np.int64)
    return np.repeat(nodes, lens), indices[pos].astype(np.int64)


def extended(indptr, indices, batch: np.ndarray) -> dict:
    """The extended subgraph of ``batch`` (global ids), rows ordered
    batch first, then the halo ascending. Returns ``ext`` (global ids of
    the rows), ``nb``, the local edge lists ``src``/``dst`` with f32
    weights ``w``, the rows' self weights ``s`` and the halo's ``beta``."""
    n = indptr.shape[0] - 1
    deg = np.diff(indptr).astype(np.int64)
    batch = np.asarray(batch, np.int64)
    in_batch = np.zeros(n, bool)
    in_batch[batch] = True
    d1, s1 = _neighbours(indptr, indices, batch)
    halo = np.unique(s1[~in_batch[s1]])
    ext = np.concatenate([batch, halo])
    local = np.full(n, -1, np.int64)
    local[ext] = np.arange(ext.shape[0])
    d2, s2 = _neighbours(indptr, indices, halo)
    inside = local[s2] >= 0
    d2, s2 = d2[inside], s2[inside]
    src = np.concatenate([s1, s2])
    dst = np.concatenate([d1, d2])
    dp1 = deg.astype(np.float64) + 1.0
    w = (1.0 / np.sqrt(dp1[src] * dp1[dst])).astype(np.float32)
    share = np.bincount(local[d2] - batch.shape[0],
                        minlength=halo.shape[0]) / np.maximum(deg[halo], 1)
    beta = np.clip(2 * share - share * share, 0.0, 1.0).astype(np.float32)
    return {"ext": ext, "nb": int(batch.shape[0]), "src": local[src],
            "dst": local[dst], "w": w,
            "s": (1.0 / dp1[ext]).astype(np.float32), "beta": beta}
