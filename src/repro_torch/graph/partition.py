"""Graph partitioning (METIS stand-in; a copy of ``repro.graph.partition``).

METIS is unavailable in this offline container, so we implement a deterministic
multi-seed BFS + greedy Linear Deterministic Greedy (LDG) streaming partitioner
with a boundary-refinement pass. Quality (edge-cut) is reported by
:func:`edge_cut_fraction` and recorded in EXPERIMENTS.md; for the SBM-style
benchmark graphs it recovers community structure almost exactly, which is the
property Cluster-GCN/GAS/LMC rely on.

The interface also accepts externally computed partition vectors, so a real
deployment can swap METIS/KaHIP in without touching the trainer.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch.graph.structure import Graph


def _bfs_order(graph: Graph, rng: np.random.Generator) -> np.ndarray:
    """Node visitation order by BFS from random seeds (one per component)."""
    n = graph.num_nodes
    seen = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    perm = rng.permutation(n)
    q: deque[int] = deque()
    for s in perm:
        if seen[s]:
            continue
        seen[s] = True
        q.append(int(s))
        while q:
            v = q.popleft()
            order[pos] = v
            pos += 1
            for u in graph.neighbors(v):
                if not seen[u]:
                    seen[u] = True
                    q.append(int(u))
    assert pos == n
    return order


def partition_graph(graph: Graph, num_parts: int, *, seed: int = 0,
                    slack: float = 1.05, refine_iters: int = 2) -> np.ndarray:
    """Partition nodes into ``num_parts`` balanced parts, minimizing edge cut.

    LDG objective: assign v to argmax_p |N(v) ∩ P_p| * (1 - |P_p|/cap).
    """
    n = graph.num_nodes
    if num_parts <= 1:
        return np.zeros(n, dtype=np.int32)
    rng = np.random.default_rng(seed)
    cap = max(1.0, slack * n / num_parts)
    parts = np.full(n, -1, dtype=np.int32)
    fill = np.zeros(num_parts, dtype=np.int64)

    order = _bfs_order(graph, rng)
    nbr_count = np.zeros(num_parts, dtype=np.float64)
    for v in order:
        nbr_count[:] = 0.0
        for u in graph.neighbors(v):
            p = parts[u]
            if p >= 0:
                nbr_count[p] += 1.0
        score = nbr_count * (1.0 - fill / cap)
        # fall back to least-filled part when no placed neighbors
        if nbr_count.max() <= 0.0 or score.max() <= 0.0:
            p = int(np.argmin(fill))
        else:
            p = int(np.argmax(score))
        if fill[p] >= cap:
            avail = np.where(fill < cap)[0]
            p = int(avail[np.argmax(score[avail])]) if avail.size else int(np.argmin(fill))
        parts[v] = p
        fill[p] += 1

    for _ in range(refine_iters):
        moved = _refine_boundary(graph, parts, fill, cap)
        if moved == 0:
            break
    return parts


def _refine_boundary(graph: Graph, parts: np.ndarray, fill: np.ndarray,
                     cap: float) -> int:
    """Greedy single-pass boundary refinement: move a node to the neighbor-majority
    part when that strictly reduces cut and respects balance."""
    n = graph.num_nodes
    num_parts = fill.shape[0]
    moved = 0
    gain_buf = np.zeros(num_parts, dtype=np.int64)
    for v in range(n):
        nbrs = graph.neighbors(v)
        if nbrs.size == 0:
            continue
        gain_buf[:] = 0
        np.add.at(gain_buf, parts[nbrs], 1)
        cur = parts[v]
        best = int(np.argmax(gain_buf))
        if best != cur and gain_buf[best] > gain_buf[cur] and fill[best] + 1 <= cap:
            parts[v] = best
            fill[cur] -= 1
            fill[best] += 1
            moved += 1
    return moved


def edge_cut_fraction(graph: Graph, parts: np.ndarray) -> float:
    """Fraction of (directed) edges whose endpoints lie in different parts."""
    src = np.repeat(np.arange(graph.num_nodes), np.diff(graph.indptr))
    cut = (parts[src] != parts[graph.indices]).sum()
    return float(cut) / max(graph.num_edges, 1)


def partition_balance(parts: np.ndarray, num_parts: int) -> float:
    """max part size / mean part size (1.0 = perfectly balanced)."""
    sizes = np.bincount(parts, minlength=num_parts)
    return float(sizes.max() / max(sizes.mean(), 1e-9))
