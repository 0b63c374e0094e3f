"""Open-loop request schedules, from a traffic mix's parameters and a seed.

A schedule is the due time of each request (seconds from the window's
start) and its target nodes. The window is cut into blocks of the mix's
``block_s`` seconds, and every block carries the same load:
``round(rate_rps * block_s)`` requests whose gaps are the exponential
distribution's quantiles at ``(i + 0.5) / k``, scaled to fill the block,
in an order drawn from the seed (Poisson-like arrivals within a block, a
fixed count per block), and sizes that are the log-uniform
distribution's quantiles from ``size_min`` to ``size_max``, ends
included, in another order drawn from the seed. So every seed sends the
same load in every block; only the order and the node ids, drawn
uniformly without repeats within a request, move with the seed. A
queue's tail follows how arrivals and large requests cluster, so one order
drawn over the whole window would change the work from seed to seed.
"""
from __future__ import annotations

import numpy as np


def schedule(mix: dict, seed: int, seconds: float, num_nodes: int) -> tuple:
    """``(due, nodes)``: due times (ascending, from 0, within ``seconds``)
    and one int64 array of distinct node ids per request."""
    rate = float(mix["rate_rps"])
    blocks = max(1, int(round(seconds / float(mix["block_s"]))))
    per = max(1, int(round(rate * seconds / blocks)))
    rng = np.random.default_rng([int(seed), 0x10AD])
    q = (np.arange(per) + 0.5) / per
    gaps = -np.log1p(-q)
    gaps *= (seconds / blocks) / gaps.sum()
    order = np.concatenate([rng.permutation(gaps) for _ in range(blocks)])
    due = np.concatenate([[0.0], np.cumsum(order)[:-1]])
    lo, hi = int(mix["size_min"]), int(mix["size_max"])
    qs = np.arange(per) / max(per - 1, 1)
    sizes = np.floor(np.exp(np.log(lo) + qs * (np.log(hi + 1) - np.log(lo))))
    sizes = np.clip(sizes, lo, hi).astype(np.int64)
    sizes = np.concatenate([rng.permutation(sizes) for _ in range(blocks)])
    nodes = [_distinct(rng, num_nodes, int(k)) for k in sizes]
    return due, nodes


def _distinct(rng, n: int, k: int) -> np.ndarray:
    out = np.unique(rng.integers(0, n, k))
    while out.shape[0] < k:
        out = np.unique(np.concatenate([out, rng.integers(0, n, k)]))[:k]
    return rng.permutation(out)
