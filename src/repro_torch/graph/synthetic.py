"""Synthetic graph datasets (numpy; a copy of ``repro.graph.synthetic`` that
gives identical graphs for a seed).

The paper's datasets (PPI / Reddit / Flickr / ogbn-arxiv) are not downloadable
in this offline container, so we generate stochastic-block-model graphs that
match their headline statistics (nodes, avg degree, classes, feature dim) and
carry a planted community↔label correlation so that GNN training is meaningful
and convergence comparisons (LMC vs GAS vs Cluster-GCN) are informative.

Features are drawn from class-conditional Gaussians with controllable SNR, so
full-batch GCN reaches high accuracy and mini-batch methods can be compared on
epochs-to-target exactly like the paper's Table 2 / Figure 2.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.structure import Graph

# name -> (nodes, avg_degree, classes, feature_dim)
DATASET_PRESETS: dict[str, tuple[int, float, int, int]] = {
    # CPU-scale stand-ins used by tests/benchmarks (same shape, smaller n)
    "arxiv-cpu": (4096, 13.7, 40, 128),
    "flickr-cpu": (4096, 10.0, 7, 128),
    "reddit-cpu": (4096, 50.0, 41, 128),
    "ppi-cpu": (2048, 28.0, 16, 50),
    # full-scale stand-ins (match paper Table 4 statistics)
    "arxiv-like": (169_343, 13.7, 40, 128),
    "flickr-like": (89_250, 10.0, 7, 500),
    "reddit-like": (232_965, 99.6, 41, 128),
    "ppi-like": (56_944, 27.9, 121, 50),
}


def _sbm_edges(n: int, k: int, comm: np.ndarray, avg_deg: float,
               p_in_frac: float, rng: np.random.Generator
               ) -> tuple[np.ndarray, np.ndarray]:
    """Fast SBM edge sampling: expected-count binomial per block pair."""
    # split expected degree into intra / inter community mass
    deg_in = avg_deg * p_in_frac
    deg_out = avg_deg * (1 - p_in_frac)
    sizes = np.bincount(comm, minlength=k).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    # nodes sorted by community for block-local index sampling
    order = np.argsort(comm, kind="stable")

    srcs, dsts = [], []
    for a in range(k):
        na = sizes[a]
        if na < 2:
            continue
        # intra-block: E[edges] = na * deg_in / 2
        m = rng.poisson(na * deg_in / 2.0)
        if m:
            s = order[starts[a] + rng.integers(0, na, m)]
            d = order[starts[a] + rng.integers(0, na, m)]
            srcs.append(s)
            dsts.append(d)
        # inter-block: spread deg_out mass over all other blocks proportionally
        m = rng.poisson(na * deg_out / 2.0)
        if m:
            s = order[starts[a] + rng.integers(0, na, m)]
            d = rng.integers(0, n, m)  # approx: uniform other endpoint
            srcs.append(s)
            dsts.append(d)
    if not srcs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(srcs), np.concatenate(dsts)


def make_sbm_dataset(preset: str = "arxiv-cpu", *, seed: int = 0,
                     p_in_frac: float = 0.85, feature_snr: float = 1.5,
                     label_noise: float = 0.05,
                     splits: tuple[float, float] = (0.6, 0.2)) -> Graph:
    """Build a community-structured graph with learnable labels.

    p_in_frac: fraction of each node's expected degree that stays inside its
        community (higher -> cleaner clusters -> smaller partition edge-cut).
    feature_snr: distance between class feature centroids in noise-σ units.
    """
    if preset not in DATASET_PRESETS:
        raise KeyError(f"unknown preset {preset!r}; options {list(DATASET_PRESETS)}")
    n, avg_deg, k, dx = DATASET_PRESETS[preset]
    rng = np.random.default_rng(seed)

    comm = rng.integers(0, k, n).astype(np.int32)
    src, dst = _sbm_edges(n, k, comm, avg_deg, p_in_frac, rng)

    centroids = rng.normal(0.0, 1.0, (k, dx)).astype(np.float32)
    centroids *= feature_snr / np.sqrt(dx)
    x = centroids[comm] + rng.normal(0, 1.0 / np.sqrt(dx), (n, dx)).astype(np.float32)

    y = comm.copy()
    flip = rng.random(n) < label_noise
    y[flip] = rng.integers(0, k, int(flip.sum()))

    perm = rng.permutation(n)
    n_train = int(splits[0] * n)
    n_val = int(splits[1] * n)
    train_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    train_mask[perm[:n_train]] = True
    val_mask[perm[n_train:n_train + n_val]] = True
    test_mask[perm[n_train + n_val:]] = True

    return Graph.from_edges(n, src, dst, x, y.astype(np.int32),
                            train_mask, val_mask, test_mask, name=preset)
