"""Frozen copy of the port's synthetic dataset generator.

The same stochastic-block-model graphs as
``repro_torch.graph.synthetic.make_sbm_dataset`` (nodes, average degree,
classes and feature width of the paper's datasets, a planted
community/label correlation), copied so that the benchmark's data cannot
move with the program. Returns plain numpy arrays: the symmetric,
deduplicated, self-loop-free CSR graph, features, labels and split masks.
"""
from __future__ import annotations

import numpy as np

# name -> (nodes, avg_degree, classes, feature_dim)
PRESETS: dict[str, tuple[int, float, int, int]] = {
    "arxiv-cpu": (4096, 13.7, 40, 128),
    "ppi-cpu": (2048, 28.0, 16, 50),
    "arxiv-like": (169_343, 13.7, 40, 128),
    "reddit-like": (232_965, 99.6, 41, 128),
    "ppi-like": (56_944, 27.9, 121, 50),
}


def _sbm_edges(n, k, comm, avg_deg, p_in_frac, rng):
    deg_in = avg_deg * p_in_frac
    deg_out = avg_deg * (1 - p_in_frac)
    sizes = np.bincount(comm, minlength=k).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    order = np.argsort(comm, kind="stable")
    srcs, dsts = [], []
    for a in range(k):
        na = sizes[a]
        if na < 2:
            continue
        m = rng.poisson(na * deg_in / 2.0)
        if m:
            srcs.append(order[starts[a] + rng.integers(0, na, m)])
            dsts.append(order[starts[a] + rng.integers(0, na, m)])
        m = rng.poisson(na * deg_out / 2.0)
        if m:
            srcs.append(order[starts[a] + rng.integers(0, na, m)])
            dsts.append(rng.integers(0, n, m))
    if not srcs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(srcs), np.concatenate(dsts)


def _csr(n, src, dst):
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    code = np.unique(np.concatenate([src * n + dst, dst * n + src]))
    a, b = code // n, code % n
    order = np.argsort(a, kind="stable")
    a, b = a[order], b[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, a + 1, 1)
    return np.cumsum(indptr), b.astype(np.int32)


def make_sbm(preset: str, *, seed: int = 0, p_in_frac: float = 0.85,
             feature_snr: float = 1.5, label_noise: float = 0.05,
             splits: tuple = (0.6, 0.2)) -> dict:
    """The preset's graph as arrays: ``indptr`` (n+1,) int64, ``indices``
    (nnz,) int32, ``x`` (n, dx) f32, ``y`` (n,) int32 and the boolean
    ``train_mask``/``val_mask``/``test_mask``."""
    n, avg_deg, k, dx = PRESETS[preset]
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, k, n).astype(np.int32)
    src, dst = _sbm_edges(n, k, comm, avg_deg, p_in_frac, rng)
    centroids = rng.normal(0.0, 1.0, (k, dx)).astype(np.float32)
    centroids *= feature_snr / np.sqrt(dx)
    x = centroids[comm] + rng.normal(0, 1.0 / np.sqrt(dx),
                                     (n, dx)).astype(np.float32)
    y = comm.copy()
    flip = rng.random(n) < label_noise
    y[flip] = rng.integers(0, k, int(flip.sum()))
    perm = rng.permutation(n)
    n_train, n_val = int(splits[0] * n), int(splits[1] * n)
    masks = [np.zeros(n, bool) for _ in range(3)]
    masks[0][perm[:n_train]] = True
    masks[1][perm[n_train:n_train + n_val]] = True
    masks[2][perm[n_train + n_val:]] = True
    indptr, indices = _csr(n, src, dst)
    return {"indptr": indptr, "indices": indices, "x": x,
            "y": y.astype(np.int32), "train_mask": masks[0],
            "val_mask": masks[1], "test_mask": masks[2]}
