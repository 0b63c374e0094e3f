"""The exact answer of a served GNN: the full-graph forward, plain, layer by
layer over the whole graph (``torch.sparse.mm`` over the whole CSR with the
GCN weights from the graph's degrees), f32 with TF32 off unless asked."""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.lmc import arch_module, csr_tensor, matmul_precision


def full_logits(cfg: dict, graph: dict, params: dict, device="cuda",
                tf32: bool = False) -> torch.Tensor:
    """(n, classes) logits of every node."""
    dev = torch.device(device)
    arch = arch_module(cfg["arch"])
    indptr, indices = graph["indptr"], graph["indices"]
    n = indptr.shape[0] - 1
    deg = np.diff(indptr).astype(np.float64) + 1.0
    rows = np.repeat(np.arange(n), np.diff(indptr))
    w = (1.0 / np.sqrt(deg[rows] * deg[indices])).astype(np.float32)
    A = csr_tensor(indptr, indices, w, n, dev)
    s = torch.from_numpy((1.0 / deg).astype(np.float32)).to(dev)
    p = {k: v.detach().to(dev, torch.float32) for k, v in params.items()}
    with torch.no_grad(), matmul_precision(tf32):
        x = torch.from_numpy(graph["x"]).to(dev)
        h0 = arch.embed(p, x)
        h = h0
        for l in range(cfg["num_layers"]):
            h, _ = arch.layer(p, cfg, l, lambda t: torch.sparse.mm(A, t), s,
                              h, h0)
        return h @ p["head.w"] + p["head.b"]
