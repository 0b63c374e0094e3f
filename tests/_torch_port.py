"""Shared inputs of the port's trainer parity tests: the tiny graph that
either package builds from one numpy seed (the reference's ``tiny_graph``
fixture of tests/test_ell_backend.py), its fixed partition, and a port
trainer on it. Imports no JAX."""
import numpy as np
import torch

N, PARTS = 300, 4
NO_STRAGGLERS = float("inf")   # no step is late: streams stay comparable


def tiny_graph(lib):
    """The tiny random graph, built by ``lib`` (``repro.graph`` or
    ``repro_torch.graph``)."""
    rng = np.random.default_rng(0)
    n, e = N, 1200
    x = rng.normal(size=(n, 12)).astype(np.float32)
    y = rng.integers(0, 5, n).astype(np.int32)
    tm = rng.random(n) < 0.6
    vm = (~tm) & (rng.random(n) < 0.5)
    return lib.Graph.from_edges(n, rng.integers(0, n, e),
                                rng.integers(0, n, e), x, y, tm, vm,
                                ~(tm | vm))


def tiny_parts() -> np.ndarray:
    return np.random.default_rng(1).integers(0, PARTS, N).astype(np.int32)


def port_trainer(graph, parts, ckpt_dir=None, *, arch="gcn", lr=0.3,
                 hidden=16, params=None, optimizer=None, **kw):
    """A port GNNTrainer on the CPU: 2 layers, one cluster of ``PARTS`` per
    batch (sampler seed 1), checkpoints every 10 steps, no stragglers.
    ``params`` (a reference parameter tree of numpy arrays) replaces the
    GNN's own seeded ones."""
    from repro_torch.convert import params_from_reference
    from repro_torch.core import LMC
    from repro_torch.graph import ClusterSampler
    from repro_torch.models import make_gnn
    from repro_torch.optim import sgd
    from repro_torch.train import GNNTrainer
    gnn = make_gnn(arch, graph.feature_dim, hidden, graph.num_classes, 2,
                   generator=torch.Generator().manual_seed(0))
    if params is not None:
        params_from_reference(gnn, params)
    kw.setdefault("straggler_deadline", NO_STRAGGLERS)
    kw.setdefault("ckpt_every", 10)
    return GNNTrainer(gnn, kw.pop("method", LMC), graph,
                      ClusterSampler(graph, PARTS, 1, parts=parts, seed=1),
                      optimizer or sgd(lr=lr), ckpt_dir=ckpt_dir,
                      device="cpu", **kw)


def losses(tr) -> dict:
    """step -> loss, keeping the LAST record per step (replays overwrite)."""
    return {h["step"]: h["loss"] for h in tr.history if "loss" in h}


def events(tr, kind=None) -> list:
    return [h for h in tr.history
            if h.get("event") and (kind is None or h["event"] == kind)]
