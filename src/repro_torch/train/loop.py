"""The synchronous LMC training loop (Algorithm 1) on one device.

:class:`GNNTrainer` samples a c-cluster batch on the host, builds its tensors
(and, for ``backend="ell"|"ti"``, the bucketed ELL adjacency with its
transpose), runs the train step on the device, applies the optimizer, and
then commits the step's refreshed store rows. Straggler mitigation: a step
slower than ``straggler_deadline`` × the running median step time drops its
store update (``straggler_policy="skip-store"``), which Thm 2's staleness
term tolerates, by simply not committing the rows.

This is the reference trainer's synchronous path (``prefetch=None``,
``recycle=1``). Its other options are not ported yet and raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core import (MBMethod, accuracy, commit_rows, from_graph,
                              host_batch, init_history, make_train_step)
from repro_torch.device import resolve_device
from repro_torch.graph.sampler import ClusterSampler
from repro_torch.models.gnn import GNN
from repro_torch.optim.optimizers import Optimizer, tree_map

# running-median straggler baseline, bounded so the median stays O(1)
_STEP_TIME_WINDOW = 512


def _unported(name: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"GNNTrainer({name}=...) is not ported yet: ROADMAP.md, queue A, "
        f"{item}")


class GNNTrainer:
    """Sampling, the LMC step, optimizer updates and store commits for one
    run on one device.

    The initial parameters are ``gnn``'s own (copied to ``device``); the
    trained ones are ``self.params``, in the layout of ``GNN.params()``.
    ``device=None`` means the CUDA card and raises without one.
    """

    def __init__(self, gnn: GNN, method: MBMethod, graph,
                 sampler: ClusterSampler, optimizer: Optimizer, *,
                 backend: str = "segment", stream: Optional[bool] = None,
                 straggler_deadline: float = 4.0,
                 straggler_policy: str = "skip-store",
                 ckpt_dir: Optional[str] = None, health=None,
                 failure_injector=None, prefetch: Optional[int] = None,
                 recycle: int = 1, device=None):
        if ckpt_dir is not None:
            raise _unported("ckpt_dir", "item 2 (checkpoint/manager.py, "
                                        "format 2)")
        if health is not None:
            raise _unported("health", "item 1 (the training half of "
                                      "train/health.py)")
        if failure_injector is not None:
            raise _unported("failure_injector", "item 1 (the training half "
                                                "of train/health.py)")
        if prefetch is not None:
            raise _unported("prefetch", "item 4 (the pipeline and "
                                        "supervisor)")
        if recycle != 1:
            raise _unported("recycle", "item 4 (the pipeline and "
                                       "supervisor)")
        self.gnn = gnn
        self.method = method
        self.graph = graph
        self.sampler = sampler
        self.opt = optimizer
        self.backend = backend
        self.stream = stream
        self.straggler_deadline = straggler_deadline
        self.straggler_policy = straggler_policy
        self.device = resolve_device(device)
        self.data = from_graph(graph, device=self.device)
        self.params = tree_map(lambda p: p.detach().to(self.device, copy=True),
                               gnn.params())
        self.opt_state = optimizer.init(self.params)
        self.store = init_history(gnn.num_layers, graph.num_nodes,
                                  gnn.hidden_dim, device=self.device)
        self.step_num = 0
        self.lr = float(optimizer.lr)
        self._step = make_train_step(gnn, method, graph.num_nodes,
                                     backend=backend, stream=stream)
        self._step_times: deque = deque(maxlen=_STEP_TIME_WINDOW)
        self.history: list = []

    def run(self, num_steps: int, *, eval_every: int = 0) -> list:
        """Train for ``num_steps`` more steps; returns the history list.

        Each step appends ``{"step", "loss", "train_acc", "grad_norm",
        "time_s", "host_s", "straggler"}``: ``time_s`` is the whole step on
        the host clock (sampling to the optimizer's synchronised result),
        ``host_s`` its host sampling and batch build. Every ``eval_every``
        steps a ``{"step", "val_acc"}`` record follows.
        """
        target = self.step_num + num_steps
        while self.step_num < target:
            self._one_step()
            if eval_every and self.step_num % eval_every == 0:
                self.history.append({"step": self.step_num,
                                     "val_acc": self.eval("val")})
        return self.history

    def _one_step(self) -> None:
        t0 = time.perf_counter()
        sg = self.sampler.sample()
        hb = host_batch(sg, backend=self.backend)
        host_s = time.perf_counter() - t0
        batch = hb.to(self.device)
        loss, grads, rows, metrics = self._step(
            self.params, self.store, batch, self.data.x, self.data.self_w)
        self.params, self.opt_state, gnorm = self.opt.update(
            grads, self.opt_state, self.params, self.lr)
        lossf, gnormf = float(loss), float(gnorm)
        dt = time.perf_counter() - t0
        med = float(np.median(self._step_times)) if self._step_times else dt
        is_straggler = (len(self._step_times) >= 8
                        and dt > self.straggler_deadline * med)
        if rows is not None and not (is_straggler and
                                     self.straggler_policy == "skip-store"):
            commit_rows(self.store, batch, rows, self.graph.num_nodes)
        self._step_times.append(dt)
        self.step_num += 1
        self.history.append({
            "step": self.step_num, "loss": lossf,
            "train_acc": float(metrics["train_acc"]), "grad_norm": gnormf,
            "time_s": dt, "host_s": host_s, "straggler": bool(is_straggler)})

    def eval(self, split: str = "val") -> float:
        """Full-graph accuracy on the given split ("train"|"val"|"test")."""
        mask = {"val": self.graph.val_mask, "test": self.graph.test_mask,
                "train": self.graph.train_mask}[split]
        with torch.no_grad():
            return float(accuracy(
                self.gnn, self.params, self.data,
                torch.from_numpy(mask.astype(np.float32)).to(self.device)))
