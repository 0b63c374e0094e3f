"""Training cells: ``GNNTrainer.run`` on the async pipeline path, closed loop.

Set-up builds one trainer from the seed (graph, partition, sampler,
weights, stores, pipeline) and drives its first steps through
``run(1)``, the window's own call and feed, on batches whose rows all
differ (the first slots of a shuffled epoch); the same trainer then runs
the window, a step starting when the previous one ends. After the window
the plain reference (``reference/lmc.py``) repeats the first steps from the
same weights and graph, and ``checks.train_numbers`` compares the two.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench import checks, harness
from perfbench.reference import graph as rgraph
from perfbench.reference.lmc import RefLMC

FIRST_STEPS = 3       # steps of set-up that the reference follows
BUILD_SAMPLES = 3     # batch builds timed alone after a traced window


class Program:
    """The system under test for one seed: a ``GNNTrainer`` on the card."""

    def __init__(self, ctx: harness.Ctx, arrays: dict, parts=None):
        from repro_torch.core import METHODS
        from repro_torch.graph.partition import partition_graph
        from repro_torch.graph.sampler import ClusterSampler
        from repro_torch.graph.structure import Graph
        from repro_torch.models import make_gnn
        from repro_torch.optim import make_optimizer
        from repro_torch.train import GNNTrainer

        cfg, mix = ctx.config, ctx.traffic
        self.cfg, self.mix, self.ctx = cfg, mix, ctx
        self.seed = harness.norm_seed(ctx.seed)
        graph = Graph(**arrays, name=cfg["dataset"])
        self.parts = (partition_graph(graph, cfg["num_parts"], seed=0)
                      if parts is None else parts)
        self.part_sizes = np.bincount(self.parts, minlength=cfg["num_parts"])
        counts: dict = {}

        class Sampler(ClusterSampler):
            """The program's sampler; records each built batch's real
            rows and edges (a span around the program's call)."""

            def build_batch(self, cluster_ids):
                sg = super().build_batch(cluster_ids)
                counts[tuple(sorted(int(c) for c in cluster_ids))] = (
                    sg.n_batch_real, sg.n_halo_real, sg.n_edges_real)
                return sg

        self.counts = counts
        self.sampler = Sampler(graph, cfg["num_parts"],
                               cfg["clusters_per_batch"], parts=self.parts,
                               seed=self.seed)
        self.weights = harness.make_weights(cfg, self.seed, ctx.device)
        with torch.device("meta"):
            gnn = make_gnn(cfg["arch"], cfg["feature_dim"],
                           cfg["hidden_dim"], cfg["num_classes"],
                           cfg["num_layers"], alpha=cfg.get("alpha", 0.1),
                           lam=cfg.get("lam", 0.5), **cfg.get("arch_kw", {}))
        gnn.load_state_dict(self.weights, assign=True)
        opt = cfg["optimizer"]
        self.trainer = GNNTrainer(
            gnn, METHODS[cfg["method"]], graph, self.sampler,
            make_optimizer(opt["name"], lr=opt["lr"]),
            backend=cfg["backend"], prefetch=mix["prefetch"],
            recycle=mix["recycle"], pipeline_workers=mix["pipeline_workers"],
            pipeline_mode=mix["schedule"], device=ctx.device)

    def first_steps(self) -> dict:
        """Steps 1-3 through ``run(1)``; the readings the reference checks:
        losses, the momentum after step 1 (the clipped first gradient), the
        parameters' change after step 3 and the stores, as norms."""
        tr = self.trainer
        tr.run(1)
        grad = checks.norms(harness.flat(tr.opt_state["mom"]))
        tr.run(FIRST_STEPS - 1)
        p3 = harness.flat(tr.params)
        update = checks.norms({k: p3[k] - self.weights[k] for k in p3})
        store = checks.norms(
            {**{f"h.{l}": t for l, t in enumerate(tr.store.h)},
             **{f"v.{l}": t for l, t in enumerate(tr.store.v)}})
        return {"losses": [r["loss"] for r in tr.history[:FIRST_STEPS]],
                "grad": grad, "update": update, "store": store}

    def window(self, trace: bool) -> tuple:
        """Steps until ``seconds`` have passed; (window, step records)."""
        tr = self.trainer
        start = len(tr.history)
        with harness.Window(trace, self.ctx.device) as win:
            while time.perf_counter() - win.t0 < self.ctx.seconds:
                tr.run(1)
        return win, tr.history[start:]

    def batch_nodes(self, step: int) -> int:
        """Real batch nodes of step ``step`` (1-based), from the schedule."""
        cids = self.sampler.clusters_at(step - 1, mode=self.mix["schedule"])
        return int(self.part_sizes[cids].sum())

    def step_stats(self, step: int) -> tuple:
        """(batch rows, halo rows, edges) of step ``step`` as built."""
        cids = self.sampler.clusters_at(step - 1, mode=self.mix["schedule"])
        return self.counts[tuple(sorted(int(c) for c in cids))]

    def build_ms(self, first_step: int) -> list:
        """Host batch builds timed alone (sampler build + ELL bucketing)."""
        from repro_torch.core import host_batch
        out = []
        for k in range(BUILD_SAMPLES):
            cids = self.sampler.clusters_at(first_step + k,
                                            mode=self.mix["schedule"])
            t0 = time.perf_counter()
            host_batch(self.sampler.build_batch(cids),
                       backend=self.cfg["backend"])
            out.append(1e3 * (time.perf_counter() - t0))
        return out

    def close(self) -> None:
        """Stop the trainer's workers and free its device state."""
        self.trainer.close()
        self.trainer = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def reference_parts(cfg: dict, arrays: dict) -> np.ndarray:
    """The reference's own partition (cached once per checkout)."""
    return harness.cached_array(
        f"parts-{cfg['dataset']}-{cfg['num_parts']}",
        lambda: rgraph.partition(arrays["indptr"], arrays["indices"],
                                 cfg["num_parts"], seed=0))


def reference_readings(cfg: dict, mix: dict, arrays: dict, weights: dict,
                       seed: int, device, parts: np.ndarray,
                       tf32: bool = False) -> dict:
    """The reference's own first steps from the same weights and seed."""
    if mix["schedule"] != "epoch":
        raise ValueError("the reference follows the epoch schedule only")
    ref = RefLMC(cfg, arrays, weights, num_parts=cfg["num_parts"],
                 per_batch=cfg["clusters_per_batch"],
                 lr=cfg["optimizer"]["lr"], device=device, tf32=tf32)
    losses, grad, raw = [], None, None
    for i in range(FIRST_STEPS):
        cids = rgraph.epoch_clusters(harness.norm_seed(seed), i,
                                     cfg["num_parts"],
                                     cfg["clusters_per_batch"])
        nodes = np.concatenate([np.flatnonzero(parts == c) for c in cids])
        out = ref.step(nodes)
        losses.append(out["loss"])
        if i == 0:
            grad, raw = checks.norms(out["grad"]), checks.norms(out["raw"])
    update = checks.norms({k: ref.p[k] - weights[k] for k in ref.p})
    store = checks.norms(
        {**{f"h.{l}": t for l, t in enumerate(ref.H)},
         **{f"v.{l}": t for l, t in enumerate(ref.V)}})
    del ref
    return {"losses": losses, "grad": grad, "raw_grad": raw,
            "update": update, "store": store}


def run(ctx: harness.Ctx, plant=None) -> dict:
    """One run of the cell; ``plant(program)``, where given, breaks the
    timed path underneath first (``faults.py``)."""
    cfg = ctx.config
    arrays = harness.dataset(cfg["dataset"])
    prog = Program(ctx, arrays)
    if plant is not None:
        plant(prog)
    readings = prog.first_steps()
    cuda = ctx.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - ctx.t_start
    win, steps = prog.window(ctx.trace)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    peak = max(setup_peak, window_peak) if cuda else 0
    nodes = sum(prog.batch_nodes(r["step"]) for r in steps)
    prog.trainer.close()
    records = None
    if ctx.trace:
        records = {
            "kind": "train", "config": cfg, "steps": steps, "nodes": nodes,
            "window_s": win.window_s, "busy_s": win.busy_s,
            "device_ops": win.device_ops,
            "step_stats": [prog.step_stats(r["step"]) for r in steps],
            "peak_window_bytes": window_peak,
            "build_ms": prog.build_ms(steps[-1]["step"] if steps else 0)}
    weights = prog.weights   # the trainer copied them: still the initial
    prog.close()
    del prog
    ref = reference_readings(cfg, ctx.traffic, arrays, weights, ctx.seed,
                             ctx.device, reference_parts(cfg, arrays))
    numbers, _ = checks.train_numbers(readings, ref)
    correct, chk = harness.judge(numbers, cfg["limits"])
    return {"attempted": len(steps), "failed": 0, "correct": correct,
            "checks": chk,
            "e2e": {"train_nodes_per_s": nodes / win.window_s,
                    "train_peak_mem_gib": peak / 2**30, "setup_s": setup_s},
            "memory_peak_bytes": peak,
            "window": win, "records": records}
