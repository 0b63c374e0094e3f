"""Serving cells: ``GNNServer.submit`` under an open loop of independent
clients.

Set-up builds the server from the seed's weights with an exact store
(``ServeConfig.warmup`` runs every bucket once) and sends a short warm-up
load. The window sends the seed's schedule (``loadgen.schedule``): each
request is submitted when it is due, whatever is still in flight, and
timed from its due time to its answer, so a stall delays the requests
behind it too. After the window every answer is awaited; every exact
answer's logits are then compared with the plain full-graph forward
(``reference/serve.py``).
"""
from __future__ import annotations

import gc
import math
import time
from functools import partial

import numpy as np
import torch

from perfbench import checks, harness, loadgen
from perfbench.reference.serve import full_logits

WARMUP_SEED_TAG = 0x3A6E
ANSWER_WAIT_S = 60.0    # wait past the window's close for late answers
MISSED_MS = 1e9         # a percentile that lands on a missed request


def _stamp(done: list, i: int, _fut) -> None:
    done[i] = time.perf_counter()


class Program:
    """The system under test for one seed: a ``GNNServer`` on the card."""

    def __init__(self, ctx: harness.Ctx, arrays: dict):
        from repro_torch.graph.structure import Graph
        from repro_torch.models import make_gnn
        from repro_torch.serve import GNNServer, ServeConfig

        cfg, mix = ctx.config, ctx.traffic
        self.ctx, self.cfg, self.mix = ctx, cfg, mix
        self.seed = harness.norm_seed(ctx.seed)
        self.graph = Graph(**arrays, name=cfg["dataset"])
        self.weights = harness.make_weights(cfg, self.seed, ctx.device)
        with torch.device("meta"):
            gnn = make_gnn(cfg["arch"], cfg["feature_dim"],
                           cfg["hidden_dim"], cfg["num_classes"],
                           cfg["num_layers"], alpha=cfg.get("alpha", 0.1),
                           lam=cfg.get("lam", 0.5))
        gnn.load_state_dict(self.weights, assign=True)
        scfg = ServeConfig(backend=cfg["backend"], warmup=True,
                           return_logits=True, **mix["serve_config"])
        self.server = GNNServer(gnn, self.graph, gnn.params(), config=scfg,
                                device=ctx.device)

    def send(self, due: np.ndarray, nodes: list) -> dict:
        """Open loop: submit each request at its due time; wait for all."""
        srv = self.server
        n = len(due)
        sent, done, futs = [0.0] * n, [None] * n, []
        t0 = time.perf_counter()
        for i in range(n):
            wait = t0 + due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            sent[i] = time.perf_counter()
            f = srv.submit(nodes[i], request_id=str(i))
            f.add_done_callback(partial(_stamp, done, i))
            futs.append(f)
        limit = time.perf_counter() + ANSWER_WAIT_S \
            + srv.config.default_deadline_s
        resp = []
        for f in futs:
            try:
                resp.append(f.result(timeout=max(0.0, limit
                                                  - time.perf_counter())))
            except TimeoutError:
                resp.append(None)
        return {"t0": t0, "due": due, "sent": sent, "done": done,
                "resp": resp}

    def close(self) -> None:
        """Drain and stop the server and free its device state."""
        self.server.close(drain=True)
        self.server = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def latencies_ms(out: dict) -> list:
    """Due time to answer, ms; a request not answered exactly is inf."""
    lat = []
    for i, r in enumerate(out["resp"]):
        ok = r is not None and r.status == "ok" and out["done"][i] is not None
        lat.append(1e3 * (out["done"][i] - out["t0"] - out["due"][i])
                   if ok else math.inf)
    return lat


def run(ctx: harness.Ctx, plant=None) -> dict:
    """One run of the cell; ``plant(program)``, where given, breaks the
    timed path underneath first (``faults.py``)."""
    cfg, mix = ctx.config, ctx.traffic
    arrays = harness.dataset(cfg["dataset"])
    n = arrays["indptr"].shape[0] - 1
    prog = Program(ctx, arrays)
    if plant is not None:
        plant(prog)
    due, nodes = loadgen.schedule(mix, prog.seed, ctx.seconds, n)
    prog.send(*loadgen.schedule(mix, prog.seed ^ WARMUP_SEED_TAG,
                                mix["warmup_s"], n))
    cuda = ctx.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    before = prog.server.stats()
    setup_s = time.perf_counter() - ctx.t_start
    with harness.Window(ctx.trace, ctx.device) as win:
        out = prog.send(due, nodes)
    after = prog.server.stats()
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    lat = latencies_ms(out)
    late = [1e3 * (s - out["t0"] - d) for s, d in zip(out["sent"], due)]
    batches = after["batches"] - before["batches"]
    records = None
    if ctx.trace:
        records = {"kind": "serve", "config": cfg,
                   "window_s": win.window_s, "busy_s": win.busy_s,
                   "device_ops": win.device_ops, "batches": batches,
                   "submitted": after["submitted"] - before["submitted"],
                   "late_ms": late}
    served = [(nodes[i], r.logits) for i, r in enumerate(out["resp"])
              if r is not None and r.status == "ok"]
    weights = prog.weights   # the server reads them, never writes
    prog.close()
    del prog
    ref = full_logits(cfg, arrays, weights, ctx.device)
    numbers = {"logits": checks.serve_number(served, ref)}
    correct, chk = harness.judge(numbers, cfg["limits"])

    def pct(q):
        v = harness.percentile(lat, q)
        return v if math.isfinite(v) else MISSED_MS

    return {"attempted": len(lat),
            "failed": sum(1 for v in lat if not math.isfinite(v)),
            "correct": correct, "checks": chk,
            "e2e": {"serve_p95_ms": pct(0.95), "serve_p50_ms": pct(0.50),
                    "setup_s": setup_s},
            "memory_peak_bytes": max(setup_peak, window_peak) if cuda else 0,
            "window": win, "records": records}
