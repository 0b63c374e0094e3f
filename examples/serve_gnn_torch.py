"""GNN inference serving over the LMC historical store on the PyTorch port
(``repro_torch``), on the CUDA card by default. The counterpart of
``examples/serve_gnn.py``, with its flags and defaults plus ``--device``.

Trains the paper's GCN briefly with LMC, warms an exact embedding store from
the trained params, then serves paced classification requests through
``repro_torch.serve.GNNServer``: bounded admission queue, padded-shape bucket
batches, deadlines, and the exact→ti degradation ladder. ``--fault`` turns
on the serving fault drills (slow batch / poisoned store rows / worker
crash / queue-overflow burst) to watch the typed recovery paths fire.
``--seed`` seeds the graph, the model's initial weights (a
``torch.Generator``), the cluster sampler and the request stream.

    PYTHONPATH=src python examples/serve_gnn_torch.py --requests 64 --qps 100
    PYTHONPATH=src python examples/serve_gnn_torch.py --fault --requests 64
    PYTHONPATH=src python examples/serve_gnn_torch.py --backend ell
        # the CUDA SpMM and compensation kernels on the serving path
    PYTHONPATH=src python examples/serve_gnn_torch.py --device cpu
        # on the CPU (the kernels' plain PyTorch twins)
"""
import argparse
import time
from collections import Counter

import numpy as np
import torch

from repro_torch.core import LMC
from repro_torch.graph import ClusterSampler, make_sbm_dataset, partition_graph
from repro_torch.models import make_gnn
from repro_torch.optim import sgd
from repro_torch.serve import GNNServer, ServeConfig
from repro_torch.train import FaultPlan, GNNTrainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="ppi-cpu")
    ap.add_argument("--train-steps", type=int, default=100)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--qps", type=float, default=100.0)
    ap.add_argument("--max-targets", type=int, default=16)
    ap.add_argument("--backend", default="segment",
                    choices=("segment", "ell"))
    ap.add_argument("--deadline-s", type=float, default=2.0)
    ap.add_argument("--fault", action="store_true",
                    help="inject the serving fault classes mid-run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, failing "
                         "without one; 'cpu' runs the kernels' plain twins)")
    args = ap.parse_args()

    g = make_sbm_dataset(args.preset, seed=args.seed)
    print(f"graph: {g.num_nodes} nodes, {g.num_edges} directed edges, "
          f"{g.num_classes} classes")
    gnn = make_gnn("gcn", g.feature_dim, 64, g.num_classes, 3,
                   generator=torch.Generator().manual_seed(args.seed))
    parts = partition_graph(g, 16, seed=0)
    sampler = ClusterSampler(g, 16, 2, parts=parts, seed=args.seed)
    tr = GNNTrainer(gnn, LMC, g, sampler, sgd(lr=0.3), device=args.device)
    tr.run(args.train_steps)
    print(f"trained {args.train_steps} steps: "
          f"loss {tr.history[-1]['loss']:.3f}  "
          f"val acc {float(tr.eval('val')):.3f}")

    plan = None
    if args.fault:
        # Batch seqs run behind request indices (the batcher coalesces), so
        # schedule the batch-keyed faults early; the burst is request-keyed.
        plan = FaultPlan(serve_slow_at=(2,), serve_slow_s=0.5,
                         serve_poison_at=(4,),
                         serve_crash_at=(6,),
                         serve_burst_at=(args.requests // 2,),
                         serve_burst_n=48)

    cfg = ServeConfig(backend=args.backend,
                      default_deadline_s=args.deadline_s,
                      warmup=True)
    srv = GNNServer(gnn, g, tr.params, config=cfg, fault_plan=plan,
                    data=tr.data, device=args.device)
    print(f"server up: buckets {cfg.buckets}, queue depth {cfg.queue_depth}, "
          f"backend {cfg.backend}, device {srv.device}")

    rng = np.random.default_rng(args.seed)
    period = 1.0 / max(args.qps, 1e-9)
    futs = []
    t0 = time.time()
    for i in range(args.requests):
        n = int(rng.integers(1, args.max_targets + 1))
        nodes = rng.choice(g.num_nodes, size=n, replace=False)
        futs.append(srv.submit(nodes, request_id=f"r{i}"))
        if plan is not None:
            for j in range(plan.serve_burst(i)):
                futs.append(srv.submit(
                    rng.choice(g.num_nodes, size=4, replace=False),
                    request_id=f"burst{i}.{j}"))
        time.sleep(max(0.0, t0 + (i + 1) * period - time.time()))
    responses = [f.result(timeout=args.deadline_s + 60.0) for f in futs]
    wall = time.time() - t0

    lat = np.array([r.latency_s for r in responses if r.ok])
    counts = Counter(r.status for r in responses)
    print(f"\n{len(responses)} responses in {wall:.2f}s "
          f"({len(responses) / wall:.1f} rps)")
    print("status:", dict(sorted(counts.items())))
    if lat.size:
        print(f"latency p50 {np.percentile(lat, 50) * 1e3:.1f}ms  "
              f"p99 {np.percentile(lat, 99) * 1e3:.1f}ms")
    for r in responses:
        if r.status == "degraded":
            print(f"  degraded {r.request_id}: {r.degraded_reason}")
            break
    if srv.events:
        kinds = Counter(e["kind"] for e in srv.events)
        print("server events:", dict(sorted(kinds.items())))
    drained = srv.drain()
    st = srv.stats()
    print(f"drain clean: {drained}  pending after drain: {st['pending']}  "
          f"breaker: {st['breaker']}  "
          f"worker restarts: {st.get('worker_restarts', 0)}")


if __name__ == "__main__":
    main()
