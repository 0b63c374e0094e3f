"""End-to-end LMC training on the PyTorch port (``repro_torch``), on the CUDA
card by default: checkpointing, fault tolerance, the hand-written CUDA
SpMM/compensation kernels and the async sampling pipeline, with periodic
evaluation. The counterpart of ``examples/train_gnn.py``, with its flags and
defaults plus ``--device``.

    PYTHONPATH=src python examples/train_gnn_torch.py --steps 400 --preset arxiv-cpu
    PYTHONPATH=src python examples/train_gnn_torch.py --preset arxiv-like   # 169k nodes
    PYTHONPATH=src python examples/train_gnn_torch.py --backend ell
        # the CUDA bucketed-ELL SpMM and compensation kernels on the hot path
    PYTHONPATH=src python examples/train_gnn_torch.py --backend ell --no-stream
        # the resident-source kernels (graphs under ~14.5k rows)
    PYTHONPATH=src python examples/train_gnn_torch.py --prefetch 4 --recycle 4
        # async sampling pipeline + minibatch recycling (DESIGN.md §9)
    PYTHONPATH=src python examples/train_gnn_torch.py --health --async-ckpt
        # numerical-health supervisor + background checkpoint writes
    PYTHONPATH=src python examples/train_gnn_torch.py --device cpu --preset ppi-cpu
        # on the CPU (the kernels' plain PyTorch twins)
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.core import METHODS
from repro_torch.graph import ClusterSampler, make_sbm_dataset, partition_graph
from repro_torch.models import make_gnn
from repro_torch.optim import sgd
from repro_torch.train import GNNTrainer, HealthConfig


def main():
    ap = argparse.ArgumentParser(
        description="End-to-end LMC GNN training on the PyTorch port "
                    "(checkpointing, fault tolerance, CUDA kernel path, "
                    "async sampling pipeline)")
    ap.add_argument("--steps", type=int, default=400,
                    help="total train steps (resumes from checkpoint if any)")
    ap.add_argument("--preset", default="arxiv-cpu",
                    help="synthetic dataset preset, e.g. arxiv-cpu (4k nodes) "
                         "or arxiv-like (169k); see repro_torch.graph."
                         "DATASET_PRESETS")
    ap.add_argument("--arch", default="gcnii", choices=["gcn", "gcnii",
                                                        "sage", "gin", "gat"],
                    help="GNN architecture")
    ap.add_argument("--heads", type=int, default=4,
                    help="GAT: attention heads of each hidden layer, "
                         "concatenated (--hidden must be a multiple)")
    ap.add_argument("--out-heads", type=int, default=6,
                    help="GAT: attention heads of the last layer, averaged")
    ap.add_argument("--method", default=None, choices=list(METHODS),
                    help="mini-batch method: lmc, gas, cluster, ti, or the "
                         "compensation ablations (default: ti when "
                         "--backend ti, else lmc)")
    ap.add_argument("--hidden", type=int, default=128,
                    help="hidden width of every GNN layer")
    ap.add_argument("--layers", type=int, default=4,
                    help="number of GNN layers")
    ap.add_argument("--parts", type=int, default=32,
                    help="graph partition count B (clusters)")
    ap.add_argument("--clusters-per-batch", type=int, default=4,
                    help="clusters c sampled per mini-batch (Alg. 1 line 4)")
    ap.add_argument("--backend", default="segment",
                    choices=["segment", "ell", "ti"],
                    help="aggregation/compensation hot path: plain PyTorch "
                         "gather + index_add_, the CUDA bucketed-ELL SpMM "
                         "and compensation kernels, or ti = ELL aggregation "
                         "+ store-free message-invariance compensation")
    ap.add_argument("--stream", default=None, action="store_true",
                    help="the streaming kernels for --backend ell|ti (the "
                         "default)")
    ap.add_argument("--no-stream", dest="stream", action="store_false",
                    help="the resident-source kernels, which stage the whole "
                         "gather source in shared memory (small graphs only)")
    ap.add_argument("--prefetch", type=int, default=2, metavar="N",
                    help="async sampling pipeline queue depth: background "
                         "threads build + bucket the next N batches into "
                         "pinned memory while the device steps, the copy to "
                         "the card on a side stream; 0 keeps the "
                         "schedule-indexed stream but builds synchronously")
    ap.add_argument("--no-prefetch", dest="prefetch", action="store_const",
                    const=None,
                    help="fully synchronous sampling (stateful sampler RNG, "
                         "no pipeline)")
    ap.add_argument("--recycle", type=int, default=1, metavar="R",
                    help="minibatch recycling: reuse each sampled subgraph "
                         "for R consecutive steps before resampling")
    ap.add_argument("--pipeline-workers", type=int, default=2, metavar="W",
                    help="builder threads for the sampling pipeline")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_gnn_ckpt"),
                    help="checkpoint directory (delete it for a fresh run)")
    ap.add_argument("--health", action="store_true",
                    help="enable the numerical-health guard (NaN/Inf + "
                         "loss-spike checks with staleness accounting)")
    ap.add_argument("--health-policy", default="rollback",
                    choices=["rollback", "skip-batch"],
                    help="recovery policy on a divergent step: roll back to "
                         "the newest verifiable checkpoint, or drop the "
                         "poisoned update and continue")
    ap.add_argument("--lr-backoff", type=float, default=1.0, metavar="F",
                    help="multiply the lr by F on every health rollback "
                         "(1.0 = keep lr)")
    ap.add_argument("--max-retries", type=int, default=3, metavar="N",
                    help="consecutive recovery actions (rollbacks / skips / "
                         "pipeline rebuilds) allowed before the run aborts "
                         "with TrainingDivergedError")
    ap.add_argument("--async-ckpt", action="store_true",
                    help="write checkpoints on a background thread (the "
                         "train step only pays the device->host snapshot; "
                         "files are byte-identical to synchronous saves)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, failing "
                         "without one; 'cpu' runs the kernels' plain twins)")
    args = ap.parse_args()
    if args.prefetch is None and args.recycle > 1:
        ap.error("--no-prefetch is incompatible with --recycle > 1 "
                 "(recycling needs the schedule-indexed pipeline)")

    t0 = time.time()
    g = make_sbm_dataset(args.preset, seed=0)
    parts = partition_graph(g, args.parts, seed=0)
    print(f"[{time.time()-t0:6.1f}s] graph {g.num_nodes}n/{g.num_edges}e, "
          f"partitioned into {args.parts}")

    if args.method is None:
        args.method = "ti" if args.backend == "ti" else "lmc"
    m = METHODS[args.method]
    gnn = make_gnn(args.arch, g.feature_dim, args.hidden, g.num_classes,
                   args.layers, heads=args.heads, out_heads=args.out_heads,
                   generator=torch.Generator().manual_seed(0))
    sampler = ClusterSampler(g, args.parts, args.clusters_per_batch,
                             parts=parts, seed=1,
                             include_halo=m.include_halo,
                             edge_weight_mode=m.edge_weight_mode)
    health = (HealthConfig(policy=args.health_policy,
                           lr_backoff=args.lr_backoff)
              if args.health else None)
    tr = GNNTrainer(gnn, m, g, sampler, sgd(lr=0.2),
                    ckpt_dir=args.ckpt_dir, ckpt_every=100,
                    backend=args.backend, stream=args.stream,
                    prefetch=args.prefetch, recycle=args.recycle,
                    pipeline_workers=args.pipeline_workers,
                    health=health, max_retries=args.max_retries,
                    async_ckpt=args.async_ckpt, device=args.device)
    try:
        if tr.restore():
            print(f"resumed from checkpoint at step {tr.step_num}")
        while tr.step_num < args.steps:
            tr.run(min(50, args.steps - tr.step_num))
            h = tr.history[-1]
            print(f"[{time.time()-t0:6.1f}s] step {tr.step_num:5d} "
                  f"loss {h['loss']:.4f} train_acc {h['train_acc']:.3f} "
                  f"val {tr.eval('val'):.3f}")
        tr.save()
    finally:
        tr.close()   # stop pipeline workers, join the checkpoint writer
    print(f"done: test acc {tr.eval('test'):.4f}; "
          f"checkpoints in {args.ckpt_dir}")


if __name__ == "__main__":
    main()
