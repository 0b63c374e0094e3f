"""Quickstart on the PyTorch port: LMC vs GAS vs Cluster-GCN on a synthetic
ogbn-arxiv-like graph, on the CUDA card by default.

Trains the paper's GCN with each mini-batch method for a few hundred steps and
prints the validation-accuracy trajectory — the minimal version of the paper's
Figure 2. The counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py [--steps 300]
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import torch

from repro_torch.core import METHODS
from repro_torch.graph import ClusterSampler, make_sbm_dataset, partition_graph
from repro_torch.models import make_gnn
from repro_torch.optim import sgd
from repro_torch.train import GNNTrainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--preset", default="arxiv-cpu")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, failing "
                         "without one)")
    args = ap.parse_args()

    g = make_sbm_dataset(args.preset, seed=0)
    parts = partition_graph(g, 32, seed=0)
    print(f"graph: {g.num_nodes} nodes, {g.num_edges} directed edges, "
          f"{g.num_classes} classes")

    for name in ("lmc", "gas", "cluster"):
        m = METHODS[name]
        gnn = make_gnn("gcn", g.feature_dim, 128, g.num_classes, 2,
                       generator=torch.Generator().manual_seed(0))
        sampler = ClusterSampler(g, 32, 4, parts=parts, seed=1,
                                 include_halo=m.include_halo,
                                 edge_weight_mode=m.edge_weight_mode)
        tr = GNNTrainer(gnn, m, g, sampler, sgd(lr=0.3), device=args.device)
        print(f"\n=== {name} ===")
        for _ in range(args.steps // 50):
            tr.run(50)
            print(f"  step {tr.step_num:4d}  "
                  f"loss {tr.history[-1]['loss']:.3f}  "
                  f"val acc {tr.eval('val'):.3f}")
        print(f"  final test acc: {tr.eval('test'):.3f}")


if __name__ == "__main__":
    main()
