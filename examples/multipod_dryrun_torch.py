"""Multi-pod dry run of the PyTorch port: trace one cell's step on meta
tensors over a fake process group of 256 or 512 ranks and print what one
device holds, computes and sends (``repro_torch.launch.dryrun``).

    PYTHONPATH=src python examples/multipod_dryrun_torch.py --device cpu \\
        --arch llama3.2-1b --shape train_4k --single-pod

``--mesh 1x1 --batch 2`` dry-runs another mesh shape and global batch
(e.g. one card's configuration). ``--gnn`` dry-runs the distributed GNN-LMC
cell instead (GCNII, 16M nodes, d = 512; ``launch.dryrun.run_gnn_cell``)
and writes ``build/dryrun_torch/gnn_lmc_<mesh>.json``. A CPU-sized cell (a reduced config):
``python -m repro_torch.launch.dryrun --device cpu --reduced --mesh 2x2x2
--batch 8 --seq 64 --arch llama3.2-1b``. Without ``--device`` the mesh is a CUDA
mesh, which needs a card.
"""
import argparse
import json


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--device", default=None,
                    help="mesh device type (default cuda; cpu without a card)")
    ap.add_argument("--mesh", default=None,
                    help="mesh shape, e.g. 1x1 or 2x16x16 (default: the "
                         "production mesh)")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: the shape's)")
    ap.add_argument("--json", action="store_true",
                    help="print the result as one JSON line")
    ap.add_argument("--gnn", action="store_true",
                    help="the distributed GNN-LMC cell on the production "
                         "mesh instead")
    args = ap.parse_args()
    from repro_torch.launch.dryrun import OUT_DIR, run_cell, run_gnn_cell
    if args.gnn:
        res = run_gnn_cell(multi_pod=not args.single_pod, device=args.device)
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        (OUT_DIR / f"gnn_lmc_{res['mesh']}.json").write_text(
            json.dumps(res, indent=1))
    else:
        mesh = (tuple(int(n) for n in args.mesh.split("x")) if args.mesh
                else None)
        res = run_cell(args.arch, args.shape, multi_pod=not args.single_pod,
                       device=args.device, mesh_shape=mesh,
                       global_batch=args.batch)
    if args.json:
        print(json.dumps(res))
    else:
        print("\nresult:", res)
    if res["status"] not in ("ok", "skipped"):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
