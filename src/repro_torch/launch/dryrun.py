"""Dry run: trace one step of every (arch × shape × mesh) cell on meta
tensors over a fake process group, and tally what one device would hold,
compute and send.

The counterpart of ``repro.launch.dryrun``. Where the reference lowers and
compiles each cell for 256 or 512 placeholder XLA devices, the port starts
a ``"fake"`` process group of that many ranks in this one process (rank 0),
builds the cell's arguments as DTensors over *meta* local shards
(``launch.steps.build_cell``) and runs the step eagerly, under autograd for
``train``: every DTensor op runs on rank 0's meta shards and every
collective is a meta op, so nothing is allocated and nothing is sent.
Meta local tensors, not ``FakeTensorMode``, which fails on redistributing a
tensor sharded on two mesh axes.

For rank 0 it records (one JSON per cell under ``build/dryrun_torch/``):
  * argument and output bytes: the local bytes of every argument / output;
  * peak bytes: the most local storage alive at once during the step
    (arguments included), tallied by a dispatch mode over every op's
    outputs, each storage counted once until it is freed;
  * FLOPs: ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s)
    over the local ops, so per device and with remat's recomputation;
  * collectives: count and output bytes per kind, from the
    ``_c10d_functional`` ops the redistributions issue and the ``c10d``
    ops of ``torch.distributed``'s own collectives (the GNN step's);
  * the wall time of the traced step.

Run:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
      --arch llama3.2-1b --shape train_4k --single-pod

The GNN cell (``--gnn``, :func:`run_gnn_cell`) is the reference's: the
distributed LMC step of GCNII (16·2^20 nodes, d = 512, 4 layers) on the
production mesh, rows over the pod×data ranks and the stores' features over
``model`` (``core.distributed.make_distributed_train_step`` on the grid's
two groups), one subgraph of 4096 batch rows, 8192 halo rows and 262,144
edges per data rank. Its row exchanges depend on the gids, which meta
tensors do not hold: the cell gives them a uniform owner spread (each of
the ndp owners serves 1/ndp of the rows), so it traces what one device
holds and sends, not what a given batch asks.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"

# functional collectives -> the reference's HLO kind names
_KINDS = {"all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "all_to_all_single": "all-to-all"}
_NAMESPACES = ("_c10d_functional", "c10d_functional")
# torch.distributed's own collectives (in place into their first argument)
_C10D_KINDS = {"allgather_": "all-gather", "allgather_into_tensor_coalesced_":
               "all-gather", "_allgather_base_": "all-gather",
               "reduce_scatter_": "reduce-scatter",
               "_reduce_scatter_base_": "reduce-scatter",
               "allreduce_": "all-reduce",
               "allreduce_coalesced_": "all-reduce",
               "alltoall_base_": "all-to-all", "alltoall_": "all-to-all"}


def _nbytes(t: torch.Tensor) -> int:
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size()


def tree_nbytes(tree) -> int:
    """Local bytes of every tensor leaf of a (dict / list / tuple) tree."""
    leaves, _ = tree_flatten(tree)
    return sum(_nbytes(t) for t in leaves if isinstance(t, torch.Tensor))


class Tally(TorchDispatchMode):
    """Per-device FLOPs, collectives and live storage of the local ops.

    A DTensor op is handed back to DTensor (``NotImplemented``), which
    redistributes and runs it on the local shards: those local ops, and
    the collectives, come back through this mode and are counted here.
    The fake tensors of DTensor's own shape propagation (global shapes,
    under ``FakeTensorMode``) are not counted.
    """

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.collectives: dict = {}
        self.live = 0
        self.peak = 0
        self._seen: set = set()

    def hold(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as live from now."""
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                self._track(t.to_local() if isinstance(t, DTensor) else t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in tree_flatten(out)[0]):
            return out    # DTensor's shape propagation, on global shapes
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        ns, name = func.namespace, packet.__name__
        kind = (_KINDS.get(name) if ns in _NAMESPACES
                else _C10D_KINDS.get(name) if ns == "c10d" else None)
        if kind is not None:
            # a functional collective returns its output; a c10d one
            # writes into its first argument
            outs = tree_flatten(out if ns in _NAMESPACES else args[0])[0]
            self.collectives[kind] = self.collectives.get(kind, 0) + sum(
                _nbytes(t) for t in outs if isinstance(t, torch.Tensor))
            self.collectives["num_ops"] = self.collectives.get("num_ops",
                                                               0) + 1
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out


def _skip_reason(cfg, shape) -> str:
    return ("no decoder" if shape.kind == "decode" and not cfg.has_decoder
            else "full-attention arch: long_500k requires sub-quadratic "
                 "attention (DESIGN.md §5)")


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             device: Optional[str] = None, mesh_shape=None,
             global_batch: Optional[int] = None,
             seq_len: Optional[int] = None, reduced: bool = False,
             verbose: bool = True) -> dict:
    """Dry-run one cell on the production mesh (or ``mesh_shape``, a
    ``(data, model)`` or ``(pod, data, model)`` shape) in a fake world of
    as many ranks. ``device`` is the mesh's device type (default
    ``"cuda"``: pass ``"cpu"`` without a card). ``global_batch`` and
    ``seq_len`` override the shape's; ``reduced`` takes the arch's reduced
    config (``configs.reduced_config``)."""
    import dataclasses

    from repro_torch.configs import (SHAPES, applicable_shapes, get_config,
                                     reduced_config)
    from repro_torch.dist.mesh import fake_world, make_mesh
    from repro_torch.launch.steps import build_cell

    cfg = (reduced_config if reduced else get_config)(arch)
    shape = SHAPES[shape_name]
    if shape_name not in applicable_shapes(cfg):
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": _skip_reason(cfg, shape)}
    if global_batch is not None:
        shape = dataclasses.replace(shape, global_batch=int(global_batch))
    if seq_len is not None:
        shape = dataclasses.replace(shape, seq_len=int(seq_len))
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    mesh_shape = tuple(int(n) for n in mesh_shape)
    axes = ("pod", "data", "model")[-len(mesh_shape):]
    tag = "x".join(map(str, mesh_shape))
    world = 1
    for n in mesh_shape:
        world *= n
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the dry run builds a CUDA "
                           "mesh by default; pass device='cpu'")
    with fake_world(world):
        mesh = make_mesh(mesh_shape, axes, device_type=device or "cuda")
        t0 = time.time()
        lm, step, args, _ = build_cell(cfg, shape, mesh, device="meta")
        t_build = time.time() - t0
        tally = Tally()
        tally.hold(args)
        t0 = time.time()
        with tally:
            out = step(*args)
        t_step = time.time() - t0
        arg_bytes, out_bytes = tree_nbytes(args), tree_nbytes(out)
        del out
    res = {
        "arch": arch, "shape": shape_name, "mesh": tag,
        "multi_pod": multi_pod, "status": "ok",
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
        "build_s": round(t_build, 3), "step_s": round(t_step, 3),
        "flops": tally.flops, "collectives": dict(tally.collectives),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "peak_bytes": tally.peak},
    }
    res["collectives"]["total"] = sum(
        v for k, v in tally.collectives.items() if k != "num_ops")
    if verbose:
        print(f"[{tag}] {arch} × {shape_name}: traced in {t_step:.1f} s, "
              f"args {arg_bytes / 2**30:.3f} GiB/dev, peak "
              f"{tally.peak / 2**30:.3f} GiB/dev, flops {tally.flops:.4e}, "
              f"collective ops {tally.collectives.get('num_ops', 0)}",
              flush=True)
    return res


GNN_NODES = 16 * 2**20
GNN_DIMS = dict(dx=512, d=512, layers=4, classes=64)
GNN_PER_RANK = dict(batch=4096, halo=8192, edges=262144)


def run_gnn_cell(*, multi_pod: bool, device: Optional[str] = None,
                 num_nodes: int = GNN_NODES, verbose: bool = True) -> dict:
    """Dry-run the paper's own workload, the reference's ``run_gnn_cell``:
    the distributed LMC train step of GCNII (``GNN_DIMS``, ``num_nodes``
    nodes) on the production mesh (16×16, or 2×16×16 with ``multi_pod``)
    in a fake world of as many ranks, traced on meta tensors. Rank 0 holds
    row block 0 of feature block 0 of the stores, row block 0 of ``x`` and
    ``self_w``, the replicated parameters and its data rank's subgraph
    (``GNN_PER_RANK``, ``backend="segment"``). ``device`` is the mesh's
    device type (default ``"cuda"``)."""
    from repro_torch.core import LMC, HistoricalState
    from repro_torch.core.distributed import make_distributed_train_step
    from repro_torch.core.lmc import Batch
    from repro_torch.dist.mesh import (fake_world, grid_groups,
                                       make_production_mesh)
    from repro_torch.dist.sharding import dp_axis_size, dp_rank, row_block
    from repro_torch.models import make_gnn
    from repro_torch.optim import tree_map

    if device is None and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the dry run builds a CUDA "
                           "mesh by default; pass device='cpu'")
    n, (dx, d, L, ncls) = num_nodes, GNN_DIMS.values()
    tag = "2x16x16" if multi_pod else "16x16"
    gnn = make_gnn("gcnii", dx, d, ncls, L)
    params = tree_map(lambda t: torch.empty_like(t, device="meta"),
                      gnn.params())

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=device or "cuda")
        rows, feats = grid_groups(mesh)
        ndp, nm = dp_axis_size(rows), dp_axis_size(feats)
        a, b = row_block(n, ndp, dp_rank(rows))
        p, q = row_block(d, nm, dp_rank(feats))
        nb, nh, ne = GNN_PER_RANK.values()
        batch = Batch(
            batch_gids=i32(nb), halo_gids=i32(nh), batch_mask=f32(nb),
            halo_mask=f32(nh), edge_src=i32(ne), edge_dst=i32(ne),
            edge_w=f32(ne), labels=i32(nb + nh), labeled_mask=f32(nb + nh),
            beta=f32(nh), loss_scale=f32(), grad_scale=f32())
        store = HistoricalState(h=f32(L, b - a, q - p),
                                v=f32(L - 1, b - a, q - p))
        args = (params, store, batch, f32(b - a, dx), f32(b - a))
        # a uniform owner spread: every owner serves 1/ndp of the rows
        splits = ([(nb + nh) // ndp] * ndp, [nb // ndp] * ndp)
        step = make_distributed_train_step(
            gnn, LMC, n, group=rows, model_group=feats, backend="segment",
            splits=splits)
        tally = Tally()
        tally.hold(args)
        t0 = time.time()
        with tally:
            out = step(*args)
        t_step = time.time() - t0
        arg_bytes, out_bytes = tree_nbytes(args), tree_nbytes(out)
        del out
    res = {
        "arch": "gnn-lmc-gcnii", "shape": f"n{n}_d{d}_L{L}", "mesh": tag,
        "multi_pod": multi_pod, "status": "ok", "step_s": round(t_step, 3),
        "flops": tally.flops, "collectives": dict(tally.collectives),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "peak_bytes": tally.peak},
    }
    res["collectives"]["total"] = sum(
        v for k, v in tally.collectives.items() if k != "num_ops")
    if verbose:
        print(f"[GNN {tag}] LMC distributed step: traced in {t_step:.1f} s, "
              f"args {arg_bytes} B/dev, peak {tally.peak} B/dev, flops "
              f"{tally.flops:.4e}, collectives {res['collectives']}",
              flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="only the 2x16x16 mesh (default: both meshes)")
    ap.add_argument("--single-pod", action="store_true",
                    help="only the 16x16 mesh")
    ap.add_argument("--gnn", action="store_true",
                    help="the distributed GNN-LMC cell (alone unless --arch "
                         "or --shape is given)")
    ap.add_argument("--device", default=None,
                    help="mesh device type (default cuda; cpu without a card)")
    ap.add_argument("--mesh", default=None,
                    help="one mesh shape instead, e.g. 2x2x2")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: the shape's)")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default: the shape's)")
    ap.add_argument("--reduced", action="store_true",
                    help="the archs' reduced (CPU-sized) configs")
    ap.add_argument("--out", default=str(OUT_DIR),
                    help="directory of the per-cell JSON files")
    ap.add_argument("--fail-fast", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCH_NAMES, SHAPES

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else ARCH_NAMES
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True]
    if args.multi_pod:
        meshes = [True]
    if args.single_pod:
        meshes = [False]
    mesh_shape = (tuple(int(n) for n in args.mesh.split("x")) if args.mesh
                  else None)
    if mesh_shape is not None:
        meshes = [len(mesh_shape) == 3]
    failures = []
    lm_cells = not args.gnn or args.arch is not None or args.shape is not None
    for multi_pod in meshes:
        if args.gnn:
            tag = f"gnn_lmc_{'2x16x16' if multi_pod else '16x16'}"
            try:
                res = run_gnn_cell(multi_pod=multi_pod, device=args.device)
            except Exception as e:  # noqa: BLE001 - report, keep sweeping
                res = {"arch": "gnn-lmc-gcnii", "multi_pod": multi_pod,
                       "status": "error", "error": repr(e),
                       "trace": traceback.format_exc()[-2000:]}
                failures.append(tag)
                print(f"FAIL {tag}: {e!r}", flush=True)
            (out_dir / f"{tag}.json").write_text(json.dumps(res, indent=1))
        if not lm_cells:
            continue
        for arch in archs:
            for shape in shapes:
                mesh_tag = args.mesh or ("2x16x16" if multi_pod else "16x16")
                tag = f"{arch}_{shape}_{mesh_tag}"
                try:
                    res = run_cell(arch, shape, multi_pod=multi_pod,
                                   device=args.device, mesh_shape=mesh_shape,
                                   global_batch=args.batch,
                                   seq_len=args.seq, reduced=args.reduced)
                except Exception as e:  # noqa: BLE001 - report, keep sweeping
                    res = {"arch": arch, "shape": shape,
                           "multi_pod": multi_pod, "status": "error",
                           "error": repr(e),
                           "trace": traceback.format_exc()[-2000:]}
                    failures.append(tag)
                    print(f"FAIL {tag}: {e!r}", flush=True)
                (out_dir / f"{tag}.json").write_text(json.dumps(res, indent=1))
                if failures and args.fail_fast:
                    return 1
    print(f"\ndry-run complete; failures: {failures or 'none'}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
