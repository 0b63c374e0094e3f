"""Worker processes of the port's distributed-LMC tests
(tests/test_torch_distributed.py): one process per rank over a gloo group
on the CPU, each with its own cluster batch and its row blocks of the
stores, features and self-loop weights.

This module imports only torch, numpy, ``repro_torch`` and
``_torch_ranks``: the workers are spawned, and a spawned child imports the
module of its target, so nothing here may pull in JAX. Every rank beats its
heartbeat after each phase (``_torch_ranks``), so a slow rank is waited for
and a hung one fails.

The graph is the reference test's (tests/test_distributed.py): ``ppi-cpu``
(seed 3), 8 parts (partition seed 0), one cluster per rank (sampler seed 1),
GCN 2×32. Parameters and stores come from the caller as numpy arrays.
"""
import multiprocessing as mp
import traceback
from pathlib import Path

import numpy as np
import torch

from _torch_ranks import heartbeat, join_ranks

PARTS, HIDDEN, LAYERS, LR = 8, 32, 2, 0.3


def setup():
    """(graph, sampler, gnn, data) of the port, all on the CPU."""
    from repro_torch.core import from_graph
    from repro_torch.graph import (ClusterSampler, make_sbm_dataset,
                                   partition_graph)
    from repro_torch.models import make_gnn
    g = make_sbm_dataset("ppi-cpu", seed=3)
    sampler = ClusterSampler(g, PARTS, 1, parts=partition_graph(g, PARTS,
                                                                seed=0),
                             seed=1)
    gnn = make_gnn("gcn", g.feature_dim, HIDDEN, g.num_classes, LAYERS)
    return g, sampler, gnn, from_graph(g, device="cpu")


def batch_of(sampler, cluster: int):
    return sampler.build_batch(np.array([cluster]))


def _to_numpy(tree):
    from repro_torch.optim import tree_map
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _step_on_blocks(job, g, sampler, gnn, data, params, store):
    """One distributed step of this rank on its cluster; commits the owned
    rows into ``store`` (this rank's blocks). Returns (loss, grads,
    metrics)."""
    from repro_torch.core import LMC, host_batch
    from repro_torch.core.distributed import (commit_owned_rows,
                                              make_distributed_train_step)
    from repro_torch.dist import dp_axis_size, dp_rank, take_block
    world, rank = dp_axis_size(), dp_rank()
    n = g.num_nodes
    step = make_distributed_train_step(gnn, LMC, n, backend=job["backend"])
    batch = host_batch(batch_of(sampler, job["clusters"][rank]),
                       backend=job["backend"])
    loss, grads, owned, metrics = step(
        params, store, batch, take_block(data.x, 0, world, rank),
        take_block(data.self_w, 0, world, rank))
    commit_owned_rows(store, owned, n)
    return loss, grads, metrics


def _run(rank: int, world: int, init_file: str, job: dict, out: str):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        heartbeat(out, rank)
        from repro_torch.checkpoint import (CheckpointManager, reshard,
                                            unshard)
        from repro_torch.core import HistoricalState
        from repro_torch.dist import lmc_placement
        from repro_torch.optim import sgd
        from repro_torch.train import rescale_lmc_state
        g, sampler, gnn, data = setup()
        heartbeat(out, rank)
        n = g.num_nodes
        opt = sgd(lr=LR)
        if job["kind"] == "resume":
            # a whole-tree checkpoint of another world, resharded to this
            # one: params and momentum by reshard, the store by the elastic
            # rescale (its cold reinit: a zero block of the same shape)
            like = {"params": gnn.params(), "opt": opt.init(gnn.params()),
                    "store": (torch.zeros(1), torch.zeros(1))}
            tree, _, _ = CheckpointManager(job["ckpt"]).restore(like)
            whole = HistoricalState(*map(torch.from_numpy, tree["store"]))
            kw = dict(old_num_parts=2, new_num_parts=PARTS)
            _, store = rescale_lmc_state(g, whole, **kw)
            _, cold = rescale_lmc_state(g, whole, reuse_store=False, **kw)
            assert cold.h.shape == store.h.shape and not cold.h.any()
            rest = {"params": tree["params"], "opt": tree["opt"]}
            tree = reshard(rest, lmc_placement(rest), device="cpu")
        else:
            whole = {"params": job["params"], "opt": opt.init(gnn.params()),
                     "store": (job["h0"], job["v0"])}
            tree = reshard(whole, lmc_placement(whole), device="cpu")
            store = HistoricalState(*tree["store"])
        params, opt_state = tree["params"], tree["opt"]
        loss, grads, metrics = _step_on_blocks(job, g, sampler, gnn, data,
                                               params, store)
        heartbeat(out, rank)
        if job["kind"] == "save":
            params, opt_state, _ = opt.update(grads, opt_state, params, LR)
            state = {"params": params, "opt": opt_state,
                     "store": (store.h, store.v)}
            whole = unshard(state, lmc_placement(state), n)
            if rank == 0:
                CheckpointManager(job["ckpt"]).save(1, whole)
        torch.save({"loss": float(loss), "acc": float(metrics["train_acc"]),
                    "grads": _to_numpy(grads), "h": store.h.numpy(),
                    "v": store.v.numpy()}, Path(out) / f"rank{rank}.pt")
        dist.barrier()
    except BaseException:
        (Path(out) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, job: dict, tmp: Path) -> list:
    """Run ``job`` on ``world`` spawned gloo ranks; each rank's results, in
    rank order. Fails (terminating every rank) when a rank exits non-zero
    or none makes progress for ``_torch_ranks.JOIN_S`` seconds."""
    ctx = mp.get_context("spawn")
    out = tmp / f"out{world}_{job['kind']}"
    out.mkdir()
    procs = [ctx.Process(target=_run, args=(r, world, str(tmp / f"init{world}"
                                                          f"_{job['kind']}"),
                                            job, str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    join_ranks(procs, out)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]
