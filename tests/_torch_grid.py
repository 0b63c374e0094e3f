"""Worker processes of the port's grid tests
(tests/test_torch_distributed_grid.py): one process per rank of a
``data`` × ``model`` gloo mesh on the CPU. Rank (r, c) holds row block r of
feature block c of the stores, row block r of ``x`` and ``self_w``, and
data rank r's own cluster batch.

This module imports only torch, numpy, ``repro_torch`` and the JAX-free
helpers ``_torch_dist`` and ``_torch_ranks``: the workers are spawned, and
a spawned child imports the module of its target. Every rank beats its
heartbeat after each phase, so a slow rank is waited for and a hung one
fails.
"""
import multiprocessing as mp
import traceback
from pathlib import Path

import torch

from _torch_dist import LR, _to_numpy, batch_of, setup
from _torch_ranks import heartbeat, join_ranks


def _step(job, sampler, gnn, n, mine, rows, feats, r, clusters):
    """One grid step (a row step when ``feats`` is None) of data rank
    ``r`` on cluster ``clusters[r]`` and this rank's share ``mine``;
    commits the owned rows into its store. Returns (loss, grads, acc,
    store)."""
    from repro_torch.core import LMC, HistoricalState, host_batch
    from repro_torch.core.distributed import (commit_owned_rows,
                                              make_distributed_train_step)
    store = HistoricalState(*mine["store"])
    step = make_distributed_train_step(gnn, LMC, n, group=rows,
                                       model_group=feats,
                                       backend=job["backend"])
    batch = host_batch(batch_of(sampler, clusters[r]),
                       backend=job["backend"])
    loss, grads, owned, m = step(mine["params"], store, batch, mine["x"],
                                 mine["self_w"])
    commit_owned_rows(store, owned, n, group=rows)
    return loss, grads, float(m["train_acc"]), store


def _result(loss, grads, acc, store) -> dict:
    return {"loss": float(loss), "grads": _to_numpy(grads), "acc": acc,
            "h": store.h.numpy(), "v": store.v.numpy()}


def _run(rank: int, world: int, init_file: str, job: dict, out: str):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        heartbeat(out, rank)
        from repro_torch.checkpoint import (CheckpointManager, reshard,
                                            unshard)
        from repro_torch.dist import dp_rank, lmc_placement
        from repro_torch.dist.mesh import grid_groups, make_mesh
        from repro_torch.optim import sgd
        g, sampler, gnn, data = setup()
        mesh = make_mesh(job["grid"], ("data", "model"), device_type="cpu")
        rows, feats = grid_groups(mesh)
        r, c = dp_rank(rows), dp_rank(feats)
        n, opt = g.num_nodes, sgd(lr=LR)
        heartbeat(out, rank)
        whole = {"params": job["params"], "opt": opt.init(gnn.params()),
                 "store": (job["h0"], job["v0"]), "x": data.x,
                 "self_w": data.self_w}
        grid = lmc_placement(whole, features=True)
        mine = reshard(whole, grid, group=rows, model_group=feats,
                       device="cpu")
        loss, grads, acc, store = _step(job, sampler, gnn, n, mine, rows,
                                        feats, r, job["clusters"])
        res = dict(_result(loss, grads, acc, store), coords=(r, c))
        heartbeat(out, rank)
        if job.get("row_step"):   # the 1-D step of the same data ranks
            row = reshard(whole, lmc_placement(whole), group=rows,
                          device="cpu")
            res["row"] = _result(*_step(job, sampler, gnn, n, row, rows,
                                        None, r, job["clusters"]))
            heartbeat(out, rank)
        if "ckpt_in" in job:   # a whole tree saved under another grid
            like = {"params": gnn.params(), "opt": opt.init(gnn.params()),
                    "store": (torch.zeros(1), torch.zeros(1))}
            saved, _, _ = CheckpointManager(job["ckpt_in"]).restore(like)
            saved = dict(saved, x=data.x, self_w=data.self_w)
            back = reshard(saved, grid, group=rows, model_group=feats,
                           device="cpu")
            res["resume"] = _result(*_step(job, sampler, gnn, n, back, rows,
                                           feats, r, job["resume"]))
            heartbeat(out, rank)
        if "ckpt_out" in job:
            params, opt_state, _ = opt.update(grads, mine["opt"],
                                              mine["params"], LR)
            state = {"params": params, "opt": opt_state,
                     "store": (store.h, store.v)}
            full = unshard(state, lmc_placement(state, features=True), n,
                           group=rows, model_group=feats,
                           num_features=gnn.hidden_dim)
            if dist.get_rank() == 0:
                CheckpointManager(job["ckpt_out"]).save(1, full)
        torch.save(res, Path(out) / f"rank{rank}.pt")
        dist.barrier()
    except BaseException:
        (Path(out) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_grid(grid: tuple, job: dict, tmp: Path, name: str = "") -> list:
    """Run ``job`` on the ``grid`` = (data, model) mesh of spawned gloo
    ranks (files under ``tmp`` named by the grid and ``name``); each rank's
    results, in rank order (rank r·model + c is (r, c)).
    Fails (terminating every rank) when a rank exits non-zero or none makes
    progress for ``_torch_ranks.JOIN_S`` seconds."""
    world = grid[0] * grid[1]
    tag = "x".join(map(str, grid)) + name
    ctx = mp.get_context("spawn")
    out = tmp / f"out{tag}"
    out.mkdir()
    job = dict(job, grid=tuple(grid))
    procs = [ctx.Process(target=_run, args=(r, world, str(tmp / f"init{tag}"),
                                            job, str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    join_ranks(procs, out)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]
