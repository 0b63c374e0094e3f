"""Worker processes of the port's sharded-LM tests
(tests/test_torch_lm_sharded.py): one process per rank of a gloo group on
the CPU, all ranks on one ``DeviceMesh``, running every case of a job in
turn through ``launch.steps.build_cell``.

This module imports only torch, numpy and ``repro_torch``: the workers are
spawned, and a spawned child imports the module of its target, so nothing
here may pull in JAX.

A job is ``{"mesh": (shape, axes), "cases": [...]}``; every case carries
its reduced arch, config overrides, full f32 parameters and inputs as numpy
arrays. Rank 0 writes each case's results (full tensors, as numpy) to
``out/rank0.pt``.
"""
import dataclasses
import multiprocessing as mp
import time
import traceback
from pathlib import Path

import numpy as np
import torch

JOIN_S = 120.0   # a hung rank fails the test instead of stalling the run


def cfg_of(case: dict):
    from repro_torch.configs import reduced_config
    return dataclasses.replace(reduced_config(case["arch"]), **case["cfg"])


def tensors(tree):
    """numpy leaves -> torch tensors (a fresh copy each)."""
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def full(tree):
    """DTensor leaves -> full numpy arrays (a collective per leaf)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: full(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(full(v) for v in tree)
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    return tree.detach().float().numpy() if isinstance(tree, torch.Tensor) \
        else tree


def _train(case: dict, mesh) -> dict:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.sharding import activation_sharding, distribute
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import spec
    cfg = cfg_of(case)
    toks = case["batch"]["tokens"]
    shape = ShapeConfig("sharded_train", "train", toks.shape[1], toks.shape[0])
    lm, step, _, (p_sh, s_sh, b_sh) = build_cell(cfg, shape, mesh,
                                                 device="cpu")
    params = distribute(tensors(case["params"]), p_sh, mesh)
    state = spec.materialize(lm_opt_spec(lm, cfg), torch.Generator(), "cpu",
                             s_sh, mesh)
    batch = distribute(tensors(case["batch"]), b_sh, mesh)
    # the full-batch gradient, through the same activation constraints
    with activation_sharding(mesh):
        leaves = [p.detach().requires_grad_(True)
                  for _, p in spec.tree_leaves(params)]
        it = iter(leaves)
        loss = lm.train_loss(spec.tree_map(lambda _: next(it), params), batch)
        grads = torch.autograd.grad(loss, leaves)
    grads = {"/".join(p): g for (p, _), g in
             zip(spec.tree_leaves(params), grads)}
    new_params, _, metrics = step(params, state, batch)
    return {"loss": full(metrics["loss"]),
            "grad_norm": full(metrics["grad_norm"]),
            "grad_loss": full(loss), "grads": full(grads),
            "params": full(new_params)}


def lm_opt_spec(lm, cfg):
    from repro_torch.optim import make_optimizer
    return make_optimizer(cfg.optimizer).state_spec(lm.params_spec())


def _serve(case: dict, mesh) -> dict:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.sharding import distribute, named, dp_entry
    from repro_torch.launch.steps import (_with_act_sharding, build_cell,
                                          make_lm_prefill_step)
    cfg = cfg_of(case)
    toks, nxt = case["tokens"], case["next"]
    b, s = toks.shape
    shape = ShapeConfig("sharded_decode", "decode", case["max_seq"], b)
    lm, decode, _, (p_sh, c_sh, t_sh, _) = build_cell(cfg, shape, mesh,
                                                      device="cpu")
    prefill = _with_act_sharding(make_lm_prefill_step(lm, case["max_seq"]),
                                 mesh)
    params = distribute(tensors(case["params"]), p_sh, mesh)
    tok_sh = named(mesh, dp_entry(mesh) if b % _dp(mesh) == 0 else None,
                   None)
    logits, caches = prefill(params, distribute(torch.from_numpy(toks),
                                                tok_sh, mesh))
    out = {"prefill": full(logits), "caches": full(caches)}
    # decode from the plain prefill's caches, placed by cache_spec's rules
    plain = _map(lambda a: torch.from_numpy(a).to(torch.bfloat16),
                 case["caches"])
    caches = distribute(plain, c_sh, mesh)
    logits2, _ = decode(params, caches, distribute(torch.from_numpy(nxt),
                                                   t_sh, mesh),
                        torch.tensor(s, dtype=torch.int32))
    out["decode"] = full(logits2)
    return out


def _dp(mesh) -> int:
    from repro_torch.dist.sharding import dp_axis_size
    return dp_axis_size(mesh)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _run(rank: int, world: int, init_file: str, job: dict, out: str):
    import logging
    import torch.distributed as dist
    torch.set_num_threads(1)
    # DTensor warns at every two-axis reduction that it runs two collectives
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        from repro_torch.dist.mesh import make_mesh
        shape, axes = job["mesh"]
        mesh = make_mesh(shape, axes, device_type="cpu")
        results = {}
        for case in job["cases"]:
            run = _train if case["kind"] == "train" else _serve
            t0 = time.time()
            results[case["name"]] = run(case, mesh)
            results[case["name"]]["seconds"] = time.time() - t0
        if rank == 0:
            torch.save(results, Path(out) / "rank0.pt")
        dist.barrier()
    except BaseException:
        (Path(out) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def start_ranks(job: dict, tmp: Path):
    """Spawn one gloo rank per mesh device on ``job``; returns a function
    that joins them (terminating every rank past the deadline) and gives
    rank 0's results."""
    world = int(np.prod(job["mesh"][0]))
    ctx = mp.get_context("spawn")
    out = tmp / "out"
    out.mkdir()
    procs = [ctx.Process(target=_run, args=(r, world, str(tmp / "init"), job,
                                            str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    started = time.time()

    def join() -> dict:
        deadline = started + JOIN_S
        for p in procs:
            p.join(max(0.0, deadline - time.time()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
            p.join(10)
        errs = {f.name: f.read_text() for f in out.glob("*.err")}
        assert not alive, f"ranks still running after {JOIN_S} s: {errs}"
        assert all(p.exitcode == 0 for p in procs), \
            ([p.exitcode for p in procs], errs)
        return torch.load(out / "rank0.pt", weights_only=False)
    return join
