"""Worker processes of the port's sharded-LM tests
(tests/test_torch_lm_sharded.py): one process per rank of a gloo group on
the CPU, all ranks on one ``DeviceMesh``, running every case of a job in
turn through ``launch.steps.build_cell``.

This module imports only torch, numpy, ``repro_torch`` and
``_torch_ranks``: the workers are spawned, and a spawned child imports the
module of its target, so nothing here may pull in JAX.

A job is ``{"mesh": (shape, axes), "cases": [...]}``; every case carries
its reduced arch, config overrides, full f32 parameters and inputs as numpy
arrays. Rank 0 writes each case's results (full tensors, as numpy) to
``out/rank0.pt``, and under ``"stacks"`` what :class:`StackProbe` saw of
the ``torch.stack`` calls on DTensors. Every rank beats its heartbeat
after each phase of a case (``_torch_ranks``), so a slow rank is waited
for and a hung one fails.
"""
import dataclasses
import multiprocessing as mp
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from _torch_ranks import heartbeat, join_ranks


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


def opt_of(case: dict):
    """The case's optimizer: its config's, or Adafactor with the case's
    ``stream_bytes``."""
    from repro_torch.optim import adafactor, make_optimizer
    if "stream_bytes" in case:
        return adafactor(stream_bytes=case["stream_bytes"])
    return make_optimizer(cfg_of(case).optimizer)


def _train(case: dict, mesh, beat) -> dict:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.sharding import activation_sharding, distribute
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import spec
    cfg, opt = cfg_of(case), opt_of(case)
    toks = case["batch"]["tokens"]
    shape = ShapeConfig("sharded_train", "train", toks.shape[1], toks.shape[0])
    lm, step, _, (p_sh, s_sh, b_sh) = build_cell(cfg, shape, mesh,
                                                 device="cpu", opt=opt)
    params = distribute(tensors(case["params"]), p_sh, mesh)
    state = spec.materialize(opt.state_spec(lm.params_spec()),
                             torch.Generator(), "cpu", s_sh, mesh)
    batch = distribute(tensors(case["batch"]), b_sh, mesh)
    beat()
    # the full-batch gradient, through the same activation constraints
    with activation_sharding(mesh):
        leaves = [p.detach().requires_grad_(True)
                  for _, p in spec.tree_leaves(params)]
        it = iter(leaves)
        loss = lm.train_loss(spec.tree_map(lambda _: next(it), params), batch)
        grads = torch.autograd.grad(loss, leaves)
    out = {}
    if "stream_bytes" in case:
        # the update alone on that gradient, placed as its parameters: the
        # elements it all-gathers
        it = iter(g.redistribute(p.device_mesh, p.placements)
                  for g, p in zip(grads, leaves))
        with GatherProbe() as gathered:
            opt.update(spec.tree_map(lambda _: next(it), params), state,
                       params, opt.lr)
        out = {"update_gathered": gathered.n,
               "stats_numel": sum(t.numel() for k in ("vr", "vc")
                                  for _, t in spec.tree_leaves(state[k]))}
    grads = {"/".join(p): g for (p, _), g in
             zip(spec.tree_leaves(params), grads)}
    beat()
    new_params, _, metrics = step(params, state, batch)
    return {"loss": full(metrics["loss"]),
            "grad_norm": full(metrics["grad_norm"]),
            "grad_loss": full(loss), "grads": full(grads),
            "params": full(new_params), **out}


def _serve(case: dict, mesh, beat) -> dict:
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
    beat()
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


def GatherProbe():
    """A dispatch mode that counts, in ``.n``, the elements this rank
    all-gathers (the local tensors DTensor's redistributions hand to the
    collective)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Probe(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(t is DTensor for t in types):
                return NotImplemented   # let DTensor lower to collectives
            if "all_gather" in str(func):
                self.n += args[0].numel()
            return func(*args, **(kwargs or {}))
    return Probe()


class StackProbe:
    """While active, records every ``torch.stack`` of DTensors: per call
    site (``file:line``), the set of (distinct operand placements, the
    collectives the stack ran) seen there."""

    def __init__(self):
        self.seen: dict = {}

    def __enter__(self):
        import os
        import sys
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.debug import CommDebugMode
        self._orig = orig = torch.stack

        def stack(tensors, *args, **kw):
            tensors = list(tensors)
            if not (tensors and isinstance(tensors[0], DTensor)):
                return orig(tensors, *args, **kw)
            frame = sys._getframe(1)
            where = (f"{os.path.basename(frame.f_code.co_filename)}:"
                     f"{frame.f_lineno}")
            with CommDebugMode() as comm:
                out = orig(tensors, *args, **kw)
            self.seen.setdefault(where, set()).add(
                (len({t.placements for t in tensors}),
                 comm.get_total_counts()))
            return out
        torch.stack = stack
        return self

    def __exit__(self, *exc):
        torch.stack = self._orig


def _run(rank: int, world: int, init_file: str, job: dict, out: str):
    import logging
    import torch.distributed as dist
    torch.set_num_threads(1)
    # DTensor warns at every two-axis reduction that it runs two collectives
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)

    def beat():
        heartbeat(out, rank)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        beat()
        from repro_torch.dist.mesh import make_mesh
        shape, axes = job["mesh"]
        mesh = make_mesh(shape, axes, device_type="cpu")
        results = {}
        with StackProbe() as probe:
            for case in job["cases"]:
                run = _train if case["kind"] == "train" else _serve
                t0 = time.time()
                results[case["name"]] = run(case, mesh, beat)
                results[case["name"]]["seconds"] = time.time() - t0
                beat()
        results["stacks"] = probe.seen
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
    that joins them (``_torch_ranks.join_ranks``: failing, and terminating
    every rank, when one exits non-zero or none makes progress for
    ``JOIN_S`` seconds) and gives rank 0's results."""
    world = int(np.prod(job["mesh"][0]))
    ctx = mp.get_context("spawn")
    out = tmp / "out"
    out.mkdir()
    procs = [ctx.Process(target=_run, args=(r, world, str(tmp / "init"), job,
                                            str(out)))
             for r in range(world)]
    for p in procs:
        p.start()

    def join() -> dict:
        join_ranks(procs, out)
        return torch.load(out / "rank0.pt", weights_only=False)
    return join
