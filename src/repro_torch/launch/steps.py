"""Step builders + input specs for every (arch × shape) cell.

The reference's ``repro.launch.steps`` builds jit-compiled steps for a mesh;
here a step is a plain function over the ``LM``'s methods: the train step
takes gradients with autograd, the serving steps run under
``torch.no_grad`` (DTensor views cannot be taken in inference mode). Off-mesh a step runs on the LM's device. On a
mesh (:func:`build_cell`) the step runs with the mesh registered for the
activation constraints, over DTensor parameters, optimizer state, batches
and caches whose placements :func:`input_specs` gives by the reference's
rules.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.dist.sharding import (activation_sharding, data_axes,
                                       dp_axis_size, dp_entry, mesh_tensor,
                                       named, shard_act, whole)
from repro_torch.models.lm import LM
from repro_torch.models import spec
from repro_torch.optim.optimizers import (Optimizer, make_optimizer,
                                          tree_map)


def fsdp_axes_for(cfg: ArchConfig, mesh) -> tuple:
    """The mesh axes weights shard over (the ``embed`` logical axis)."""
    if cfg.fsdp_over_pod and "pod" in data_axes(mesh):
        return ("pod", "data")
    return ("data",)


def _with_leaves(tree: dict, leaves: list) -> dict:
    """``tree``'s structure with its leaves (in ``tree_leaves`` order)
    replaced by ``leaves``."""
    it = iter(leaves)
    return spec.tree_map(lambda _: next(it), tree)


def make_lm_train_step(lm: LM, opt: Optimizer) -> Callable:
    """The reference's production step: loss -> grads (with gradient
    accumulation over ``cfg.microbatches`` in ``cfg.grad_accum_dtype``)
    -> clipped optimizer update.

    ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``. ``batch`` holds tensors: tokens (B,S),
    loss_mask (B,S) [, memory (B,T,d)], moved to the LM's device. With
    ``microbatches`` n > 1 every leaf is split contiguously into n
    microbatches of B // n rows (B must be a multiple of n); the gradients
    accumulate as ``acc + g.to(grad_accum_dtype)`` and the loss in f32, and
    both are divided by n.
    """
    n_mb = max(lm.cfg.microbatches, 1)
    acc_dt = getattr(torch, lm.cfg.grad_accum_dtype)

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_(True)
                  for _, p in spec.tree_leaves(params)]
        loss = lm.train_loss(_with_leaves(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        # a DTensor gradient comes back on its parameter's placements (the
        # FSDP reduce-scatter of partial sums)
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if isinstance(g, DTensor) else g
                 for p, g in zip(leaves, grads)]
        return _replicated(loss.detach()), _with_leaves(params, grads)

    def train_step(params, opt_state, batch):
        batch = {k: v if isinstance(v, DTensor) else v.to(lm.device)
                 for k, v in batch.items() if v is not None}
        bsz = batch["tokens"].shape[0]
        if n_mb == 1:
            loss, grads = grads_of(params, batch)
        else:
            if bsz % n_mb:
                raise ValueError(
                    f"make_lm_train_step: batch of {bsz} rows does not split "
                    f"into cfg.microbatches={n_mb} microbatches (the batch "
                    f"must be a multiple of {n_mb})")
            # microbatch i holds rows [i·B/n, (i+1)·B/n); on a mesh its rows
            # are dp-sharded again after the split
            mb = {k: shard_act(whole(v, 0).reshape(
                      n_mb, bsz // n_mb, *v.shape[1:]),
                      None, "dp", *(None,) * (v.ndim - 1))
                  for k, v in batch.items()}
            acc = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dt),
                           params)
            ref = batch["tokens"]
            loss = mesh_tensor(ref, lambda s: torch.zeros(
                s, dtype=torch.float32, device=ref.device), ())
            for i in range(n_mb):
                loss_i, g_i = grads_of(params, {k: v[i] for k, v in mb.items()})
                acc = tree_map(lambda a, g: a + g.to(a.dtype), acc, g_i)
                loss = loss + loss_i
            grads = tree_map(lambda g: g / n_mb, acc)
            loss = loss / n_mb
        with torch.no_grad():
            new_params, new_state, gnorm = opt.update(grads, opt_state,
                                                      params, opt.lr)
        return new_params, new_state, {"loss": loss, "grad_norm": gnorm}
    return train_step


def make_lm_prefill_step(lm: LM, max_seq: int) -> Callable:
    def prefill_step(params, tokens, memory=None):
        return lm.prefill(params, tokens, max_seq, memory)
    return prefill_step


def make_lm_decode_step(lm: LM) -> Callable:
    def decode_step(params, caches, token, length):
        return lm.decode_step(params, caches, token, length)
    return decode_step


def _replicated(x: torch.Tensor) -> torch.Tensor:
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
    return x


# ------------------------------------------------------------- input specs
def _meta(mesh, shape, dtype, plc) -> DTensor:
    """A DTensor of ``shape`` over a meta local shard."""
    return spec.abstract({"x": spec.PSpec(tuple(shape), (None,) * len(shape),
                                          dtype=dtype)},
                         {"x": plc}, mesh)["x"]


def input_specs(cfg: ArchConfig, lm: LM, shape: ShapeConfig, mesh,
                opt: Optional[Optimizer] = None):
    """(abstract args, placements) of the step of ``shape.kind``: DTensors
    over meta local shards, each leaf placed by the reference's rules.

    train: (params, opt_state, batch{tokens, loss_mask[, memory]});
    prefill: (params, tokens[, memory]); decode: (params, caches, token,
    length). The decode length is a host value in the port: a plain 0-d
    int32 on the CPU holding ``seq_len - 1`` (the last position), placed
    replicated.
    """
    rules = spec.default_rules(fsdp_axes_for(cfg, mesh))
    pspec = lm.params_spec()
    params_sh = spec.shardings(pspec, rules, mesh)
    params_abs = spec.abstract(pspec, params_sh, mesh)
    dp = dp_entry(mesh)
    B, S = shape.global_batch, shape.seq_len
    b_ok = B % max(dp_axis_size(mesh), 1) == 0
    tok_sh = named(mesh, dp if b_ok else None, None)
    mem_sh = named(mesh, dp if b_ok else None, None, None)
    T = cfg.frontend_tokens or S

    if shape.kind == "train":
        if opt is None:
            raise ValueError("input_specs: a train cell needs an optimizer")
        batch_abs: dict[str, Any] = {
            "tokens": _meta(mesh, (B, S), torch.int32, tok_sh),
            "loss_mask": _meta(mesh, (B, S), torch.float32, tok_sh)}
        batch_sh: dict[str, Any] = {"tokens": tok_sh, "loss_mask": tok_sh}
        if cfg.family in ("vlm", "encdec"):
            batch_abs["memory"] = _meta(mesh, (B, T, cfg.d_model),
                                        torch.bfloat16, mem_sh)
            batch_sh["memory"] = mem_sh
        sspec = opt.state_spec(pspec)
        opt_sh = spec.shardings(sspec, rules, mesh)
        opt_abs = spec.abstract(sspec, opt_sh, mesh)
        return (params_abs, opt_abs, batch_abs), (params_sh, opt_sh, batch_sh)

    if shape.kind == "prefill":
        args = [params_abs, _meta(mesh, (B, S), torch.int32, tok_sh)]
        shs = [params_sh, tok_sh]
        if cfg.family in ("vlm", "encdec"):
            args.append(_meta(mesh, (B, T, cfg.d_model), torch.bfloat16,
                              mem_sh))
            shs.append(mem_sh)
        return tuple(args), tuple(shs)

    if shape.kind == "decode":
        cspec = lm.cache_spec(B, S)
        caches_sh = spec.shardings(cspec, rules, mesh)
        caches_abs = spec.abstract(cspec, caches_sh, mesh)
        args = (params_abs, caches_abs,
                _meta(mesh, (B, 1), torch.int32, tok_sh),
                torch.tensor(S - 1, dtype=torch.int32))
        return args, (params_sh, caches_sh, tok_sh, named(mesh))

    raise ValueError(shape.kind)


def _with_act_sharding(fn: Callable, mesh) -> Callable:
    def inner(*a, **kw):
        with activation_sharding(mesh):
            return fn(*a, **kw)
    return inner


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
               depth_profile=None, unroll: bool = False, device=None,
               opt: Optional[Optimizer] = None):
    """(lm, step, abstract args, placements) of one cell on ``mesh``: the
    step runs with ``mesh`` registered for the activation constraints.
    ``device`` is the LM's (default: the mesh's device type); ``opt``
    defaults to ``cfg.optimizer`` with its default settings."""
    lm = LM(cfg, depth_profile=depth_profile, unroll=unroll,
            device=device if device is not None else mesh.device_type)
    if shape.kind == "train":
        opt = opt if opt is not None else make_optimizer(cfg.optimizer)
        step = make_lm_train_step(lm, opt)
        args, shs = input_specs(cfg, lm, shape, mesh, opt)
    elif shape.kind == "prefill":
        step = make_lm_prefill_step(lm, shape.seq_len)
        args, shs = input_specs(cfg, lm, shape, mesh)
    else:
        step = make_lm_decode_step(lm)
        args, shs = input_specs(cfg, lm, shape, mesh)
    return lm, _with_act_sharding(step, mesh), args, shs
