"""Step builders of the LM zoo: the train step and the serving steps.

The reference's ``repro.launch.steps`` builds jit-compiled steps for a mesh;
here a step is a plain function over the ``LM``'s methods, run on the LM's
device: the train step takes gradients with autograd, the serving steps run
under ``torch.inference_mode``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.lm import LM
from repro_torch.models import spec
from repro_torch.optim.optimizers import Optimizer, tree_map


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
        return loss.detach(), _with_leaves(params, list(grads))

    def train_step(params, opt_state, batch):
        batch = {k: v.to(lm.device) for k, v in batch.items()
                 if v is not None}
        bsz = batch["tokens"].shape[0]
        if n_mb == 1:
            loss, grads = grads_of(params, batch)
        else:
            if bsz % n_mb:
                raise ValueError(
                    f"make_lm_train_step: batch of {bsz} rows does not split "
                    f"into cfg.microbatches={n_mb} microbatches (the batch "
                    f"must be a multiple of {n_mb})")
            mb = {k: v.reshape(n_mb, bsz // n_mb, *v.shape[1:])
                  for k, v in batch.items()}
            acc = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dt),
                           params)
            loss = torch.zeros((), dtype=torch.float32, device=lm.device)
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
