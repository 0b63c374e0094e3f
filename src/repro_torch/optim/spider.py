"""LMC-SPIDER (paper Appendix F): variance-reduced mini-batch gradients, as
the reference's ``repro.optim.spider`` keeps them.

Every ``q`` steps take a large-batch anchor gradient g_k = ∇L(W_k, S1); in
between, update the running estimate

    g_k = ∇L(W_k, S2) - ∇L(W_{k-1}, S2) + g_{k-1}

on small batches S2, the same batch at the current and the previous
parameters. The controller is optimizer-agnostic: the caller calls
``anchor_update`` or ``refine_update`` on Algorithm 2's schedule and descends
along the running estimate.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.optim.optimizers import tree_leaves, tree_map


class SpiderState(NamedTuple):
    g_est: dict                # running gradient estimate (f32 tree)
    prev_params: dict          # W_{k-1}
    step: torch.Tensor         # int32, 0-d


def make_spider_controller(q: int = 8):
    """Returns (init, should_anchor, anchor_update, refine_update)."""

    def init(params) -> SpiderState:
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
        dev = tree_leaves(params)[0].device
        return SpiderState(g_est=z, prev_params=params,
                           step=torch.zeros((), dtype=torch.int32, device=dev))

    def should_anchor(state: SpiderState) -> bool:
        return int(state.step) % q == 0

    def anchor_update(state: SpiderState, params, big_batch_grads):
        g = tree_map(lambda x: x.float(), big_batch_grads)
        return SpiderState(g_est=g, prev_params=params, step=state.step + 1)

    def refine_update(state: SpiderState, params, grads_at_current,
                      grads_at_prev):
        g = tree_map(lambda ge, gc, gp: ge + gc.float() - gp.float(),
                     state.g_est, grads_at_current, grads_at_prev)
        return SpiderState(g_est=g, prev_params=params, step=state.step + 1)

    return init, should_anchor, anchor_update, refine_update
