"""Step builders for the LM zoo's serving path.

The reference's ``repro.launch.steps`` builds jit-compiled steps for a mesh;
here a step is a plain function over the ``LM``'s methods, which run on the
LM's device under ``torch.inference_mode``.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.models.lm import LM


def make_lm_prefill_step(lm: LM, max_seq: int) -> Callable:
    def prefill_step(params, tokens, memory=None):
        return lm.prefill(params, tokens, max_seq, memory)
    return prefill_step


def make_lm_decode_step(lm: LM) -> Callable:
    def decode_step(params, caches, token, length):
        return lm.decode_step(params, caches, token, length)
    return decode_step
