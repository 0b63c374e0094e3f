"""The comparisons that decide ``correct``: numbers from the program's run
and the plain reference's, each later held to its limit (``harness.judge``).

Training (three steps from the same seed): the relative gap of each
step's loss; the first gradient as the optimizer got it (its momentum after
one step, the clipped gradient); the parameters' change after three steps;
and the stores' rows after three steps. Gradient, change and stores are
compared by the worst leaf of the gap between the two sides' norms (not
the norm of their difference), over the reference's norm of that leaf or
of the median leaf, whichever is larger. Leaves whose reference gradient
is under a thousandth of the median leaf's are left out of the change:
they move by round-off alone. Serving: the largest gap of a served exact
answer's logits from the full-graph forward's, over the largest reference
logit compared.
"""
from __future__ import annotations

import numpy as np
import torch

ROUNDOFF_LEAF = 1e-3


def norms(tensors: dict) -> dict:
    """Each tensor's L2 norm, in f64."""
    return {k: float(torch.linalg.vector_norm(t.double()))
            for k, t in tensors.items()}


def worst_gap(prog: dict, ref: dict, keep=None) -> tuple:
    """``(gap, leaf)`` of the worst leaf: ``| |p| - |r| | / max(|r|,
    median |r|)`` over the leaves in ``keep`` (all when None); the dicts
    hold each leaf's norm."""
    keys = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in keys]))
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in keys}
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def train_numbers(prog: dict, ref: dict) -> tuple:
    """``prog``/``ref``: ``losses`` (3), and the norms by leaf of ``grad``
    (the clipped first gradient), ``update`` (the parameters after three
    steps minus before) and ``store`` (each layer's H̄ and V̄ after three
    steps); ``ref`` also ``raw_grad`` (the unclipped first gradient's norms).
    Returns ``(numbers, worst leaves)``."""
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(prog["losses"], ref["losses"], strict=True))
    raw = ref["raw_grad"]
    med = float(np.median(list(raw.values())))
    moved = {k for k, v in raw.items() if v >= ROUNDOFF_LEAF * med}
    grad, g_leaf = worst_gap(prog["grad"], ref["grad"])
    upd, u_leaf = worst_gap(prog["update"], ref["update"], moved)
    store, s_leaf = worst_gap(prog["store"], ref["store"])
    return ({"loss": loss, "grad": grad, "update": upd, "store": store},
            {"grad": g_leaf, "update": u_leaf, "store": s_leaf})


def serve_number(served: list, ref_logits: torch.Tensor) -> float:
    """``served``: ``(nodes, logits)`` of every exact answer compared."""
    if not served:
        return float("inf")
    nodes = torch.as_tensor(np.concatenate([n for n, _ in served]),
                            device=ref_logits.device)
    got = torch.as_tensor(np.concatenate([lg for _, lg in served]),
                          device=ref_logits.device)
    want = ref_logits[nodes]
    return float((got - want).abs().max() / want.abs().max())
