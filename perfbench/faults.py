"""Faults planted under the timed path, each of which ``correct`` must
catch: the tests (on the CPU) and ``calibrate.py`` (on the card, for the
limits' upper readings) plant them into a driver's ``Program``.

Training: a step that returns its state unchanged (parameters, optimizer
state and store rows), and half of the batch left out of the loss, the
mean taken over the rest. Serving: an answer altered where it is produced,
and half of a batch's target rows left out of the exact step. One card has
no exchange between chips to leave out.
"""
from __future__ import annotations

import dataclasses


def unchanged_state(prog) -> None:
    """Training: the step keeps parameters, optimizer state and store."""
    tr = prog.trainer
    step = tr._step

    def no_rows(*args):
        loss, grads, _, metrics = step(*args)
        return loss, grads, None, metrics

    tr._step = no_rows
    tr.opt = dataclasses.replace(
        tr.opt, update=lambda g, state, params, lr: (
            params, state, sum(x.square().sum() for x in _leaves(g)).sqrt()))


def half_batch(prog) -> None:
    """Training: half the batch's labelled rows out of the loss, the mean
    over the rest."""
    tr = prog.trainer
    step = tr._step

    def half(params, store, batch, x, self_w):
        real = int(batch.batch_mask.sum())
        lab = batch.labeled_mask.clone()
        lab[real // 2:real] = 0.0
        return step(params, store, batch._replace(
            labeled_mask=lab, loss_scale=batch.loss_scale * 2), x, self_w)

    tr._step = half


def altered_answer(prog) -> None:
    """Serving: one logit of each exact batch moved by 1% of its row's
    largest."""
    srv = prog.server
    step = srv._steps["exact"]

    def altered(*args):
        logits, rows = step(*args)
        logits = logits.clone()
        logits[0, 0] += 0.01 * logits[0].abs().max()
        return logits, rows

    srv._steps["exact"] = altered


def half_batch_serve(prog) -> None:
    """Serving: half of each exact batch's target rows masked out."""
    srv = prog.server
    step = srv._steps["exact"]

    def half(params, store, batch, x, self_w):
        mask = batch.batch_mask.clone()
        real = int(mask.sum())
        mask[real // 2:real] = 0.0
        return step(params, store, batch._replace(batch_mask=mask), x,
                    self_w)

    srv._steps["exact"] = half


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


TRAIN = {"unchanged_state": unchanged_state, "half_batch": half_batch}
SERVE = {"altered_answer": altered_answer,
         "half_batch_serve": half_batch_serve}
