"""Deterministic, resumable synthetic token pipeline for the LM examples:
the port's own copy of the reference's ``repro.data.tokens`` (numpy only),
yielding the same batches bit for bit.

Counter-based (Philox) generation: batch ``i`` is a pure function of
(seed, i), so resuming from a checkpointed step counter reproduces the exact
stream. Sequences follow a Zipf unigram model with markovian repetition so
the loss actually decreases.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    """Infinite iterator of synthetic LM batches, resumable by step counter.

    Batch ``i`` is a pure function of ``(seed, i)`` (counter-based Philox),
    so checkpointing just the ``step`` integer reproduces the exact stream.
    Yields ``{"tokens": (batch, seq_len) int32, "loss_mask": float32}`` as
    numpy arrays.
    """

    def __init__(self, vocab: int, batch: int, seq_len: int, *, seed: int = 0,
                 zipf_a: float = 1.2, repeat_p: float = 0.3):
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.step = 0
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        p = ranks ** (-zipf_a)
        self.probs = p / p.sum()
        self.repeat_p = repeat_p

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        """Generate batch ``self.step`` and advance the counter."""
        rng = np.random.Generator(np.random.Philox(key=self.seed,
                                                   counter=self.step))
        toks = rng.choice(self.vocab, size=(self.batch, self.seq_len),
                          p=self.probs).astype(np.int32)
        # markovian repetition: with prob repeat_p copy the previous token
        rep = rng.random((self.batch, self.seq_len)) < self.repeat_p
        for t in range(1, self.seq_len):
            toks[:, t] = np.where(rep[:, t], toks[:, t - 1], toks[:, t])
        self.step += 1
        return {"tokens": toks,
                "loss_mask": np.ones((self.batch, self.seq_len), np.float32)}

    # resumable: the counter is the state
    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
