"""Adafactor's streamed update: the f32 temporaries of one update stay
piece-sized, as the reference's ``jax.lax.map`` keeps them.

A leaf bigger than ``stream_bytes`` in f32 is updated one piece at a time
(a slice of the leading axis of a stacked leaf, a chunk of rows of a 2-D
leaf). The temporaries of one update are tallied on the CPU by a counting
dispatch mode (``launch.dryrun.Tally``): every storage an op allocates and
the update frees before it returns. The parameters, gradients and state it
reads, and the new parameters and state it returns, are not temporaries.
The leaves here are 64 × ``stream_bytes``; their temporaries must stay
within 4 × ``stream_bytes`` (a whole-leaf pass needs several times the
leaf). The same update against the reference's, at 1e-6 (rtol and atol) as
``tests/test_torch_optim.py``.
"""
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.spec import PSpec
from repro.optim import adafactor as j_adafactor

from repro_torch.launch.dryrun import Tally
from repro_torch.optim import adafactor, tree_leaves, tree_map

STREAM = 1 << 18            # bytes of f32 in one piece
ROWS, COLS = 256, 256       # one piece: 256 x 256 f32 = STREAM
LEAVES = {"2d": (64 * ROWS, COLS), "3d": (64, ROWS, COLS)}
# the parity cases: 64 pieces of 64 x 64
P_STREAM, P_ROWS, P_COLS = 1 << 14, 64, 64
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the ops here are small, and the suite runs
    several workers on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Temps(Tally):
    """Tally that also finds the most bytes held at once by storages that
    were both allocated and freed inside the mode's lifetime (each storage
    logged under its own sequence number: ids are reused once freed)."""

    def __init__(self):
        super().__init__()
        self.log: list = []

    def _track(self, t):
        st = t.untyped_storage()
        if id(st) not in self._seen:
            seq, n = len(self.log), st.nbytes()
            self.log.append((seq, n))
            weakref.finalize(st, self.log.append, (seq, -n))
        super()._track(t)

    def peak_temporaries(self) -> int:
        freed = {k for k, n in self.log if n < 0}
        live = peak = 0
        for k, n in self.log:
            if k in freed:
                live += n
                peak = max(peak, live)
        return peak


def _tree(rng, shape, dtype, scale=1.0):
    """A big leaf beside two small ones."""
    def a(*s):
        return torch.from_numpy((scale * rng.normal(size=s))
                                .astype(np.float32)).to(dtype)
    return {"big": a(*shape), "small": a(8, 24), "b": a(7)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", sorted(LEAVES))
def test_streamed_update_temporaries_stay_piece_sized(kind, dtype):
    rng = np.random.default_rng(5)
    opt = adafactor(lr=0.05, stream_bytes=STREAM, wd=0.01)
    params = _tree(rng, LEAVES[kind], dtype)
    state = opt.init(params)
    grads = _tree(rng, LEAVES[kind], dtype, scale=0.3)
    assert params["big"].numel() * 4 == 64 * STREAM
    tally = _Temps()
    tally.hold((params, grads, state))
    with tally:
        new_p, new_s, gn = opt.update(grads, state, params, opt.lr)
    temps = tally.peak_temporaries()
    assert temps <= 4 * STREAM, (kind, dtype, temps, temps / STREAM)
    assert torch.isfinite(gn) and new_p["big"].dtype == dtype
    assert all(torch.isfinite(t.float()).all() for t in
               tree_leaves(new_p) + tree_leaves(new_s["vr"])
               + tree_leaves(new_s["vc"]))


@pytest.mark.parametrize("kind", sorted(LEAVES))
def test_streamed_update_matches_reference_over_64_pieces(kind):
    """Two updates of the 64-piece leaf against the reference's
    ``jax.lax.map`` path. The gradients stay under the clip norm, so the
    clip scale is 1 on both sides: the reference sums the squares behind
    the norm in f32 in one pass (over 2^24 of them it is ~4e-4 off their
    f64 sum), so the port's norm is held to the f64 sum (1e-6) and to be
    no further from it than the reference's."""
    rng = np.random.default_rng(6)
    kw = dict(lr=0.05, stream_bytes=P_STREAM, wd=0.01)
    j_opt, t_opt = j_adafactor(**kw), adafactor(**kw)
    shape = {"2d": (64 * P_ROWS, P_COLS), "3d": (64, P_ROWS, P_COLS)}[kind]
    params = tree_map(lambda t: t.numpy(),
                      _tree(rng, shape, torch.float32))
    spec = jax.tree.map(lambda p: PSpec(p.shape, (None,) * p.ndim,
                                        dtype=jnp.float32), params)
    jp, js = jax.tree.map(jnp.asarray, params), j_opt.init(params, spec)
    tp = tree_map(torch.from_numpy, params)
    ts = t_opt.init(tp)
    for scale in (5e-4, 1e-3):
        grads = tree_map(lambda t: t.numpy(),
                         _tree(rng, shape, torch.float32, scale))
        exact = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                            for g in tree_leaves(grads)))
        assert exact < 1.0
        jp, js, j_gn = j_opt.update(jax.tree.map(jnp.asarray, grads), js,
                                    jp, jnp.float32(0.05))
        tp, ts, t_gn = t_opt.update(tree_map(torch.from_numpy, grads), ts,
                                    tp, 0.05)
        np.testing.assert_allclose(float(t_gn), exact, rtol=1e-6)
        assert abs(float(t_gn) - exact) <= abs(float(j_gn) - exact) + 1e-7
    for got, want in ((tp, jp), (ts["vr"], js["vr"]), (ts["vc"], js["vc"])):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want),
                        strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
