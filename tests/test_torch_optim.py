"""Port parity, optimizers: ``sgd`` and ``adamw`` on parameter trees against
the reference's over three updates, from the same parameters and gradients.

Tolerance 1e-6 (rtol and atol): the same f32 elementwise updates; only the
global norm's sum runs in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.spec import PSpec
from repro.optim import adamw as j_adamw
from repro.optim import global_norm_clip as j_global_norm_clip
from repro.optim import sgd as j_sgd

from repro_torch.optim import (adamw, global_norm_clip, sgd, tree_leaves,
                               tree_map)

TOL = dict(rtol=1e-6, atol=1e-6)


def _tree(rng, scale=1.0):
    """A GNN-shaped parameter tree of numpy arrays."""
    def a(*shape):
        return (scale * rng.normal(size=shape)).astype(np.float32)
    return {"embed": {}, "head": {"b": a(5), "w": a(8, 5)},
            "layers": {"b": [a(8), a(8)], "w": [a(12, 8), a(8, 8)]}}


def _torch(tree):
    return tree_map(torch.from_numpy, tree)


def _assert_close(got, want):
    a = tree_leaves(got)
    b = jax.tree.leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("sgd", {"beta": 0.5}),
                                     ("adamw", {}),
                                     ("adamw", {"wd": 0.0, "b2": 0.999})])
def test_optimizer_matches_reference(name, kw):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    j_opt = {"sgd": j_sgd, "adamw": j_adamw}[name](lr=0.05, **kw)
    t_opt = {"sgd": sgd, "adamw": adamw}[name](lr=0.05, **kw)
    spec = jax.tree.map(lambda p: PSpec(p.shape, (None,) * p.ndim,
                                        dtype=jnp.float32), params)
    jp, js = jax.tree.map(jnp.asarray, params), j_opt.init(params, spec)
    tp, ts = _torch(params), t_opt.init(_torch(params))
    for i in range(3):
        # the second step's grads exceed the clip norm, the others do not
        grads = _tree(rng, scale=0.01 if i != 1 else 3.0)
        jp, js, j_gn = j_opt.update(jax.tree.map(jnp.asarray, grads), js, jp,
                                    jnp.float32(0.05))
        tp, ts, t_gn = t_opt.update(_torch(grads), ts, tp, t_opt.lr)
        np.testing.assert_allclose(float(t_gn), float(j_gn), **TOL)
        _assert_close(tp, jp)
    assert int(ts["count"]) == int(js["count"]) == 3


def test_global_norm_clip_matches_reference():
    rng = np.random.default_rng(1)
    grads = _tree(rng, scale=2.0)
    t_clipped, t_gn = global_norm_clip(_torch(grads), 1.0)
    j_clipped, j_gn = j_global_norm_clip(jax.tree.map(jnp.asarray, grads),
                                         1.0)
    np.testing.assert_allclose(float(t_gn), float(j_gn), **TOL)
    _assert_close(t_clipped, j_clipped)
