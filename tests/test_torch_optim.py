"""Port parity, optimizers: ``sgd``, ``adamw``, ``adamw8bit`` and
``adafactor`` on parameter trees against the reference's over several
updates, from the same parameters and gradients; ``make_optimizer``; the
gradient compression and the SPIDER controller.

Tolerance 1e-6 (rtol and atol): the same f32 elementwise updates; only the
global norm's sum runs in another order. Where a test needs another bar
(AdamW-8bit's codes after a first step, Adafactor on bf16 leaves), it says
why.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.spec import PSpec
from repro.optim import adafactor as j_adafactor
from repro.optim import adamw as j_adamw
from repro.optim import adamw8bit as j_adamw8bit
from repro.optim import compression as j_compression
from repro.optim import global_norm_clip as j_global_norm_clip
from repro.optim import make_optimizer as j_make_optimizer
from repro.optim import make_spider_controller as j_spider
from repro.optim import optimizers as j_optimizers
from repro.optim import sgd as j_sgd

from repro_torch.optim import (TopKPayload, adafactor, adamw, adamw8bit,
                               global_norm_clip, int8_compress,
                               int8_decompress, make_optimizer,
                               make_spider_controller, sgd, topk_compress,
                               topk_decompress, tree_leaves, tree_map)
from repro_torch.optim import optimizers as t_optimizers

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


# ------------------------------------------------ adamw8bit and adafactor

def _lm_tree(rng, scale=1.0):
    """An LM-shaped tree: a stacked 3-D leaf, 2-D leaves (one with a last
    axis longer than a quantization block and not a multiple of it), 1-D
    leaves, in f32 and bf16."""
    def a(*shape, dtype=np.float32):
        return (scale * rng.normal(size=shape)).astype(dtype)
    return {"blocks": {"w": a(3, 16, 24), "ln": a(3, 16)},
            "embed": a(64, 300), "head": a(24, 40), "b": a(7),
            "gate": a(1)}


def _spec(tree):
    return jax.tree.map(lambda p: PSpec(p.shape, (None,) * p.ndim,
                                        dtype=jnp.float32), tree)


def _run_both(j_opt, t_opt, steps=4, seed=2, bf16=False):
    """``steps`` updates of both optimizers from the same parameters and
    gradients; returns the two (params, state, norms) after the last."""
    rng = np.random.default_rng(seed)
    params = _lm_tree(rng)
    if bf16:
        params = jax.tree.map(lambda a: np.asarray(
            jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)), params)
    spec = _spec(params)
    jp, js = jax.tree.map(jnp.asarray, params), j_opt.init(params, spec)
    tp, ts = _torch(params), t_opt.init(_torch(params))
    for i in range(steps):
        grads = _lm_tree(rng, scale=0.01 if i != 1 else 3.0)
        jp, js, j_gn = j_opt.update(jax.tree.map(jnp.asarray, grads), js, jp,
                                    jnp.float32(j_opt.lr))
        tp, ts, t_gn = t_opt.update(_torch(grads), ts, tp, t_opt.lr)
        np.testing.assert_allclose(float(t_gn), float(j_gn), **TOL)
    return (jp, js), (tp, ts)


def test_q8_encode_decode_bit_equal():
    rng = np.random.default_rng(3)
    for shape in [(), (5,), (3, 256), (2, 3, 300), (4, 513)]:
        x = np.asarray(rng.normal(size=shape) * 10.0 ** rng.integers(-6, 1),
                       dtype=np.float32)
        if x.ndim and x.shape[-1] >= 4:
            # a block whose scale is 1: its halves round to even
            x.reshape(-1)[:4] = [127.0, 0.5, -0.5, 2.5]
        jq, js = j_optimizers._q8_encode(jnp.asarray(x))
        tq, ts = t_optimizers._q8_encode(torch.from_numpy(x))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert t_optimizers._q8_scale_shape(shape) == \
            j_optimizers._q8_scale_shape(shape) == tuple(ts.shape)
        np.testing.assert_array_equal(
            t_optimizers._q8_decode(tq, ts, shape).numpy(),
            np.asarray(j_optimizers._q8_decode(jq, js, shape)))


def _norm_rel(got, want) -> float:
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("steps", [1, 4])
def test_adamw8bit_matches_reference(steps):
    """One update from the zero state is bit-equal in its codes. Later
    updates decode the moments, and where XLA fuses ``b1·m + (1-b1)·g``
    with another rounding, a code at a rounding tie can move by one step:
    then that entry's moment differs by one quantization step, which the
    parameters carry. So after 4 updates: codes equal but for at most 0.2%
    of entries, each off by one; parameters, master and scales within 1e-4
    in norm per leaf and elementwise (rtol 1e-6) on 99% of all entries."""
    (jp, js), (tp, ts) = _run_both(j_adamw8bit(lr=0.05), adamw8bit(lr=0.05),
                                   steps=steps)
    codes = list(zip(tree_leaves(ts["m_q"]) + tree_leaves(ts["v_q"]),
                     jax.tree.leaves(js["m_q"]) + jax.tree.leaves(js["v_q"])))
    off = sum(int((a.numpy() != np.asarray(b)).sum()) for a, b in codes)
    assert all(a.dtype == torch.int8 for a, _ in codes)
    if steps == 1:
        assert off == 0
        _assert_close(tp, jp)
        _assert_close(ts["master"], js["master"])
        _assert_close(ts["m_s"], js["m_s"])
        _assert_close(ts["v_s"], js["v_s"])
    else:
        total = sum(a.numel() for a, _ in codes)
        assert off <= 0.002 * total, (off, total)
        for a, b in codes:
            assert np.abs(a.numpy().astype(int) - np.asarray(b).astype(int)
                          ).max() <= 1
        for got, want in [(tp, jp), (ts["master"], js["master"]),
                          (ts["m_s"], js["m_s"]), (ts["v_s"], js["v_s"])]:
            pairs = list(zip(tree_leaves(got), jax.tree.leaves(want)))
            assert all(_norm_rel(x, y) <= 1e-4 for x, y in pairs)
            close = np.concatenate([np.isclose(x.numpy(), np.asarray(y),
                                               **TOL).ravel()
                                    for x, y in pairs])
            assert close.mean() >= 0.99
    assert int(ts["count"]) == int(js["count"]) == steps


@pytest.mark.parametrize("stream_bytes", [1 << 27, 2048, 40 * 64 * 4 // 4])
def test_adafactor_matches_reference(stream_bytes):
    """The default, and ``stream_bytes`` small enough that the 3-D leaf
    goes per layer and the 2-D leaves in row chunks (64x300 in 16 chunks
    at 2048 bytes; 24x40 at 2560 bytes in 2 chunks of 12 rows)."""
    kw = {"stream_bytes": stream_bytes, "wd": 0.01}
    (jp, js), (tp, ts) = _run_both(j_adafactor(lr=0.05, **kw),
                                   adafactor(lr=0.05, **kw))
    _assert_close(tp, jp)
    _assert_close(ts["vr"], js["vr"])
    _assert_close(ts["vc"], js["vc"])
    assert int(ts["count"]) == int(js["count"]) == 4


def test_adafactor_on_bf16_leaves():
    """bf16 parameters and gradients, as the LM's: the f32 statistics of a
    bf16 gradient (exact products, summed in another order)."""
    j_opt, t_opt = j_adafactor(lr=0.05), adafactor(lr=0.05)
    rng = np.random.default_rng(4)
    params = _lm_tree(rng)
    grads = _lm_tree(rng, scale=0.3)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    jg = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), grads)
    js = j_opt.init(params, _spec(params))
    tp = tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), params)
    tg = tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), grads)
    ts = t_opt.init(tp)
    jp, js, j_gn = j_opt.update(jg, js, jp, jnp.float32(0.05))
    tp, ts, t_gn = t_opt.update(tg, ts, tp, 0.05)
    np.testing.assert_allclose(float(t_gn), float(j_gn), rtol=1e-5)
    for a, b in zip(tree_leaves(ts["vr"]) + tree_leaves(ts["vc"]),
                    jax.tree.leaves(js["vr"]) + jax.tree.leaves(js["vc"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-30)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert a.dtype == torch.bfloat16
        ref = np.asarray(b.astype(jnp.float32))
        # one bf16 ulp where the f32 update lands near a rounding boundary
        np.testing.assert_allclose(a.float().numpy(), ref, rtol=2 ** -7,
                                   atol=0)


def test_make_optimizer_table_and_lr_override():
    for name in ("sgd", "adamw", "adamw8bit", "adafactor"):
        j, t = j_make_optimizer(name), make_optimizer(name)
        assert (t.name, t.lr) == (j.name, j.lr)
        j2, t2 = j_make_optimizer(name, lr=3e-3), make_optimizer(name, lr=3e-3)
        assert (t2.name, t2.lr) == (j2.name, j2.lr) == (name, 3e-3)
    with pytest.raises(KeyError):
        make_optimizer("lion")


# ------------------------------------------------------------ compression
def test_topk_compress_matches_reference():
    rng = np.random.default_rng(5)
    g = rng.normal(size=(40, 25)).astype(np.float32)
    err = (0.1 * rng.normal(size=(40, 25))).astype(np.float32)
    for frac, e in [(0.01, None), (0.1, err), (1e-6, None)]:
        jpay, jerr = j_compression.topk_compress(
            jnp.asarray(g), frac, None if e is None else jnp.asarray(e))
        tpay, terr = topk_compress(torch.from_numpy(g), frac,
                                   None if e is None else torch.from_numpy(e))
        assert isinstance(tpay, TopKPayload) and tpay.shape == (40, 25)
        np.testing.assert_array_equal(tpay.indices.numpy(),
                                      np.asarray(jpay.indices))
        np.testing.assert_array_equal(tpay.values.numpy(),
                                      np.asarray(jpay.values))
        np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))
        np.testing.assert_array_equal(
            topk_decompress(tpay).numpy(),
            np.asarray(j_compression.topk_decompress(jpay)))


def test_topk_ties_keep_the_lower_index_first():
    g = np.array([1.0, -3.0, 2.0, 3.0, -3.0, 0.5, 3.0, 2.0], np.float32)
    jpay, jerr = j_compression.topk_compress(jnp.asarray(g), 0.5)
    tpay, terr = topk_compress(torch.from_numpy(g), 0.5)
    np.testing.assert_array_equal(np.asarray(jpay.indices), [1, 3, 4, 6])
    np.testing.assert_array_equal(tpay.indices.numpy(), [1, 3, 4, 6])
    np.testing.assert_array_equal(tpay.values.numpy(), np.asarray(jpay.values))
    np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))


def test_int8_compress_matches_reference():
    rng = np.random.default_rng(6)
    g = rng.normal(size=(33, 17)).astype(np.float32)
    g[0, :2] = [np.abs(g).max() / 127 * 2.5, 0.0]    # a rounding tie
    for x in (g, np.zeros((4,), np.float32)):
        jq, js = j_compression.int8_compress(jnp.asarray(x))
        tq, ts = int8_compress(torch.from_numpy(x))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            int8_decompress(tq, ts).numpy(),
            np.asarray(j_compression.int8_decompress(jq, js)))


# ----------------------------------------------------------------- SPIDER
def test_spider_controller_anchor_and_refine_match_reference():
    rng = np.random.default_rng(7)
    j_init, j_should, j_anchor, j_refine = j_spider(q=3)
    t_init, t_should, t_anchor, t_refine = make_spider_controller(q=3)
    params = _tree(rng)
    js, ts = j_init(jax.tree.map(jnp.asarray, params)), t_init(_torch(params))
    for i in range(7):
        assert t_should(ts) == j_should(js) == (i % 3 == 0)
        params = _tree(rng)
        g1, g2 = _tree(rng), _tree(rng)
        if j_should(js):
            js = j_anchor(js, jax.tree.map(jnp.asarray, params),
                          jax.tree.map(jnp.asarray, g1))
            ts = t_anchor(ts, _torch(params), _torch(g1))
        else:
            js = j_refine(js, jax.tree.map(jnp.asarray, params),
                          jax.tree.map(jnp.asarray, g1),
                          jax.tree.map(jnp.asarray, g2))
            ts = t_refine(ts, _torch(params), _torch(g1), _torch(g2))
        _assert_close(ts.g_est, js.g_est)
        _assert_close(ts.prev_params, js.prev_params)
        assert int(ts.step) == int(js.step) == i + 1
