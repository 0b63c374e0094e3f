"""Port parity, the LM's backward passes at f32: each port function's
vector-Jacobian product against ``jax.vjp`` of its reference namesake, on
the same numpy inputs and the same cotangent (made from a seed).

Covered: ``embed_lookup`` with repeated ids (the reference's custom
scatter-add backward; also in bf16), the three MoE gathers whose custom
backward passes are gathers (``_dispatch_gather``, ``_combine_gather``,
``_permute``), ``moe_apply`` with a binding capacity and two dispatch
chunks (each rematerialized), attention chunked (each chunk
rematerialized) and unchunked, ``mamba2_apply`` and ``rwkv6_apply``.

Tolerance: max abs error ≤ 1e-5 of the gradient's max abs value, per
input (the same f32 arithmetic, summed in another order); RWKV6's bf16
token-shift casts are the one exception, stated at its test. Matmuls run
in full f32 (TF32 off).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import ssm as JS

from repro_torch.configs import reduced_config
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS

torch.backends.cuda.matmul.allow_tf32 = False
REL = 1e-5


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(ref, out, rel: float = REL) -> float:
    ref, out = _np(ref), _np(out)
    assert ref.shape == out.shape, (ref.shape, out.shape)
    err = float(np.abs(ref - out).max() / max(np.abs(ref).max(), 1e-12))
    assert err <= rel, err
    return err


def _randn(rng, *shape, scale=1.0) -> np.ndarray:
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _arrays(spec: dict, seed: int) -> dict:
    """f32 values for a reference PSpec tree: normal(0, 0.2) for weights,
    1 + normal(0, 0.1) for "ones" leaves and normal(0, 0.5) for "zeros"
    ones (as tests/test_torch_lm_layers.py draws them)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(spec):
        s = spec[k]
        if isinstance(s, dict):
            out[k] = _arrays(s, seed + 1 + len(out))
            continue
        z = rng.standard_normal(s.shape).astype(np.float32)
        out[k] = {"ones": 1 + 0.1 * z, "zeros": 0.5 * z}.get(s.init, 0.2 * z)
    return out


def _vjp_pair(j_fn, t_fn, inputs: dict, ct_seed: int, out_index=None,
              rel: float = REL):
    """Gradients of both functions of the float ``inputs`` (a flat dict of
    numpy arrays, or of dicts of them) for one random cotangent of their
    output (or of output ``out_index`` of a tuple). Returns
    (reference grads, port grads), trees like ``inputs``."""
    j_in = jax.tree.map(jnp.asarray, inputs)
    out, vjp = jax.vjp(lambda a: _pick(j_fn(a), out_index), j_in)
    ct = _randn(np.random.default_rng(ct_seed), *out.shape)
    (j_grads,) = vjp(jnp.asarray(ct, out.dtype))
    leaves, treedef = jax.tree.flatten(inputs)
    t_leaves = [torch.from_numpy(np.array(a)).requires_grad_(True)
                for a in leaves]
    t_out = _pick(t_fn(jax.tree.unflatten(treedef, t_leaves)), out_index)
    _close(out, t_out, rel)
    # an input the output does not depend on (RWKV6's decay at one token)
    # gets zeros, as from jax.vjp
    t_grads = torch.autograd.grad(t_out, t_leaves,
                                  torch.from_numpy(ct).to(t_out.dtype),
                                  allow_unused=True, materialize_grads=True)
    return j_grads, jax.tree.unflatten(treedef, list(t_grads))


def _pick(out, index):
    return out if index is None else out[index]


def _close_grads(j_grads, t_grads, rel: float = REL) -> None:
    for a, b in zip(jax.tree.leaves(j_grads), jax.tree.leaves(
            t_grads, is_leaf=lambda x: isinstance(x, torch.Tensor))):
        _close(a, b, rel)


# ---------------------------------------------------------- embed_lookup
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_lookup_scatter_add_backward(dtype):
    """Repeated ids (a Zipf-like batch: id 3 a third of the tokens) sum
    their cotangent rows into one embedding row, in the embedding's dtype,
    in index order on the CPU as the reference's scatter-add does: in bf16
    the two are equal bit for bit."""
    rng = np.random.default_rng(0)
    embed = _randn(rng, 40, 16)
    toks = rng.integers(0, 40, (3, 30)).astype(np.int32)
    toks[:, ::3] = 3
    ct = _randn(rng, 3, 30, 16)
    jdt = getattr(jnp, dtype)
    je = jnp.asarray(embed).astype(jdt)
    out, vjp = jax.vjp(lambda e: JL.embed_lookup(e, jnp.asarray(toks)), je)
    (j_grad,) = vjp(jnp.asarray(ct).astype(jdt))
    te = torch.from_numpy(embed).to(getattr(torch, dtype)).requires_grad_(True)
    t_out = TL.embed_lookup(te, torch.from_numpy(toks))
    (t_grad,) = torch.autograd.grad(
        t_out, te, torch.from_numpy(ct).to(getattr(torch, dtype)))
    assert t_grad.dtype == te.dtype
    np.testing.assert_array_equal(_np(t_out), _np(out))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(t_grad), _np(j_grad))
    else:
        _close(j_grad, t_grad)
    assert np.abs(_np(t_grad)[3]).max() > 0


# ------------------------------------------------------------ MoE gathers
def _plan(G=3, s=10, k=2, E=4, cap=4, seed=1):
    """A dispatch with drops (cap 4 < s·k/E = 5): the port's plan, as
    int64 tensors and int32 numpy arrays for the reference."""
    rng = np.random.default_rng(seed)
    eg = torch.from_numpy(np.stack([np.stack([rng.choice(E, k, replace=False)
                                              for _ in range(s)])
                                    for _ in range(G)]))
    plan = TB.dispatch_plan(eg, E, cap)
    assert not bool(plan.keep.all())
    return plan, {k: v.numpy().astype(np.int32)
                  for k, v in plan._asdict().items() if k != "keep"}


def test_dispatch_gather_backward_is_a_gather():
    plan, jp = _plan()
    G, s, d, E, cap = 3, 10, 8, 4, 4
    x = _randn(np.random.default_rng(2), G, s + 1, d)
    x[:, s] = 0.0
    j_grads, t_grads = _vjp_pair(
        lambda a: JB._dispatch_gather(a["x"], jp["slot_tok"][:, :E, :cap],
                                      jp["e_c"], jp["pos_c"],
                                      jp["inv_order"]),
        lambda a: TB._DispatchGather.apply(
            a["x"], plan.slot_tok[:, :E, :cap], plan.e_c, plan.pos_c,
            plan.inv_order),
        {"x": x}, ct_seed=3)
    _close_grads(j_grads, t_grads)
    # the backward gathers: the padding row gets no gradient, a dropped
    # assignment's token gets none from its dropped slot
    assert float(t_grads["x"][:, s].abs().max()) == 0.0


def test_combine_gather_and_permute_backward_are_gathers():
    plan, jp = _plan(seed=4)
    G, s, k, d, E, cap = 3, 10, 2, 8, 4, 4
    y = _randn(np.random.default_rng(5), G, E + 1, cap + 1, d)
    j_grads, t_grads = _vjp_pair(
        lambda a: JB._combine_gather(a["y"], jp["e_c"], jp["pos_c"],
                                     jp["slot_asn"]),
        lambda a: TB._CombineGather.apply(a["y"], plan.e_c, plan.pos_c,
                                          plan.slot_asn),
        {"y": y}, ct_seed=6)
    _close_grads(j_grads, t_grads)
    rows = _randn(np.random.default_rng(7), G, s * k, d)
    j_grads, t_grads = _vjp_pair(
        lambda a: JB._permute(a["r"], jp["inv_order"], jp["order"]),
        lambda a: TB._Permute.apply(a["r"], plan.inv_order, plan.order),
        {"r": rows}, ct_seed=8)
    _close_grads(j_grads, t_grads)


@pytest.mark.parametrize("capacity_factor,batch", [(0.5, 4), (1.25, 3)])
def test_moe_apply_vjp(capacity_factor, batch):
    """The whole MoE block's gradient (router, experts, shared expert, the
    input) with a binding capacity (0.5: assignments dropped) and two
    dispatch chunks over 4 rows (three over 3), each rematerialized."""
    name = "deepseek-v2-lite-16b"
    jcfg, cfg = j_reduced_config(name), reduced_config(name)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity_factor))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    inputs = {"p": _arrays(JB.moe_spec(jcfg), 13),
              "h": _randn(np.random.default_rng(9), batch, 16, cfg.d_model)}
    j_grads, t_grads = _vjp_pair(
        lambda a: JB.moe_apply(a["p"], a["h"], jcfg),
        lambda a: TB.moe_apply(a["p"], a["h"], cfg), inputs, ct_seed=10)
    _close_grads(j_grads, t_grads)


# -------------------------------------------------------------- attention
@pytest.mark.parametrize("kv_chunk", [0, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_vjp(kv_chunk, causal):
    """GQA (4 query heads over 2 KV heads); kv_chunk 4 over 16 positions
    runs 4 chunks, each rematerialized in the backward."""
    rng = np.random.default_rng(11)
    inputs = {"q": _randn(rng, 2, 16, 4, 8), "k": _randn(rng, 2, 16, 2, 8),
              "v": _randn(rng, 2, 16, 2, 8)}
    j_grads, t_grads = _vjp_pair(
        lambda a: JL.attention(a["q"], a["k"], a["v"], causal=causal,
                               kv_chunk=kv_chunk),
        lambda a: TL.attention(a["q"], a["k"], a["v"], causal=causal,
                               kv_chunk=kv_chunk), inputs, ct_seed=12)
    _close_grads(j_grads, t_grads)


# -------------------------------------------------------------------- SSMs
@pytest.mark.parametrize("seq", [16, 21])
def test_mamba2_apply_vjp(seq):
    """Chunked SSD (chunk 16: one whole chunk; a padded second chunk)."""
    name = "zamba2-1.2b"
    cfg, jcfg = reduced_config(name), j_reduced_config(name)
    p = _arrays(JS.mamba2_spec(jcfg), 14)
    p["a_log"] = p["a_log"] - 1.0      # decays well inside (0, 1)
    inputs = {"p": p, "h": _randn(np.random.default_rng(15), 2, seq,
                                  cfg.d_model)}
    j_grads, t_grads = _vjp_pair(
        lambda a: JS.mamba2_apply(a["p"], a["h"], jcfg),
        lambda a: TS.mamba2_apply(a["p"], a["h"], cfg), inputs, ct_seed=16)
    _close_grads(j_grads, t_grads)


def test_mamba2_gradient_stays_finite_where_the_decay_overflows():
    """Above the diagonal of a chunk the decay exp(cum_i - cum_j) grows,
    and with large steps (dt_bias 12: ~12 per token over 16 tokens) it
    overflows f32. The reference's where() then back-propagates 0·inf =
    NaN into dt; the port masks those entries before the exp, so its
    forward is the reference's and its gradient finite."""
    name = "zamba2-1.2b"
    cfg, jcfg = reduced_config(name), j_reduced_config(name)
    p = _arrays(JS.mamba2_spec(jcfg), 17)
    p["dt_bias"] = np.full_like(p["dt_bias"], 12.0)
    p["a_log"] = np.zeros_like(p["a_log"])
    h = _randn(np.random.default_rng(18), 2, 16, cfg.d_model)
    j_in = {"p": jax.tree.map(jnp.asarray, p), "h": jnp.asarray(h)}
    out, vjp = jax.vjp(lambda a: JS.mamba2_apply(a["p"], a["h"], jcfg), j_in)
    (j_grads,) = vjp(jnp.ones_like(out))
    assert not np.isfinite(np.asarray(j_grads["p"]["dt_bias"])).all()
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    th = torch.from_numpy(h).requires_grad_(True)
    t_out = TS.mamba2_apply(tp, th, cfg)
    _close(out, t_out)
    grads = torch.autograd.grad(t_out, [th, *tp.values()],
                                torch.ones_like(t_out))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("casts", ["f32", "bf16"])
@pytest.mark.parametrize("seq", [12, 5])
def test_rwkv6_apply_vjp(seq, casts, monkeypatch):
    """The time-mix and channel-mix layer (the per-token wkv loop) through
    its output h. Both packages round the token-shift mixes to bf16 even in
    f32 (``.astype(BF16)``), so an f32 difference of an ulp at a rounding
    boundary becomes one bf16 step there, forward and backward. With those
    casts made f32 in both modules (``casts="f32"``) the bar is 1e-5; as
    built, one bf16 step of the largest entry, 2**-8. (Not one token: its
    per-head group norm divides out the r·u·k scalar, so the gradients of
    w_r, w_k and bonus_u are cancellation residues ~1e-3 of the others'.)"""
    name = "rwkv6-7b"
    cfg, jcfg = reduced_config(name), j_reduced_config(name)
    if casts == "f32":
        monkeypatch.setattr(JS, "BF16", jnp.float32)
        monkeypatch.setattr(TS, "BF16", torch.float32)
    rel = REL if casts == "f32" else 2.0 ** -8
    inputs = {"p": _arrays(JS.rwkv6_spec(jcfg), 19),
              "h": _randn(np.random.default_rng(20), 2, seq, cfg.d_model)}
    j_grads, t_grads = _vjp_pair(
        lambda a: JS.rwkv6_apply(a["p"], a["h"], jcfg),
        lambda a: TS.rwkv6_apply(a["p"], a["h"], cfg), inputs, ct_seed=21,
        out_index=0, rel=rel)
    _close_grads(j_grads, t_grads, rel)
