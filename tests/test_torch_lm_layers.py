"""Port parity, LM primitives and blocks at f32: each port function against
its reference namesake on the same numpy arrays (made from a seed).

Tolerance: max abs error ≤ 1e-5 of the output's max abs value (the same
f32 arithmetic, summed in another order). The explicit bf16 casts that the
reference keeps at f32 (RWKV6's token-shift mixes) round the same values in
both packages. Matmuls run in full f32 (TF32 off, as set below).
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


def _close_tree(ref: dict, out: dict, rel: float = REL) -> None:
    assert sorted(ref) == sorted(out)
    for k in ref:
        _close(ref[k], out[k], rel)


def _arrays(spec: dict, seed: int) -> dict:
    """f32 numpy values for a reference PSpec tree: normal(0, 0.2) for
    weights, 1 + normal(0, 0.1) for "ones" leaves and normal(0, 0.5) for
    "zeros" ones (so decays, biases, mixes and gates are all exercised)."""
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


def _both(tree: dict):
    """(jax tree, torch tree) of one numpy tree."""
    j = jax.tree.map(jnp.asarray, tree)
    t = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    return j, t


def _randn(rng, *shape, scale=1.0) -> np.ndarray:
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------- primitives
def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x, s = _randn(rng, 2, 7, 4, 16), _randn(rng, 16)
    _close(JL.rms_norm(jnp.asarray(x), jnp.asarray(s)),
           TL.rms_norm(torch.from_numpy(x), torch.from_numpy(s)))
    pos = np.broadcast_to(np.arange(7, dtype=np.int32) * 3, (2, 7))
    _close(JL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0),
           TL.rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), 10_000.0))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_heads", [4, 2, 1])
@pytest.mark.parametrize("kv_chunk", [0, 4])
def test_attention(causal, kv_heads, kv_chunk):
    rng = np.random.default_rng(1)
    q = _randn(rng, 2, 16, 4, 8)
    k, v = _randn(rng, 2, 16, kv_heads, 8), _randn(rng, 2, 16, kv_heads, 8)
    ref = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, kv_chunk=kv_chunk)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = TL.attention(tq, tk, tv, causal=causal, kv_chunk=kv_chunk)
    _close(ref, out)
    # the port's chunked path equals its unchunked one
    _close(TL.attention(tq, tk, tv, causal=causal, kv_chunk=0), out)


@pytest.mark.parametrize("kv_chunk", [0, 8])
def test_attention_mla_scale_and_value_width(kv_chunk):
    """MLA's call: q/k width 12 (nope + rope), values of width 8, an
    explicit softmax scale."""
    rng = np.random.default_rng(2)
    q, k, v = _randn(rng, 2, 16, 4, 12), _randn(rng, 2, 16, 4, 12), \
        _randn(rng, 2, 16, 4, 8)
    scale = 1.0 / np.sqrt(12)
    ref = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=True, kv_chunk=kv_chunk, softmax_scale=scale)
    out = TL.attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                       kv_chunk=kv_chunk, softmax_scale=scale)
    _close(ref, out)


def test_attention_chunk_must_divide_length():
    x = torch.zeros(1, 12, 2, 4)
    with pytest.raises(ValueError, match="multiple of kv_chunk"):
        TL.attention(x, x, x, causal=True, kv_chunk=5)


@pytest.mark.parametrize("length", [1, 7, 12])
def test_decode_attention(length):
    rng = np.random.default_rng(3)
    q = _randn(rng, 2, 1, 4, 8)
    kc, vc = _randn(rng, 2, 12, 2, 8), _randn(rng, 2, 12, 2, 8)
    ref = JL.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                              jnp.int32(length))
    out = TL.decode_attention(*map(torch.from_numpy, (q, kc, vc)), length)
    _close(ref, out)


def test_swiglu_and_cross_entropy():
    rng = np.random.default_rng(4)
    x, wg, wu, wd = (_randn(rng, 2, 5, 16), _randn(rng, 16, 32),
                     _randn(rng, 16, 32), _randn(rng, 32, 16))
    _close(JL.swiglu(*map(jnp.asarray, (x, wg, wu, wd))),
           TL.swiglu(*map(torch.from_numpy, (x, wg, wu, wd))))
    logits = _randn(rng, 2, 5, 64, scale=3.0)
    targets = rng.integers(0, 40, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.7).astype(np.float32)
    ref = JL.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                   jnp.asarray(mask), 40)
    out = TL.softmax_cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(targets),
                                   torch.from_numpy(mask), 40)
    _close(np.asarray(ref)[None], out[None])


# ---------------------------------------------------------------- blocks
def _ctx_pair(b, s, memory=None):
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    jm = None if memory is None else jnp.asarray(memory)
    tm = None if memory is None else torch.from_numpy(memory)
    return (JB.Ctx(positions=jnp.asarray(pos), length=jnp.int32(0), memory=jm),
            TB.Ctx(positions=torch.from_numpy(pos), length=0, memory=tm))


@pytest.mark.parametrize("name", ["qwen2.5-32b", "llama3.2-1b"])
def test_attention_block_prefill_and_decode(name):
    """attn_apply / attn_prefill_cache / attn_decode (GQA; Qwen's qkv
    bias) at f32."""
    cfg, jcfg = reduced_config(name), j_reduced_config(name)
    jp, tp = _both(_arrays(JB.attn_spec(jcfg), 10))
    rng = np.random.default_rng(5)
    h = _randn(rng, 2, 9, cfg.d_model)
    jc, tc = _ctx_pair(2, 9)
    jh, th = jnp.asarray(h), torch.from_numpy(h)
    _close(JB.attn_apply(jp, jh, jc, jcfg), TB.attn_apply(tp, th, tc, cfg))
    jo, jcache = JB.attn_prefill_cache(jp, jh, jc, jcfg, 16)
    to, tcache = TB.attn_prefill_cache(tp, th, tc, cfg, 16)
    _close(jo, to)
    _close_tree(jcache, tcache)
    h1 = _randn(rng, 2, 1, cfg.d_model)
    jo, jcache = JB.attn_decode(jp, jnp.asarray(h1), jcache,
                                jc._replace(length=jnp.int32(9)), jcfg)
    to, tcache = TB.attn_decode(tp, torch.from_numpy(h1), tcache,
                                tc._replace(length=9), cfg)
    _close(jo, to)
    _close_tree(jcache, tcache)


def test_cross_attention_block():
    name = "llama-3.2-vision-90b"
    cfg, jcfg = reduced_config(name), j_reduced_config(name)
    jp, tp = _both(_arrays(JB.cross_attn_spec(jcfg), 11))
    rng = np.random.default_rng(6)
    h, mem = _randn(rng, 2, 5, cfg.d_model), _randn(rng, 2, 16, cfg.d_model)
    jc, tc = _ctx_pair(2, 5, mem)
    _close(JB.cross_attn_apply(jp, jnp.asarray(h), jc, jcfg),
           TB.cross_attn_apply(tp, torch.from_numpy(h), tc, cfg))


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "deepseek-v3-671b"])
def test_mla_prefill_and_absorbed_decode(name):
    """mla_apply / mla_prefill_cache and the absorbed mla_decode (V3: with
    query compression) at f32."""
    cfg, jcfg = reduced_config(name), j_reduced_config(name)
    jp, tp = _both(_arrays(JB.mla_spec(jcfg), 12))
    rng = np.random.default_rng(7)
    h = _randn(rng, 2, 11, cfg.d_model)
    jc, tc = _ctx_pair(2, 11)
    jo, jcache = JB.mla_prefill_cache(jp, jnp.asarray(h), jc, jcfg, 16)
    to, tcache = TB.mla_prefill_cache(tp, torch.from_numpy(h), tc, cfg, 16)
    _close(jo, to)
    _close_tree(jcache, tcache)
    _close(JB.mla_apply(jp, jnp.asarray(h), jc, jcfg),
           TB.mla_apply(tp, torch.from_numpy(h), tc, cfg))
    # decode over f32 caches, so no bf16 rounding sits between the two
    cache = {k: _randn(rng, 2, 16, v.shape[-1]) for k, v in jcache.items()}
    h1 = _randn(rng, 2, 1, cfg.d_model)
    jo, jcache = JB.mla_decode(jp, jnp.asarray(h1),
                               jax.tree.map(jnp.asarray, cache),
                               jc._replace(length=jnp.int32(11)), jcfg)
    to, tcache = TB.mla_decode(tp, torch.from_numpy(h1),
                               {k: torch.from_numpy(v) for k, v in cache.items()},
                               tc._replace(length=11), cfg)
    _close(jo, to)
    _close_tree(jcache, tcache)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("batch", [4, 3])
def test_moe_apply_stable_dispatch_and_capacity_drop(capacity_factor, batch):
    """Stable-sort group dispatch with the reference's capacity; at 0.5 the
    capacity drops assignments (checked), and 2 dispatch chunks over 4 rows
    (3 over 3) give the same answer as the reference."""
    name = "deepseek-v2-lite-16b"
    jcfg = j_reduced_config(name)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity_factor))
    cfg = reduced_config(name)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    jp, tp = _both(_arrays(JB.moe_spec(jcfg), 13))
    rng = np.random.default_rng(8)
    s = 16
    h = _randn(rng, batch, s, cfg.d_model)
    _close(JB.moe_apply(jp, jnp.asarray(h), jcfg),
           TB.moe_apply(tp, torch.from_numpy(h), cfg))
    # how many assignments the capacity keeps (the top-k choice of the port)
    x = TL.rms_norm(torch.from_numpy(h), tp["ln"], cfg.norm_eps)
    eidx = torch.topk(torch.softmax(x @ tp["router"], -1), cfg.moe.top_k)[1]
    counts = torch.stack([torch.bincount(e.flatten(), minlength=8) for e in eidx])
    cap = TB.moe_capacity(cfg, s)
    dropped = int((counts - cap).clamp(min=0).sum())
    if capacity_factor < 1:
        assert dropped > 0, (dropped, cap)


def test_moe_capacity_matches_reference_formula():
    for name in ("deepseek-v2-lite-16b", "deepseek-v3-671b"):
        from repro_torch.configs import get_config
        cfg = get_config(name)
        mo = cfg.moe
        for s in (1, 2, 7, 512, 2047):
            want = int(np.ceil(s * mo.top_k * mo.capacity_factor
                               / mo.num_experts / 4.0)) * 4
            assert TB.moe_capacity(cfg, s) == max(want, min(mo.top_k,
                                                            s * mo.top_k))


@pytest.mark.parametrize("seq", [16, 21, 3])
def test_mamba2_apply_and_decode(seq):
    """Chunked SSD with its inter-chunk scan (chunk 16: one whole chunk, a
    padded second chunk, a prompt as long as the conv window), its cache,
    and a recurrent decode step from that cache."""
    name = "zamba2-1.2b"
    cfg, jcfg = reduced_config(name), j_reduced_config(name)
    arrays = _arrays(JS.mamba2_spec(jcfg), 14)
    arrays["a_log"] = arrays["a_log"] - 1.0      # decays well inside (0, 1)
    jp, tp = _both(arrays)
    rng = np.random.default_rng(9)
    h = _randn(rng, 2, seq, cfg.d_model)
    jo, jcache = JS.mamba2_apply(jp, jnp.asarray(h), jcfg, return_cache=True)
    to, tcache = TS.mamba2_apply(tp, torch.from_numpy(h), cfg,
                                 return_cache=True)
    _close(jo, to)
    _close_tree(jcache, tcache)
    h1 = _randn(rng, 2, 1, cfg.d_model)
    jo, jcache = JS.mamba2_decode(jp, jnp.asarray(h1), jcache, jcfg)
    to, tcache = TS.mamba2_decode(tp, torch.from_numpy(h1), tcache, cfg)
    _close(jo, to)
    _close_tree(jcache, tcache)


def test_mamba2_prompt_shorter_than_conv_window():
    """With 2 prompt tokens (conv window 3) the reference's cache keeps one
    conv row and its decode step raises; the port keeps zeros before the
    prompt, so its decode continues the prefill of 3 tokens."""
    name = "zamba2-1.2b"
    cfg, jcfg = reduced_config(name), j_reduced_config(name)
    arrays = _arrays(JS.mamba2_spec(jcfg), 14)
    jp, tp = _both(arrays)
    rng = np.random.default_rng(11)
    h = _randn(rng, 2, 3, cfg.d_model)
    _, jcache = JS.mamba2_apply(jp, jnp.asarray(h[:, :2]), jcfg,
                                return_cache=True)
    assert jcache["conv"].shape[1] == 1
    with pytest.raises(ValueError):
        JS.mamba2_decode(jp, jnp.asarray(h[:, 2:]), jcache, jcfg)
    full = TS.mamba2_apply(tp, torch.from_numpy(h), cfg)
    _, tcache = TS.mamba2_apply(tp, torch.from_numpy(h[:, :2]), cfg,
                                return_cache=True)
    assert tcache["conv"].shape[1] == cfg.ssm.d_conv - 1
    out, _ = TS.mamba2_decode(tp, torch.from_numpy(h[:, 2:]), tcache, cfg)
    _close(full[:, 2:], out)


@pytest.mark.parametrize("seq", [12, 1])
def test_rwkv6_apply_and_decode(seq):
    name = "rwkv6-7b"
    cfg, jcfg = reduced_config(name), j_reduced_config(name)
    jp, tp = _both(_arrays(JS.rwkv6_spec(jcfg), 15))
    rng = np.random.default_rng(10)
    h = _randn(rng, 2, seq, cfg.d_model)
    jout = JS.rwkv6_apply(jp, jnp.asarray(h), jcfg)
    tout = TS.rwkv6_apply(tp, torch.from_numpy(h), cfg)
    for a, b in zip(jout, tout):
        _close(a, b)
    cache = {"state": _randn(rng, 2, cfg.n_heads, cfg.dh, cfg.dh),
             "last1": _randn(rng, 2, cfg.d_model),
             "last2": _randn(rng, 2, cfg.d_model)}
    h1 = _randn(rng, 2, 1, cfg.d_model)
    jo, jcache = JS.rwkv6_decode(jp, jnp.asarray(h1),
                                 jax.tree.map(jnp.asarray, cache), jcfg)
    to, tcache = TS.rwkv6_decode(tp, torch.from_numpy(h1),
                                 {k: torch.from_numpy(v.copy())
                                  for k, v in cache.items()}, cfg)
    _close(jo, to)
    _close_tree(jcache, tcache)
