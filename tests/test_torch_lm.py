"""Port parity, the LM zoo's serving path: all ten architectures at their
reduced configs in bf16, the port against the reference with the reference's
own parameters loaded leaf for leaf (``lm_params_from_reference``).

For each architecture: ``train_loss``, ``prefill`` (last-position logits and
every cache leaf) and one ``decode_step`` (logits and every cache leaf),
each within the reference's own per-family bf16 tolerance
(tests/test_lm_archs.py:14: moe 0.12, hybrid 0.05, otherwise 0.02, as max
abs error over the reference's max abs value); decode against prefill
inside the port; the chunked attention path inside the model; the config
copies; the converter's checks.

    PYTHONPATH=src python tests/test_torch_lm.py

prints the observed errors per architecture.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import (ARCH_NAMES, SHAPES, applicable_shapes,
                           get_config as j_get_config,
                           reduced_config as j_reduced_config)
from repro.models.lm import LM as JLM

from repro_torch import configs as tconfigs
from repro_torch.convert import (lm_caches_from_reference,
                                 lm_params_from_reference)
from repro_torch.models.lm import LM
from repro_torch.models.spec import tree_leaves

TOL = {"moe": 0.12, "hybrid": 0.05, "default": 0.02}
B, S, MAX_SEQ = 2, 32, 64


def _tol(cfg) -> float:
    return TOL.get(cfg.family, TOL["default"])


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _rel(ref, out) -> float:
    ref, out = _f32(ref), _f32(out)
    assert ref.shape == out.shape, (ref.shape, out.shape)
    return float(np.abs(ref - out).max() / max(np.abs(ref).max(), 1e-6))


def _tree_rel(ref: dict, out: dict) -> float:
    """Max over leaves of ``_rel``; the two trees must have the same leaves."""
    rl = dict(tree_leaves(jax.tree.map(np.asarray, ref)))
    ol = dict(tree_leaves(out))
    assert sorted(rl) == sorted(ol)
    return max(_rel(rl[k], ol[k]) for k in rl)


def _inputs(cfg, seed: int = 0):
    """Tokens (B, S+1) and, for vlm/encdec, the frontend memory (bf16), as
    numpy, from one seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    mem = None
    if cfg.family in ("vlm", "encdec"):
        t = cfg.frontend_tokens or 16
        mem = (rng.standard_normal((B, t, cfg.d_model)) * 0.05).astype(
            np.float32)
    return toks, mem


def _pair(name: str, seed: int = 0):
    """(reference LM, its params, port LM on the CPU, converted params)."""
    jlm = JLM(j_reduced_config(name))
    jp = jlm.init_params(jax.random.key(seed))
    lm = LM(tconfigs.reduced_config(name), device="cpu")
    tp = lm_params_from_reference(lm, jax.tree.map(np.asarray, jp))
    return jlm, jp, lm, tp


def _run(name: str) -> dict:
    """Reference and port outputs of one architecture, and their errors."""
    jlm, jp, lm, tp = _pair(name)
    toks, mem = _inputs(lm.cfg)
    jmem = None if mem is None else jnp.asarray(mem).astype(jnp.bfloat16)
    tmem = None if mem is None else torch.from_numpy(mem).to(torch.bfloat16)
    prompt = toks[:, :S]

    batch = {"tokens": jnp.asarray(prompt), "loss_mask": jnp.ones((B, S))}
    tbatch = {"tokens": torch.from_numpy(prompt).long(),
              "loss_mask": torch.ones(B, S)}
    if mem is not None:
        batch["memory"], tbatch["memory"] = jmem, tmem
    j_loss = float(jax.jit(jlm.train_loss)(jp, batch))
    with torch.no_grad():
        t_loss = float(lm.train_loss(tp, tbatch))

    j_logits, j_caches = jax.jit(
        lambda p, t: jlm.prefill(p, t, MAX_SEQ, jmem))(jp, jnp.asarray(prompt))
    t_logits, t_caches = lm.prefill(tp, torch.from_numpy(prompt).long(),
                                    MAX_SEQ, tmem)
    out = {"loss": abs(j_loss - t_loss) / abs(j_loss),
           "prefill_logits": _rel(j_logits, t_logits),
           "prefill_caches": _tree_rel(j_caches, t_caches)}

    # one decode step of the reference's caches, loaded into the port
    nxt = toks[:, S:S + 1]
    jd_logits, jd_caches = jax.jit(
        lambda p, c, t: jlm.decode_step(p, c, t, jnp.int32(S), jmem))(
            jp, j_caches, jnp.asarray(nxt))
    td_logits, td_caches = lm.decode_step(
        tp, lm_caches_from_reference(jax.tree.map(np.asarray, j_caches),
                                     "cpu"),
        torch.from_numpy(nxt).long(), S, tmem)
    out["decode_logits"] = _rel(jd_logits, td_logits)
    out["decode_caches"] = _tree_rel(jd_caches, td_caches)

    # inside the port: decode from its own prefill against a longer prefill
    full, _ = lm.prefill(tp, torch.from_numpy(toks).long(), MAX_SEQ, tmem)
    own, _ = lm.decode_step(tp, t_caches, torch.from_numpy(nxt).long(), S,
                            tmem)
    out["port_decode_vs_prefill"] = _rel(full, own)
    return out


@pytest.fixture(scope="module", params=ARCH_NAMES)
def arch_run(request):
    name = request.param
    return name, tconfigs.reduced_config(name), _run(name)


def test_train_loss_matches_reference(arch_run):
    name, cfg, err = arch_run
    assert err["loss"] < _tol(cfg), (name, err)


def test_prefill_matches_reference(arch_run):
    name, cfg, err = arch_run
    assert err["prefill_logits"] < _tol(cfg), (name, err)
    assert err["prefill_caches"] < _tol(cfg), (name, err)


def test_decode_step_matches_reference(arch_run):
    name, cfg, err = arch_run
    assert err["decode_logits"] < _tol(cfg), (name, err)
    assert err["decode_caches"] < _tol(cfg), (name, err)


def test_port_decode_matches_its_prefill(arch_run):
    name, cfg, err = arch_run
    assert err["port_decode_vs_prefill"] < _tol(cfg), (name, err)


@pytest.mark.parametrize("name", ["llama3.2-1b", "deepseek-v2-lite-16b"])
def test_chunked_attention_inside_the_model(name):
    """A 256-token prompt is more than 2 x the reduced attn_chunk (64), so
    every attention layer takes its chunked path (4 KV chunks)."""
    cfg = tconfigs.reduced_config(name)
    assert 256 > 2 * cfg.attn_chunk and 256 % cfg.attn_chunk == 0
    jlm, jp, lm, tp = _pair(name, seed=3)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (1, 256)).astype(
        np.int32)
    j_logits, j_caches = jax.jit(lambda p, t: jlm.prefill(p, t, 256))(
        jp, jnp.asarray(toks))
    t_logits, t_caches = lm.prefill(tp, torch.from_numpy(toks).long(), 256)
    assert _rel(j_logits, t_logits) < _tol(cfg)
    assert _tree_rel(j_caches, t_caches) < _tol(cfg)


def test_steps_depth_profile_and_unroll():
    """``make_lm_prefill_step``/``make_lm_decode_step`` call the LM's
    methods; ``depth_profile`` cuts segments as the reference's does;
    ``unroll`` sets the reference's cost-extraction knobs, which change
    nothing at a prompt too short to chunk."""
    from repro_torch.launch.steps import (make_lm_decode_step,
                                          make_lm_prefill_step)
    name = "deepseek-v2-lite-16b"
    prof = {"moe_blocks": 2}
    jlm = JLM(j_reduced_config(name), depth_profile=prof)
    lm = LM(tconfigs.reduced_config(name), depth_profile=prof, device="cpu")
    assert [(g.name, g.kind, g.count, g.inner) for g in lm.segments] == \
        [(g.name, g.kind, g.count, g.inner) for g in jlm.segments]
    un = LM(tconfigs.reduced_config(name), depth_profile=prof, unroll=True,
            device="cpu")
    assert un.cfg.attn_chunk == 1 << 30 and un.cfg.moe.dispatch_chunks == 1
    tp = lm.init_params(torch.Generator().manual_seed(0))
    un.load_params(tp)
    toks = torch.randint(0, 512, (2, 9), generator=torch.Generator()
                         .manual_seed(1))
    logits, caches = make_lm_prefill_step(lm, 16)(tp, toks[:, :8])
    ref, ref_caches = un.prefill(tp, toks[:, :8], 16)
    assert torch.equal(logits, ref)
    dec, _ = make_lm_decode_step(lm)(tp, caches, toks[:, 8:], 8)
    assert torch.equal(dec, un.decode_step(tp, ref_caches, toks[:, 8:], 8)[0])


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_config_copies_equal_the_reference(name):
    ref, ours = j_get_config(name), tconfigs.get_config(name)
    assert dataclasses.asdict(ref) == dataclasses.asdict(ours)
    assert ref.param_count() == ours.param_count()
    assert dataclasses.asdict(j_reduced_config(name)) == \
        dataclasses.asdict(tconfigs.reduced_config(name))
    assert applicable_shapes(ref) == tconfigs.applicable_shapes(ours)


def test_registry_copies_equal_the_reference():
    assert tconfigs.ARCH_NAMES == ARCH_NAMES
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-2")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_and_cache_specs_match_the_reference(name):
    """Same leaves, shapes and dtypes for parameters and decode caches."""
    cfg = tconfigs.reduced_config(name)
    jlm, lm = JLM(j_reduced_config(name)), LM(cfg, device="cpu")

    def flat(tree):
        return {p: (tuple(s.shape), str(s.dtype).replace("torch.", ""))
                for p, s in tree_leaves(tree)}
    assert flat(lm.abstract_params()) == flat(jlm.abstract_params())
    assert flat(lm.abstract_cache(2, 16)) == flat(jlm.abstract_cache(2, 16))
    assert all(t.device.type == "meta"
               for _, t in tree_leaves(lm.abstract_params()))


# -------------------------------------------------------------- converter
def test_converter_rejects_missing_extra_and_misshaped_leaves():
    name = "llama3.2-1b"
    jp = jax.tree.map(np.asarray,
                      JLM(j_reduced_config(name)).init_params(
                          jax.random.key(0)))
    lm = LM(tconfigs.reduced_config(name), device="cpu")
    missing = {k: v for k, v in jp.items() if k != "final_ln"}
    with pytest.raises(ValueError, match="missing .*final_ln"):
        lm_params_from_reference(lm, missing)
    with pytest.raises(ValueError, match="left over .*extra"):
        lm_params_from_reference(lm, {**jp, "extra": np.zeros(3)})
    bad = {**jp, "blocks": {**jp["blocks"], "mlp": {
        **jp["blocks"]["mlp"], "w_up": np.zeros((4, 64, 127), np.float32)}}}
    with pytest.raises(ValueError, match="w_up"):
        lm_params_from_reference(lm, bad)
    with pytest.raises(RuntimeError, match="no parameters"):
        lm.params()
    tp = lm_params_from_reference(lm, jp)   # bf16 leaves load exactly
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(tp["embed"]), jp["embed"].astype(
        np.float32))


def test_caches_from_reference_keep_dtypes():
    tree = {"a": {"k": np.ones((2, 3), jnp.bfloat16)},
            "s": np.full((2,), 1.5, np.float32)}
    out = lm_caches_from_reference(tree, "cpu")
    assert out["a"]["k"].dtype == torch.bfloat16
    assert out["s"].dtype == torch.float32 and float(out["s"][1]) == 1.5
    tree["s"][0] = 7.0                   # copied, never shared
    assert float(out["s"][0]) == 1.5


def test_init_params_draws_from_the_generator():
    cfg = tconfigs.reduced_config("rwkv6-7b")
    a = LM(cfg, device="cpu").init_params(torch.Generator().manual_seed(5))
    b = LM(cfg, device="cpu").init_params(torch.Generator().manual_seed(5))
    for (p, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y), p
    assert a["embed"].dtype == torch.bfloat16
    assert a["blocks"]["mu_x"].dtype == torch.float32
    assert float(a["blocks"]["ln1"].float().min()) == 1.0
    assert 0.005 < float(a["embed"].float().std()) < 0.02


if __name__ == "__main__":
    for arch in ARCH_NAMES:
        cfg = tconfigs.reduced_config(arch)
        errs = _run(arch)
        print(f"{arch:24s} {cfg.family:7s} tol {_tol(cfg):.2f} "
              + " ".join(f"{k}={v:.3e}" for k, v in errs.items()), flush=True)
