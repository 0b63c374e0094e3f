"""Port parity, the LM zoo's training gradients: ``train_loss``'s gradient
for each of the ten reduced architectures against ``jax.grad`` of the
reference's, from the same parameters (tests/_torch_lm.py: the reference's
own, constant leaves moved off their constants) and batch.

Bar: every leaf within the per-family tolerance of tests/test_lm_archs.py:14
(moe 0.12, hybrid 0.05, otherwise 0.02), as ||port - ref|| / ||ref||, in
bf16, the models' dtype. Two rules, each stated where it applies:

* A leaf whose reference bf16 gradient is itself past the tolerance from
  the reference's f32 gradient (of the same bf16-rounded values) is held to
  that f32 gradient instead: the cross-attention gates, (1,) leaves whose
  gradient is one bf16 reduction over B·S·d products (the reference's is
  ~0.15 off its own f32 gradient, the port's ~1e-3), and qwen2.5's key
  bias (0.022 off; the port 0.016).
* Three architectures are held in f32 parameters (F32_ARCHS, each with
  its numbers): the two MoE ones, where bf16 rounding flips expert
  choices, and RWKV6, whose reference bf16 gradients are farther from the
  reference's own f32 gradients than the tolerance, so no bf16 comparison
  can hold it. In f32 every leaf agrees to 4e-3 or better.

Also: the chunked attention path (seq 192 > 2 x attn_chunk), remat
"full"/"dots"/"none" giving bit-equal gradients, and ``microbatches=n``
against one microbatch on the same batch.

    PYTHONPATH=src python tests/test_torch_lm_train.py

prints each architecture's worst leaves.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES

from _torch_lm import (batches, leaf_errs, norm_rel, port_grads, port_lm,
                       ref_grads, ref_params, tol)

from repro_torch import configs as tconfigs
from repro_torch.launch.steps import make_lm_train_step
from repro_torch.models.spec import tree_leaves
from repro_torch.optim import sgd

# arch -> why its gradients are compared in f32 parameters
F32_ARCHS = {
    "deepseek-v2-lite-16b": "routing flips: the reference's bf16 expert "
                            "gradients are 0.18-0.22 off its own f32 ones",
    "deepseek-v3-671b": "routing flips: the port's bf16 router gradient is "
                        "0.131 off the reference's, whose own is 0.118 off "
                        "its f32 one",
    "rwkv6-7b": "the wkv recurrence's bf16 rounding: the reference's bf16 "
                "gradients of mu_x, bonus_u and the decay LoRA are 0.043-"
                "0.046 off its own f32 ones",
}
S = 32


def _run(name: str) -> dict:
    """Gradients of both packages for one architecture, and their errors
    per leaf (against the f32 reference where the first rule applies)."""
    dtype = "f32" if name in F32_ARCHS else "bf16"
    jlm, jp = ref_params(name, dtype)
    lm, tp = port_lm(name, jp)
    b = max(2, lm.cfg.microbatches)
    jb, tb = batches(lm.cfg, b, S, dtype)
    j_loss, jg = ref_grads(jlm, jp, jb)
    t_loss, tg = port_grads(lm, tp, tb)
    errs = leaf_errs(tg, jg)
    bound = tol(lm.cfg)
    over = [p for p, e in errs.items() if e > bound]
    via_f32 = {}
    if over and dtype == "bf16":
        jlm32, jp32 = ref_params(name, "f32")
        _, jg32 = ref_grads(jlm32, jp32, batches(lm.cfg, b, S, "f32")[0])
        ref_vs_f32 = leaf_errs(jax.tree.map(np.asarray, jg), jg32)
        port_vs_f32 = leaf_errs(tg, jg32)
        for p in over:
            via_f32[p] = (ref_vs_f32[p], port_vs_f32[p])
    return {"cfg": lm.cfg, "dtype": dtype, "errs": errs, "via_f32": via_f32,
            "loss": abs(j_loss - float(t_loss)) / abs(j_loss),
            "leaves": len(errs),
            "nonzero": sum(bool(g.abs().max() > 0)
                           for _, g in tree_leaves(tg))}


@pytest.fixture(scope="module", params=ARCH_NAMES)
def arch_run(request):
    return request.param, _run(request.param)


def test_train_loss_grads_match_reference(arch_run):
    name, r = arch_run
    bound = tol(r["cfg"])
    assert r["loss"] < bound, (name, r["loss"])
    for p, e in r["errs"].items():
        if e <= bound:
            continue
        # the first rule: the reference's own bf16 gradient is past the
        # bar from its f32 gradient, and the port's is within it
        assert p in r["via_f32"], (name, p, e)
        ref_vs_f32, port_vs_f32 = r["via_f32"][p]
        assert ref_vs_f32 > bound and port_vs_f32 <= bound, \
            (name, p, e, ref_vs_f32, port_vs_f32)


def test_gradients_reach_every_leaf(arch_run):
    """Every leaf gets a nonzero gradient (all parameters take part in the
    loss once the gates are open)."""
    name, r = arch_run
    assert r["nonzero"] == r["leaves"], name


@pytest.mark.parametrize("name", ["llama3.2-1b", "deepseek-v2-lite-16b"])
def test_chunked_attention_gradients(name):
    """Seq 192 > 2 x the reduced attn_chunk (64): every attention layer
    takes the chunked path (3 KV chunks), each chunk rematerialized in the
    backward; f32 parameters, so the bar is the f32 one of the blocks
    (1e-5 of the leaf's norm, times 10 for a 4-layer model)."""
    cfg = tconfigs.reduced_config(name)
    assert 192 > 2 * cfg.attn_chunk and 192 % cfg.attn_chunk == 0
    jlm, jp = ref_params(name, "f32", seed=3)
    lm, tp = port_lm(name, jp)
    jb, tb = batches(cfg, 2, 192, "f32", seed=4)
    _, jg = ref_grads(jlm, jp, jb)
    _, tg = port_grads(lm, tp, tb)
    errs = leaf_errs(tg, jg)
    assert max(errs.values()) < 1e-4, errs


@pytest.mark.parametrize("name", ["llama3.2-1b", "deepseek-v2-lite-16b",
                                  "zamba2-1.2b", "llama-3.2-vision-90b"])
def test_remat_policies_give_bit_equal_gradients(name):
    """remat "full" (each stacked step checkpointed), "dots" (matmul
    outputs kept) and "none" on the CPU: the backward recomputes the same
    ops on the same values, so the gradients are equal bit for bit. The
    chunked attention's and the MoE dispatch's own remat run in all
    three (seq 192, two dispatch chunks)."""
    base = tconfigs.reduced_config(name)
    _, jp = ref_params(name, "bf16", seed=5)
    grads = {}
    for remat in ("none", "full", "dots"):
        lm, tp = port_lm(name, jp, cfg=dataclasses.replace(base, remat=remat))
        tb = batches(base, 2, 192, "bf16", seed=6)[1]
        loss, g = port_grads(lm, tp, tb)
        grads[remat] = (loss, dict(tree_leaves(g)))
    loss0, g0 = grads["none"]
    for remat in ("full", "dots"):
        loss, g = grads[remat]
        assert torch.equal(loss, loss0), remat
        for p in g0:
            assert torch.equal(g[p], g0[p]), (remat, p)


@pytest.mark.parametrize("name,n_mb", [("llama3.2-1b", 4),
                                       ("zamba2-1.2b", 4),
                                       ("deepseek-v2-lite-16b", 2)])
def test_microbatches_match_one_batch(name, n_mb):
    """``microbatches=n`` accumulates n gradients of B/n rows and divides
    by n: with a full loss mask every microbatch holds the same number of
    targets, so this is the one-batch step's loss and update (f32
    parameters, sgd: the update is the clipped gradient; 1e-5 relative)."""
    base = tconfigs.reduced_config(name)
    _, jp = ref_params(name, "f32", seed=7)
    tb = batches(base, 4, 16, "f32", seed=8)[1]
    out = {}
    for mb in (1, n_mb):
        lm, tp = port_lm(name, jp, cfg=dataclasses.replace(base,
                                                           microbatches=mb))
        opt = sgd(lr=0.5)
        out[mb] = make_lm_train_step(lm, opt)(tp, opt.init(tp), tb)
    (p1, s1, m1), (pn, sn, mn) = out[1], out[n_mb]
    assert abs(float(m1["loss"]) - float(mn["loss"])) <= 1e-5 * float(m1["loss"])
    assert abs(float(m1["grad_norm"]) - float(mn["grad_norm"])) <= \
        1e-5 * float(m1["grad_norm"])
    a, b = dict(tree_leaves(s1["mom"])), dict(tree_leaves(sn["mom"]))
    for p in a:
        assert norm_rel(b[p], a[p]) <= 1e-5, p
    a, b = dict(tree_leaves(p1)), dict(tree_leaves(pn))
    for p in a:
        assert norm_rel(b[p], a[p]) <= 1e-5, p


def test_microbatches_must_divide_the_batch():
    """The reference fails inside a reshape (examples/train_lm.py's default
    --batch 8 against deepseek-v3's 16 microbatches); the port names both
    numbers."""
    cfg = tconfigs.reduced_config("deepseek-v3-671b")
    assert cfg.microbatches == 16
    _, jp = ref_params("deepseek-v3-671b", "bf16")
    lm, tp = port_lm("deepseek-v3-671b", jp)
    opt = sgd()
    step = make_lm_train_step(lm, opt)
    with pytest.raises(ValueError, match="batch of 8 rows .*microbatches=16"):
        step(tp, opt.init(tp), batches(cfg, 8, 16)[1])


def test_lm_params_stay_frozen_for_serving():
    """The LM's own parameters do not require grad; the train step
    differentiates detached copies and leaves them as they were."""
    name = "llama3.2-1b"
    _, jp = ref_params(name, "bf16")
    lm, tp = port_lm(name, jp)
    before = {p: t.clone() for p, t in tree_leaves(tp)}
    assert not any(t.requires_grad for _, t in tree_leaves(lm.params()))
    opt = sgd(lr=0.1)
    new, _, m = make_lm_train_step(lm, opt)(tp, opt.init(tp),
                                            batches(lm.cfg, 2, 16)[1])
    assert np.isfinite(float(m["loss"]))
    for p, t in tree_leaves(tp):
        assert torch.equal(t, before[p]) and not t.requires_grad
    assert not any(t.requires_grad for _, t in tree_leaves(new))
    assert any(not torch.equal(t, before[p]) for p, t in tree_leaves(new))


if __name__ == "__main__":
    for arch in ARCH_NAMES:
        r = _run(arch)
        worst = sorted(r["errs"].items(), key=lambda kv: -kv[1])[:3]
        print(f"{arch:24s} {r['cfg'].family:7s} {r['dtype']} tol "
              f"{tol(r['cfg']):.2f} loss {r['loss']:.2e} worst "
              + ", ".join(f"{'/'.join(p)} {e:.2e}" for p, e in worst)
              + "".join(f"; {'/'.join(p)} vs f32: ref {a:.2e} port {b:.2e}"
                        for p, (a, b) in r["via_f32"].items()), flush=True)
