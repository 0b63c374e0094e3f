"""Port parity, the LM zoo's train step: ``make_lm_train_step`` against the
reference's jitted step for each of the ten reduced architectures, with the
config's own optimizer (AdamW, or Adafactor for deepseek-v3 and
llama-3.2-vision), microbatches (up to 16) and accumulation dtype (bf16 for
deepseek-v3), from the same parameters (tests/_torch_lm.py), a fresh
optimizer state and the same batch.

In f32 parameters: loss, gradient norm, every new parameter leaf and every
optimizer-state leaf within the per-family tolerance of
tests/test_lm_archs.py:14, as ||port - ref|| / ||ref|| per leaf. In bf16,
the models' dtype: loss and gradient norm within it, and new parameters
finite. The new parameters are not compared leaf by leaf in bf16: a first
step moves each entry by about lr·sign(g) (AdamW), or by exactly that for
Adafactor on a leaf with a size-1 axis, so wherever a bf16 gradient entry
is rounding noise the two packages move it by ±lr at random; in f32 they
agree to 5e-3 or better.

Also: ``lm_opt_state_from_reference`` — two reference steps, the state and
parameters converted, then a third step in both packages.

    PYTHONPATH=src python tests/test_torch_lm_train_step.py

prints each architecture's worst leaves.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES
from repro.launch.steps import make_lm_train_step as j_make_lm_train_step
from repro.optim import make_optimizer as j_make_optimizer

from _torch_lm import (batches, leaf_errs, port_lm, ref_params, tol,
                       train_steps)

from repro_torch.configs import reduced_config
from repro_torch.convert import lm_opt_state_from_reference
from repro_torch.launch.steps import make_lm_train_step
from repro_torch.models.spec import tree_leaves
from repro_torch.optim import make_optimizer


def _errs(name: str, dtype: str) -> dict:
    cfg, (jp, js, jm), (tp, ts, tm) = train_steps(
        name, dtype, b=max(2, reduced_config(name).microbatches))
    out = {"cfg": cfg,
           "loss": abs(float(jm["loss"]) - float(tm["loss"]))
           / abs(float(jm["loss"])),
           "grad_norm": abs(float(jm["grad_norm"]) - float(tm["grad_norm"]))
           / abs(float(jm["grad_norm"])),
           "finite": all(bool(torch.isfinite(t).all())
                         for _, t in tree_leaves(tp))}
    if dtype == "f32":
        out["params"] = leaf_errs(tp, jp)
        out["state"] = leaf_errs(ts, js)
    return out


@pytest.fixture(scope="module", params=ARCH_NAMES)
def arch_steps(request):
    name = request.param
    return name, _errs(name, "f32"), _errs(name, "bf16")


def test_train_step_matches_reference_f32(arch_steps):
    name, r, _ = arch_steps
    bound = tol(r["cfg"])
    assert r["loss"] < bound and r["grad_norm"] < bound, (name, r)
    for kind in ("params", "state"):
        worst = max(r[kind].items(), key=lambda kv: kv[1])
        assert worst[1] < bound, (name, kind, worst)


def test_train_step_matches_reference_bf16(arch_steps):
    name, _, r = arch_steps
    bound = tol(r["cfg"])
    assert r["loss"] < bound and r["grad_norm"] < bound, (name, r)
    assert r["finite"], name


@pytest.mark.parametrize("opt_name", ["adamw", "adamw8bit", "adafactor"])
def test_opt_state_from_reference_continues_a_run(opt_name):
    """Two reference steps, then the state and parameters converted (int8
    codes and the int32 count keep their dtypes): a third step in both
    packages agrees as one f32 step does, 1e-4 per leaf in norm; 1e-3 for
    AdamW-8bit, whose codes may move by one at a rounding tie (one
    quantization step of that entry's moment, tests/test_torch_optim.py)."""
    name = "llama3.2-1b"
    jlm, jp = ref_params(name, "f32")
    lm, _ = port_lm(name, jp)
    j_opt, t_opt = j_make_optimizer(opt_name, lr=3e-3), \
        make_optimizer(opt_name, lr=3e-3)
    j_step = jax.jit(j_make_lm_train_step(jlm, j_opt))
    js = j_opt.init(jp, jlm.params_spec())
    for i in range(2):
        jp, js, _ = j_step(jp, js, batches(lm.cfg, 2, 16, "f32", seed=i)[0])
    ts = lm_opt_state_from_reference(lm, opt_name,
                                     jax.tree.map(np.asarray, js))
    for (p, t), (_, r) in zip(tree_leaves(ts), tree_leaves(
            jax.tree.map(np.asarray, js))):
        assert str(t.dtype).replace("torch.", "") == r.dtype.name, p
    _, tp = port_lm(name, jp)
    jb, tb = batches(lm.cfg, 2, 16, "f32", seed=2)
    jp, js, jm = j_step(jp, js, jb)
    tp, ts, tm = make_lm_train_step(lm, t_opt)(tp, ts, tb)
    assert int(ts["count"]) == int(js["count"]) == 3
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
    bar = 1e-3 if opt_name == "adamw8bit" else 1e-4
    assert max(leaf_errs(tp, jp).values()) <= bar
    errs = leaf_errs(ts, js)
    codes = {p for p in errs if p[0] in ("m_q", "v_q")}
    assert max(e for p, e in errs.items() if p not in codes) <= bar, errs
    for p in codes:     # int8 codes: equal but for moves of one
        t, r = dict(tree_leaves(ts))[p], dict(tree_leaves(
            jax.tree.map(np.asarray, js)))[p]
        assert np.abs(t.numpy().astype(int) - r.astype(int)).max() <= 1, p


def test_opt_state_converter_refuses_missing_extra_and_misshaped_leaves():
    name = "llama3.2-1b"
    jlm, jp = ref_params(name, "f32")
    lm, _ = port_lm(name, jp)
    js = jax.tree.map(np.asarray, j_make_optimizer("adamw").init(
        jp, jlm.params_spec()))
    with pytest.raises(ValueError, match="missing .*'master'"):
        lm_opt_state_from_reference(lm, "adamw", {k: v for k, v in js.items()
                                                  if k != "master"})
    with pytest.raises(ValueError, match="left over .*extra"):
        lm_opt_state_from_reference(lm, "adamw", {**js, "extra": np.zeros(2)})
    bad = {**js, "count": np.zeros((), np.float32)}
    with pytest.raises(ValueError, match="count"):
        lm_opt_state_from_reference(lm, "adamw", bad)
    bad = {**js, "m": {**js["m"], "final_ln": np.zeros((3,), np.float32)}}
    with pytest.raises(ValueError, match="final_ln"):
        lm_opt_state_from_reference(lm, "adamw", bad)
    with pytest.raises(ValueError, match="missing"):
        lm_opt_state_from_reference(lm, "adafactor", js)


if __name__ == "__main__":
    for arch in ARCH_NAMES:
        r, rb = _errs(arch, "f32"), _errs(arch, "bf16")
        worst = {k: max(r[k].items(), key=lambda kv: kv[1])
                 for k in ("params", "state")}
        print(f"{arch:24s} tol {tol(r['cfg']):.2f} f32: loss {r['loss']:.2e} "
              f"gnorm {r['grad_norm']:.2e} "
              + " ".join(f"{k} {'/'.join(p)} {e:.2e}"
                         for k, (p, e) in worst.items())
              + f"; bf16: loss {rb['loss']:.2e} gnorm {rb['grad_norm']:.2e}",
              flush=True)
