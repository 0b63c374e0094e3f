"""Shared inputs of the port's LM training parity tests: the reference's
parameters with their constant leaves moved off their constants, a batch
from one numpy seed, and the gradients and train step of either package.

Both packages get the same values: the reference's ``init_params``, then
every leaf its spec initializes as zeros (biases, gates, decays, mixes) set
to 0.5·N(0, 1) and every "ones" leaf (norm scales, skips) to 1 + 0.1·N(0, 1),
from one numpy seed, rounded to the leaf's dtype. So the cross-attention
gates are open (their weights get gradients), and no leaf's first update is
the whole of its value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.launch.steps import make_lm_train_step as j_make_lm_train_step
from repro.models.lm import LM as JLM
from repro.models.spec import PSpec
from repro.optim import make_optimizer as j_make_optimizer

from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch.steps import make_lm_train_step
from repro_torch.models.lm import LM
from repro_torch.models.spec import tree_leaves, tree_map
from repro_torch.optim import make_optimizer

TOL = {"moe": 0.12, "hybrid": 0.05, "default": 0.02}   # test_lm_archs.py:14


def tol(cfg) -> float:
    return TOL.get(cfg.family, TOL["default"])


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def norm_rel(out, ref) -> float:
    """||out - ref|| / ||ref|| over one leaf."""
    out, ref = f32(out), f32(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.linalg.norm(out - ref) / max(np.linalg.norm(ref), 1e-30))


def leaf_errs(out: dict, ref: dict) -> dict:
    """{path: norm_rel} over the leaves of two trees with the same leaves
    (the reference's as jax or numpy arrays)."""
    o = dict(tree_leaves(out))
    r = dict(tree_leaves(jax.tree.map(np.asarray, ref)))
    assert sorted(o) == sorted(r), (sorted(o), sorted(r))
    return {p: norm_rel(o[p], r[p]) for p in r}


def ref_params(name: str, dtype: str = "bf16", seed: int = 0, cfg=None):
    """(reference LM, its parameters) for ``name``'s reduced config (or
    ``cfg``), constant leaves moved off their constants; ``dtype="f32"``
    casts every leaf to f32."""
    jlm = JLM(cfg or j_reduced_config(name))
    jp = jlm.init_params(jax.random.key(seed))
    rng = np.random.default_rng(seed)

    def move(s, a):
        if s.init == "zeros":
            z = 0.5 * rng.standard_normal(s.shape)
        elif s.init == "ones":
            z = 1 + 0.1 * rng.standard_normal(s.shape)
        else:
            return a
        return jnp.asarray(z, jnp.float32).astype(s.dtype)
    jp = jax.tree.map(move, jlm.params_spec(), jp,
                      is_leaf=lambda x: isinstance(x, PSpec))
    if dtype == "f32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jlm, jp


def port_lm(name: str, jp, cfg=None, **kw):
    """(port LM on the CPU, the reference's parameters in it, leaf dtypes
    kept: f32 trees load as f32, bf16 ones as bf16)."""
    lm = LM(cfg or tconfigs.reduced_config(name), device="cpu", **kw)
    leaves = dict(tree_leaves(jax.tree.map(np.asarray, jp)))
    if all(v.dtype == np.float32 for v in leaves.values()):
        return lm, tree_map(lambda a: torch.from_numpy(np.array(a)),
                            jax.tree.map(np.asarray, jp))
    return lm, lm_params_from_reference(lm, jax.tree.map(np.asarray, jp))


def batches(cfg, b: int, s: int, dtype: str = "bf16", seed: int = 0):
    """(reference batch, port batch): tokens (b, s), loss_mask ones and,
    for vlm/encdec, a frontend memory 0.05·N(0, 1) (bf16 unless f32)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks),
          "loss_mask": jnp.ones((b, s), jnp.float32)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "loss_mask": torch.ones(b, s)}
    if cfg.family in ("vlm", "encdec"):
        t = cfg.frontend_tokens or 16
        mem = (rng.standard_normal((b, t, cfg.d_model)) * 0.05).astype(
            np.float32)
        if dtype == "f32":
            jb["memory"], tb["memory"] = jnp.asarray(mem), torch.from_numpy(mem)
        else:
            jb["memory"] = jnp.asarray(mem).astype(jnp.bfloat16)
            tb["memory"] = torch.from_numpy(mem).to(torch.bfloat16)
    return jb, tb


def _with_leaves(tree: dict, leaves) -> dict:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def port_grads(lm, params, batch):
    """(loss, gradient tree) of the port's ``train_loss``."""
    leaves = [t.detach().requires_grad_(True) for _, t in tree_leaves(params)]
    loss = lm.train_loss(_with_leaves(params, leaves), batch)
    return loss.detach(), _with_leaves(params,
                                       torch.autograd.grad(loss, leaves))


def ref_grads(jlm, jp, jb):
    """(loss, gradient tree) of the reference's jitted ``train_loss``."""
    loss, g = jax.jit(jax.value_and_grad(jlm.train_loss))(jp, jb)
    return float(loss), g


def train_steps(name: str, dtype: str, b: int, s: int = 32):
    """One train step of each package from the same parameters, optimizer
    state (the config's optimizer, fresh) and batch: returns
    (cfg, reference (params, state, metrics), port (params, state,
    metrics))."""
    jlm, jp = ref_params(name, dtype)
    lm, tp = port_lm(name, jp)
    cfg = lm.cfg
    jb, tb = batches(cfg, b, s, dtype)
    j_opt, t_opt = j_make_optimizer(cfg.optimizer), make_optimizer(cfg.optimizer)
    j_state = j_opt.init(jp, jlm.params_spec())
    jout = jax.jit(j_make_lm_train_step(jlm, j_opt))(jp, j_state, jb)
    tout = make_lm_train_step(lm, t_opt)(tp, t_opt.init(tp), tb)
    return cfg, jout, tout
