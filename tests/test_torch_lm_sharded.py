"""The port's LM steps on a device mesh (``launch.steps.build_cell``)
against its plain steps on one process, and the MoE's mesh-dependent
dispatch against the reference's SPMD step.

Two meshes of four gloo ranks, (2, 2) over ("data", "model") and (2, 2, 1)
over ("pod", "data", "model"): three spawns, one after the other
(``tests/_torch_lm_dist.py``, which imports no JAX), each running its cases
in turn and joined on progress (``tests/_torch_ranks.py``: a spawn fails
when a rank exits non-zero or no rank beats its heartbeat for ``JOIN_S``
seconds, never for being slow). Every reduced arch (on the 3-axis mesh all
but the four in ``SLOW_3D``) takes one train step in f32 parameters from the reference's weights
(``_torch_lm.ref_params``, constants moved off their constants), cut to two
layers and at most 2 microbatches; qwen2.5 and llama3.2 prefill and decode one token with
the caches placed by ``cache_spec`` (both decode steps start from the
plain prefill's caches). The bars are PR 16's for reordered f32 sums: loss
rtol 1e-4, every leaf's gradient, new parameters and the prefill logits
2e-4 in norm; where a bf16 rounding follows the reordered sum, one bf16
step: rwkv6's gradients (its time-mix streams are bf16) 1e-3, the prefill's
bf16 caches and decode's logits (bf16 caches and probabilities) 1e-2.

rwkv6's bar is RWKV_RTOL or, when larger, twice what the reference's own
step shows on the same (2, 2) mesh: its SPMD gradient against its plain
gradient, on the same inputs, measured in the reference's subprocess.

The MoE case: deepseek-v2-lite with a batch of 2 rows, for which the
dispatch chunk count is 2 on one process and 1 on the (2, 2) mesh (the
reference's rule, ``repro/models/blocks.py:463``), against the reference's
own jitted step on a (2, 2) mesh of 4 XLA host devices.

The streamed Adafactor case: llama3.2-1b with Adafactor and
``stream_bytes`` lowered so that its layer stacks and embed take the
streamed update, on the (2, 2) mesh against the plain step, with the
elements its update all-gathers counted (``_torch_lm_dist.GatherProbe``).

The raw ``torch.stack`` sites the LM path keeps (its R001 pragmas): every
stack of DTensors the ranks run meets operands of one placement and runs no
collective.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import _torch_lm_dist as W
from _torch_lm import batches, port_grads, ref_params

from repro.configs import reduced_config as j_reduced_config
from repro_torch.configs import ARCH_NAMES
from repro_torch.launch.steps import make_lm_train_step
from repro_torch.models.lm import LM
from repro_torch.models.spec import tree_leaves
from repro_torch.models.spec import tree_map as spec_map
from repro_torch.optim import make_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x1": ((2, 2, 1), ("pod", "data", "model"))}
# archs whose first step on the 3-axis mesh costs DTensor's sharding
# propagation 17-31 s each on the CPU: they run on the (2, 2) mesh only
SLOW_3D = ("llama-3.2-vision-90b", "deepseek-v3-671b", "zamba2-1.2b",
           "rwkv6-7b")
B, S = 8, 16
SERVE = ("qwen2.5-32b", "llama3.2-1b")
SERVE_B, SERVE_S, MAX_SEQ = 4, 8, 16
MOE, MOE_B = "deepseek-v2-lite-16b", 2
LOSS_RTOL, LEAF_RTOL = 1e-4, 2e-4
# rwkv6 rounds its five time-mix streams to bf16 inside the f32 model
# (ssm._ddlerp, as the reference does): a reordered f32 sum before that cast
# flips an entry by one bf16 step (2^-8), which reaches its gradients
RWKV_RTOL = 1e-3
# ... and the mesh reorders such sums (its tensor-parallel contractions
# over ``model``): the reference's own SPMD gradient on a (2, 2) mesh
# differs from its plain one by 1.56e-3 in mu_x's (jax 0.9.0, CPU), as much
# as the port's. The rwkv6 bar is the larger of RWKV_RTOL and this factor
# times the reference's worst leaf difference, measured in REF_SPMD: the
# flips fall on other entries in the two packages
RWKV, RWKV_REF_FACTOR = "rwkv6-7b", 2.0
# caches are stored in bf16, and decode attention casts its probabilities
# to bf16 (the reference's roundings): a reordered f32 sum flips entries by
# one bf16 step (2^-8), in the caches and through them in decode's logits
BF16_RTOL = 1e-2
# Adafactor's streamed update on sharded leaves: llama3.2-1b's leaves over
# this many f32 bytes (its 3-D layer stacks per layer, embed in 64 chunks
# of rows; the norms' 2-D stacks stay whole)
STREAMED, STREAM_BYTES = "llama3.2-1b", 16384
# a guard against a hung reference subprocess only (it has no heartbeat):
# far above its time on a loaded machine, far below the suite's limit
REF_S = 900


def overrides(arch: str) -> dict:
    """The reduced config cut to two layers (one of each kind where the
    family has two) and at most 2 microbatches."""
    cfg = j_reduced_config(arch)
    over = {"microbatches": min(cfg.microbatches, 2), "n_layers": 2}
    if cfg.enc_layers:
        over.update(enc_layers=1, dec_layers=1)
    return over


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    return np.asarray(tree)


def _weights(arch: str):
    """(port config, the reference's f32 weights as numpy) of ``arch``."""
    over = overrides(arch)
    jcfg = dataclasses.replace(j_reduced_config(arch), **over)
    _, jp = ref_params(arch, "f32", cfg=jcfg)
    return W.cfg_of({"arch": arch, "cfg": over}), jax.tree.map(np.asarray, jp)


def _batch(cfg, b: int) -> dict:
    _, tb = batches(cfg, b, S, "f32")
    nb = {k: v.numpy() for k, v in tb.items()}
    nb["tokens"] = nb["tokens"].astype(np.int32)
    return nb


def moe_inputs():
    """The MoE case's weights and batch (also built, the same way, by the
    reference's subprocess)."""
    cfg, weights = _weights(MOE)
    return weights, _batch(cfg, MOE_B)


def rwkv_inputs():
    """The rwkv6 case's weights and batch, for the reference's
    subprocess."""
    cfg, weights = _weights(RWKV)
    return weights, _batch(cfg, B)


def _cases() -> list:
    """The workers' cases: every arch's weights and inputs as numpy; a
    serve case also carries the plain prefill's caches, from which both
    decode steps start."""
    cases = []
    for arch in ARCH_NAMES:
        cfg, weights = _weights(arch)
        over = overrides(arch)
        cases.append({"name": arch, "kind": "train", "arch": arch,
                      "cfg": over, "params": weights,
                      "batch": _batch(cfg, B)})
        if arch == STREAMED:
            cases.append(dict(cases[-1], name="adafactor_streamed",
                              stream_bytes=STREAM_BYTES))
        if arch == MOE:
            cases.append({"name": "moe_trap", "kind": "train", "arch": arch,
                          "cfg": over, "params": weights,
                          "batch": _batch(cfg, MOE_B)})
        if arch in SERVE:
            rng = np.random.default_rng(1)
            toks = rng.integers(0, cfg.vocab, (SERVE_B, SERVE_S))
            nxt = rng.integers(0, cfg.vocab, (SERVE_B, 1))
            lm = LM(cfg, device="cpu")
            logits, caches = lm.prefill(W.tensors(weights),
                                        torch.from_numpy(toks), MAX_SEQ)
            cases.append({"name": f"serve_{arch}", "kind": "serve",
                          "arch": arch, "cfg": over, "params": weights,
                          "tokens": toks.astype(np.int32),
                          "next": nxt.astype(np.int32), "max_seq": MAX_SEQ,
                          "caches": np_tree(caches),
                          "prefill": logits.numpy()})
    return cases


def _plain(case: dict) -> dict:
    """The port's plain step (one process, no mesh) on a case's inputs."""
    lm = LM(W.cfg_of(case), device="cpu")
    tp = W.tensors(case["params"])
    if case["kind"] == "serve":
        caches = spec_map(lambda a: torch.from_numpy(a).to(torch.bfloat16),
                          case["caches"])
        logits2, _ = lm.decode_step(tp, caches, torch.from_numpy(case["next"]),
                                    case["tokens"].shape[1])
        return {"prefill": case["prefill"], "caches": case["caches"],
                "decode": logits2.numpy()}
    tb = W.tensors(case["batch"])
    tb["tokens"] = tb["tokens"].long()
    opt = W.opt_of(case)
    newp, _, m = make_lm_train_step(lm, opt)(tp, opt.init(tp), tb)
    loss, grads = port_grads(lm, tp, tb)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grad_loss": float(loss),
            "grads": {"/".join(p): g.numpy() for p, g in tree_leaves(grads)},
            "params": np_tree(newp)}


REF_SPMD = """
    import json, sys
    sys.path.insert(0, sys.argv[1])
    import jax, jax.numpy as jnp
    from repro.configs import reduced_config
    from repro.configs.base import ShapeConfig
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import build_cell
    from repro.optim import make_optimizer
    from test_torch_lm_sharded import MOE, moe_inputs

    weights, batch = moe_inputs()
    cfg = reduced_config(MOE)
    mesh = make_mesh((2, 2), ("data", "model"))
    b, s = batch["tokens"].shape
    lm, step, _, shs = build_cell(cfg, ShapeConfig("moe", "train", s, b), mesh)
    params = jax.tree.map(jnp.asarray, weights)
    opt = make_optimizer(cfg.optimizer)
    state = opt.init(params, lm.params_spec())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with mesh:
        _, _, m = jax.jit(step, in_shardings=shs)(params, state, jb)

    # rwkv6: the reference's own SPMD gradient on the (2, 2) mesh against
    # its plain one, the worst leaf's relative difference in norm
    import dataclasses
    import numpy as np
    from repro.dist.sharding import activation_sharding
    from test_torch_lm_sharded import RWKV, overrides, rwkv_inputs
    weights, batch = rwkv_inputs()
    cfg = dataclasses.replace(reduced_config(RWKV), **overrides(RWKV))
    b, s = batch["tokens"].shape
    lm, _, _, shs = build_cell(cfg, ShapeConfig("rwkv", "train", s, b), mesh)
    params = jax.tree.map(jnp.asarray, weights)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grad = jax.value_and_grad(lm.train_loss)
    _, plain = jax.jit(grad)(params, jb)

    def spmd(p, bt):
        with activation_sharding(mesh):
            return grad(p, bt)
    with mesh:
        _, sharded = jax.jit(spmd, in_shardings=(shs[0], shs[2]))(params, jb)

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
    worst = max(jax.tree.leaves(jax.tree.map(rel, sharded, plain)))
    print(json.dumps({"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "rwkv_spmd_worst": worst}))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: rank 0's results}, the plain results, the reference's."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    # the reference's step builds its inputs while this process builds its
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REF_SPMD),
                            os.path.join(REPO, "tests")],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env)
    cases = _cases()
    stdout, stderr = ref.communicate(timeout=REF_S)
    assert ref.returncode == 0, stderr[-3000:]
    out = {mesh: {"stacks": {}} for mesh in MESHES}
    plain = None
    for mesh, part in _jobs(cases):
        join = W.start_ranks({"mesh": MESHES[mesh], "cases": part},
                             tmp_path_factory.mktemp(mesh))
        if plain is None:
            # the plain steps run here while the first ranks run
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                plain = {c["name"]: _plain(c) for c in cases}
            finally:
                torch.set_num_threads(threads)
        got = join()
        for where, seen in got.pop("stacks").items():
            out[mesh]["stacks"].setdefault(where, set()).update(seen)
        out[mesh].update(got)
    return out, plain, json.loads(stdout.strip().splitlines()[-1])


def _jobs(cases: list) -> list:
    """(mesh, cases) of each spawn, one after another: the (2, 2) mesh's
    cases in two halves, the 3-axis mesh's (all but ``SLOW_3D``, the MoE
    case and the streamed Adafactor) in one."""
    heavy = SLOW_3D + ("qwen2.5-32b", "deepseek-coder-33b")
    return [("2x2", [c for c in cases if c["arch"] not in heavy]),
            ("2x2", [c for c in cases if c["arch"] in heavy]),
            ("2x2x1", [c for c in cases
                       if c["name"] not in ("moe_trap", "adafactor_streamed")
                       and c["arch"] not in SLOW_3D])]


def norm_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], path + (k,))]
    return [("/".join(path), tree)]


@pytest.mark.parametrize("mesh,arch", [
    (mesh, arch) for mesh in sorted(MESHES) for arch in ARCH_NAMES
    if mesh == "2x2" or arch not in SLOW_3D])
def test_sharded_train_step_matches_plain_step(runs, mesh, arch):
    out, plain, ref = runs
    assert_train_close(out[mesh][arch], plain[arch],
                       rwkv_bar(ref) if arch == RWKV else LEAF_RTOL)


def rwkv_bar(ref: dict) -> float:
    """rwkv6's bar: RWKV_RTOL, or RWKV_REF_FACTOR times the reference's own
    (2, 2) SPMD gradient's worst leaf difference from its plain one."""
    return max(RWKV_RTOL, RWKV_REF_FACTOR * ref["rwkv_spmd_worst"])


def assert_train_close(got, want, bar):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_loss"], want["grad_loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=LEAF_RTOL)
    errs = {p: norm_rel(got["grads"][p], g) for p, g in want["grads"].items()}
    errs.update({f"new/{p}": norm_rel(a, b) for (p, a), (_, b) in
                 zip(leaves(got["params"]), leaves(want["params"]))})
    bad = {p: e for p, e in errs.items() if e > bar}
    assert not bad, bad


def test_sharded_streamed_adafactor_matches_plain_and_gathers_no_leaf(runs):
    """Adafactor's streamed update (leaves over ``STREAM_BYTES``: the
    pieces are the leading axis of a view) on sharded leaves: the step
    matches the plain step with the same bars, and the update alone
    all-gathers fewer elements than its factored statistics hold, so no
    leaf or piece of one (slicing embed's 64 pieces out of its row-sharded
    leaf gathered 8.45M elements per rank). On the (2, 2) mesh only."""
    out, plain, _ = runs
    got, want = out["2x2"]["adafactor_streamed"], plain["adafactor_streamed"]
    big = {p: a.ndim for p, a in leaves(want["params"])
           if a.size * 4 > STREAM_BYTES}
    assert {2, 3} <= set(big.values()), big
    assert_train_close(got, want, LEAF_RTOL)
    assert got["update_gathered"] <= got["stats_numel"], got


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", SERVE)
def test_sharded_prefill_and_decode_match_plain(runs, mesh, arch):
    out, plain, _ = runs
    got, want = out[mesh][f"serve_{arch}"], plain[f"serve_{arch}"]
    assert norm_rel(got["prefill"], want["prefill"]) <= LEAF_RTOL
    errs = {p: norm_rel(a, b) for (p, a), (_, b) in
            zip(leaves(got["caches"]), leaves(want["caches"]))}
    assert max(errs.values()) <= BF16_RTOL, errs
    # the decode step of both from the plain prefill's caches
    assert norm_rel(got["decode"], want["decode"]) <= BF16_RTOL


def test_moe_chunks_follow_the_reference_rule(runs):
    """2 rows: 2 dispatch chunks on one process, 1 on the (2, 2) mesh. The
    sharded step matches the reference's SPMD step on the same mesh shape
    and the port's plain step."""
    out, plain, ref = runs
    got = out["2x2"]["moe_trap"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                               rtol=LEAF_RTOL)
    np.testing.assert_allclose(got["loss"], plain["moe_trap"]["loss"],
                               rtol=LOSS_RTOL)


# the modules of the raw torch.stack sites the LM path keeps (R001
# pragmas) that each mesh's cases reach (the (2, 2, 1) mesh runs no SSM arch)
STACK_FILES = {"2x2": {"lm.py", "ssm.py"}, "2x2x1": {"lm.py"}}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_kept_stacks_meet_one_placement_and_run_no_collective(runs, mesh):
    """Every ``torch.stack`` of DTensors the cases run (``_stack_trees``'
    per-layer caches, mamba2's chunk states, rwkv6's step outputs) stacks
    operands of one placement on a new axis, and DTensor runs no collective
    for it: the premise of those sites' R001 pragmas."""
    out, _, _ = runs
    seen = out[mesh]["stacks"]
    assert all(v == {(1, 0)} for v in seen.values()), seen
    assert {w.split(":")[0] for w in seen} == STACK_FILES[mesh], seen
