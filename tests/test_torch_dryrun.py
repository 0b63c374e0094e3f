"""repro_torch.launch.dryrun on the CPU, each run in a subprocess.

* The reduced llama3.2, qwen2.5 and deepseek-v2-lite cells of all three
  shape kinds, on a fake (2, 2, 2) mesh over ("pod", "data", "model"),
  trace to ``status: ok``, with the reference's per-device argument bytes
  (``memory_analysis()`` of its compiled step on 8 XLA host devices) and a
  peak no smaller than the arguments.
* The seven full-width cells of the reference's table: the argument bytes
  of ``input_specs`` alone (nothing traced) equal the reference's.
* The collective counter reads the bytes of one hand-built redistribute.

The subprocesses run at once (the CLI one per arch, the reference, the
full-width specs), so the module takes about as long as its slowest.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("llama3.2-1b", "qwen2.5-32b", "deepseek-v2-lite-16b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
MESH, BATCH, SEQ = (2, 2, 2), 8, 64

# per-device argument bytes of the reference's run_cell (jax 0.9.0, 512 XLA
# host devices): the oracle of the full-width specs
REFERENCE_ARG_BYTES = {
    ("llama3.2-1b", "train_4k", False): 95_774_468,
    ("llama3.2-1b", "train_4k", True): 47_887_236,
    ("llama3.2-1b", "prefill_32k", False): 13_869_312,
    ("llama3.2-1b", "decode_32k", False): 550_478_116,
    ("qwen2.5-32b", "train_4k", False): 5_103_112_580,
    ("qwen2.5-32b", "decode_32k", False): 5_023_908_516,
    ("deepseek-v2-lite-16b", "train_4k", False): 909_427_972,
}

REFERENCE = """
    import json
    import jax
    from repro.configs import reduced_config
    from repro.configs.base import ShapeConfig
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import build_cell
    archs, shapes, mesh_shape, b, s = json.loads(%r)
    mesh = make_mesh(tuple(mesh_shape), ("pod", "data", "model"))
    out = {}
    for arch in archs:
        for name in shapes:
            kind = name.split("_")[0]
            cfg = reduced_config(arch)
            lm, step, args, shs = build_cell(
                cfg, ShapeConfig(name, kind, s, b), mesh)
            donate = {"train": (0, 1), "decode": (1,), "prefill": ()}[kind]
            with mesh:
                c = jax.jit(step, in_shardings=shs,
                            donate_argnums=donate).lower(*args).compile()
            out[arch + "/" + name] = c.memory_analysis().argument_size_in_bytes
    print(json.dumps(out))
"""

FULL_WIDTH = """
    import json, logging
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.dist.mesh import fake_world, make_production_mesh
    from repro_torch.launch.dryrun import Tally, tree_nbytes
    from repro_torch.launch.steps import input_specs
    from repro_torch.models.lm import LM
    from repro_torch.optim import make_optimizer
    cells = json.loads(%r)
    out = {}
    for multi_pod in (False, True):
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            for arch, shape, mp in cells:
                if mp != multi_pod:
                    continue
                cfg = get_config(arch)
                lm = LM(cfg, device="meta")
                opt = make_optimizer(cfg.optimizer)
                args, _ = input_specs(cfg, lm, SHAPES[shape], mesh, opt)
                out["/".join(map(str, (arch, shape, mp)))] = tree_nbytes(args)
    # one hand-built redistribute: a (64, 32) f32 tensor with its rows over
    # the model axis, gathered whole: one all-gather of the full tensor
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.dist.mesh import make_mesh
    with fake_world(8):
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"),
                         device_type="cpu")
        x = DTensor.from_local(torch.empty(32, 32, device="meta"), mesh,
                               [Replicate(), Replicate(), Shard(0)],
                               run_check=False)
        tally = Tally()
        with tally:
            x.redistribute(mesh, [Replicate()] * 3)
        out["collectives"] = tally.collectives
    print(json.dumps(out))
"""


def _env(**kw):
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                JAX_PLATFORMS="cpu", **kw)


def _popen(argv, **env):
    return subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=_env(**env), cwd=REPO)


def _last_json(proc, timeout=400):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("dryrun")
    mesh = "x".join(map(str, MESH))
    cli = {arch: _popen([sys.executable, "-m", "repro_torch.launch.dryrun",
                         "--device", "cpu", "--reduced", "--arch", arch,
                         "--mesh", mesh, "--batch", str(BATCH),
                         "--seq", str(SEQ), "--out", str(out_dir)])
           for arch in ARCHS}
    ref = _popen([sys.executable, "-c", textwrap.dedent(REFERENCE) % json.dumps(
        [ARCHS, SHAPES, MESH, BATCH, SEQ])],
        XLA_FLAGS="--xla_force_host_platform_device_count=8")
    full = _popen([sys.executable, "-c", textwrap.dedent(FULL_WIDTH) % json.dumps(
        [list(k) for k in REFERENCE_ARG_BYTES])])
    for arch, proc in cli.items():
        _, err = proc.communicate(timeout=400)
        assert proc.returncode == 0, err[-3000:]
    cells = {}
    for arch in ARCHS:
        for shape in SHAPES:
            path = out_dir / f"{arch}_{shape}_{mesh}.json"
            cells[(arch, shape)] = json.loads(path.read_text())
    return cells, _last_json(ref), _last_json(full)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_cell_traces_with_the_reference_argument_bytes(runs, arch,
                                                               shape):
    cells, ref, _ = runs
    res = cells[(arch, shape)]
    assert res["status"] == "ok", res
    mem = res["memory"]
    assert mem["argument_bytes"] == ref[f"{arch}/{shape}"]
    assert mem["peak_bytes"] >= mem["argument_bytes"]
    assert res["flops"] > 0 and res["collectives"]["num_ops"] > 0


@pytest.mark.parametrize("cell", sorted(REFERENCE_ARG_BYTES),
                         ids=lambda c: f"{c[0]}-{c[1]}-{'2x16x16' if c[2] else '16x16'}")
def test_full_width_argument_bytes_equal_the_reference(runs, cell):
    _, _, full = runs
    assert full["/".join(map(str, cell))] == REFERENCE_ARG_BYTES[cell]


def test_collective_counter_reads_a_hand_built_redistribute(runs):
    """(64, 32) f32 with its rows over the 2-way model axis, gathered
    whole: one all-gather whose output is the whole tensor, 8 KiB."""
    _, _, full = runs
    assert full["collectives"] == {"all-gather": 64 * 32 * 4, "num_ops": 1}
