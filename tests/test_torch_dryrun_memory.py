"""What one device holds in the sharded LM train step, on the dry run's
meta tensors (``launch.dryrun.Tally``), against the reference's plan.

Each arch's ``train_4k`` cell on a fake 16×16 world is traced cut to 2 and
4 layers at published widths (``dataclasses.replace(cfg, n_layers=k)``).
The peak is linear in the layers, ``peak = intercept + k · term``, so two
cut traces give the per-layer term, the intercept and the full-width peak
``intercept + L · term`` exactly. The term is what a layer leaves alive
until the backward: under remat "full" its sequence-sharded input and its
share of the arguments, gradients and outputs. Nothing replicated over
``model`` may outlive its layer.

The reference's figures are its ``repro.launch.dryrun.run_cell`` on the
same cuts (jax 0.9.0, 512 XLA host devices): argument + output + temp −
alias bytes of ``memory_analysis()``, the sum its ``peak_per_device_gb``
uses. Its per-layer term and intercept are constants here.

The MLP keeps tensor parallelism on ``model`` as the reference's plan does:
traced on a fake (2, 2) mesh, ``swiglu`` never redistributes ``w_gate``,
``w_up`` or ``w_down`` to ``Replicate`` on the model axis; the
activation's sequence shard is what is gathered.

All traces run in one subprocess (a fake process group per trace).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = {"qwen2.5-32b": 64, "llama3.2-1b": 16}
CUTS = (2, 4)
# the reference's (per-layer term, intercept) bytes a device, train_4k on
# 16×16: run_cell with n_layers cut (jax 0.9.0, 512 XLA host devices)
REFERENCE = {"qwen2.5-32b": (176_315_392, 7_851_833_404),
             "llama3.2-1b": (40_768_512, 7_110_472_340)}
# bars a device. qwen2.5-32b: a term of at most 400 MB (it was
# 1,139,614,208 B while the attention chunks' closures kept every layer's
# query, replicated over ``model``, alive) and a full-width peak within 60%
# of an 80 GB card. llama3.2-1b: no worse than the reference's term, and no
# higher than the port's full-width peak before (9,484,912,772 B)
TERM_BAR = {"qwen2.5-32b": 400_000_000, "llama3.2-1b": 40_768_512}
PEAK_BAR = {"qwen2.5-32b": 48_000_000_000, "llama3.2-1b": 9_484_912_772}
# the intercept (the embedding, logits and loss, and one layer's backward):
# measured 5,382,442,892 (qwen2.5) and 8,329,848,964 (llama3.2) on torch
# 2.13 (CPU), held within 10%
INTERCEPT_BAR = {"qwen2.5-32b": 5_900_000_000, "llama3.2-1b": 9_200_000_000}

TRACE = """
    import dataclasses, json, logging
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.dist.mesh import fake_world, make_mesh
    from repro_torch.dist.sharding import activation_sharding
    from repro_torch.launch.dryrun import Tally
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.layers import swiglu
    layers, cuts = json.loads(%r)
    out = {}
    for arch in layers:
        for k in cuts:
            cfg = dataclasses.replace(get_config(arch), n_layers=k)
            with fake_world(256):
                mesh = make_mesh((16, 16), ("data", "model"),
                                 device_type="cpu")
                _, step, args, _ = build_cell(cfg, SHAPES["train_4k"], mesh,
                                              device="meta")
                tally = Tally()
                tally.hold(args)
                with tally:
                    res = step(*args)
                del res
            out[f"{arch}/{k}"] = tally.peak

    # swiglu on a fake (2, 2) mesh, each leaf placed by the parameter rules:
    # every redistribute of a weight, by target placements
    def meta(shape, plc):
        local = [s // (2 if any(isinstance(p, Shard) and p.dim == d
                                for p in plc) else 1)
                 for d, s in enumerate(shape)]
        return DTensor.from_local(torch.empty(local, device="meta"), mesh,
                                  plc, run_check=False)
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        x = meta((4, 32, 16), [Shard(0), Shard(1)])
        w = {"w_gate": meta((16, 64), [Shard(0), Shard(1)]),
             "w_up": meta((16, 64), [Shard(0), Shard(1)]),
             "w_down": meta((64, 16), [Shard(1), Shard(0)])}
        names = {id(t): n for n, t in w.items()}
        seen = []
        orig = DTensor.redistribute

        def spy(self, *a, **kw):
            if id(self) in names:
                plc = kw.get("placements", a[1] if len(a) > 1 else None)
                seen.append([names[id(self)], [repr(p) for p in plc]])
            return orig(self, *a, **kw)
        DTensor.redistribute = spy
        try:
            tally = Tally()
            with activation_sharding(mesh), tally:
                y = swiglu(x, w["w_gate"], w["w_up"], w["w_down"])
        finally:
            DTensor.redistribute = orig
        out["swiglu"] = {"redistributed": seen, "shape": list(y.shape),
                         "collectives": tally.collectives}
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def traced():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(TRACE) % json.dumps(
            [list(LAYERS), CUTS])],
        capture_output=True, text=True, env=env, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def fit(traced: dict, arch: str) -> tuple:
    """(per-layer term, intercept, full-width peak) from the two cuts."""
    (k1, k2) = CUTS
    p1, p2 = traced[f"{arch}/{k1}"], traced[f"{arch}/{k2}"]
    term = (p2 - p1) // (k2 - k1)
    assert term * (k2 - k1) == p2 - p1, (p1, p2)
    intercept = p1 - k1 * term
    return term, intercept, intercept + LAYERS[arch] * term


@pytest.mark.parametrize("arch", sorted(LAYERS))
def test_per_layer_term_holds_its_bar(traced, arch):
    term, _, _ = fit(traced, arch)
    assert 0 < term <= TERM_BAR[arch], term


@pytest.mark.parametrize("arch", sorted(LAYERS))
def test_intercept_holds_its_bar(traced, arch):
    _, intercept, _ = fit(traced, arch)
    assert 0 < intercept <= INTERCEPT_BAR[arch], intercept


@pytest.mark.parametrize("arch", sorted(LAYERS))
def test_full_width_peak_holds_its_bar(traced, arch):
    """``intercept + L · term``, exact for a peak linear in the layers;
    beside the reference's ``intercept + L · term`` for the record."""
    _, _, peak = fit(traced, arch)
    ref_term, ref_intercept = REFERENCE[arch]
    ref_peak = ref_intercept + LAYERS[arch] * ref_term
    assert ref_peak == {"qwen2.5-32b": 19_136_018_492,
                        "llama3.2-1b": 7_762_768_532}[arch]
    assert peak <= PEAK_BAR[arch], (peak, ref_peak)


def test_swiglu_keeps_the_weights_sharded_over_model(traced):
    """The weights' redistributions (FSDP gathers over ``data``) all keep
    the model axis sharded, as the weights are; the sequence shard of the
    (4, 32, 16) input is the one all-gathered over ``model`` (before, the
    weights were gathered whole over ``model`` too: 30,720 bytes
    all-gathered, not 10,240)."""
    sw = traced["swiglu"]
    assert sw["shape"] == [4, 32, 16]
    moved = sw["redistributed"]
    assert {name for name, _ in moved} <= {"w_gate", "w_up", "w_down"}
    for name, plc in moved:
        assert plc[1].startswith("Shard"), (name, plc)
    # f32: this rank's 2 rows of the input with the whole sequence, and each
    # weight's model shard whole over data (the FSDP gather)
    assert sw["collectives"]["all-gather"] == (2 * 32 * 16 + 3 * 16 * 32) * 4
