"""repro_torch.dist.sharding and models.spec's placements against the
reference's (tests/test_dist_sharding.py's counterpart).

The resolution functions of both packages read only a mesh's axis names
and sizes, so a duck-typed mesh serves both with no devices: every leaf of
every arch's full parameter, cache and optimizer-state tree is resolved on
both production meshes by each package and the mesh axes compared dim by
dim. The no-ops run off-mesh and on a one-rank gloo mesh; which rows each
rank of a fake 8-rank mesh holds is compared with the reference's
``devices_indices_map`` in one subprocess with 8 XLA host devices.
"""
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.dist import sharding as JS
from repro.launch.steps import fsdp_axes_for as j_fsdp_axes_for
from repro.models import spec as JSP
from repro.models.lm import LM as JLM
from repro.optim import make_optimizer as j_make_optimizer

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.dist import sharding as TS
from repro_torch.launch.steps import fsdp_axes_for
from repro_torch.models import spec as TSP
from repro_torch.models.lm import LM
from repro_torch.optim import make_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def duck(shape, axes):
    return SimpleNamespace(axis_names=tuple(axes), devices=np.empty(shape))


def entry_axes(entry) -> tuple:
    """A PartitionSpec entry as a tuple of mesh axes."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def j_leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in j_leaves(tree[k], path + (k,))]
    return [(path, tree)]


@pytest.mark.parametrize("shape,axes,dims,labels", [
    ((16, 16), ("data", "model"), (256, 4096, 2048), ("dp", "model", None)),
    ((2, 16, 16), ("pod", "data", "model"), (256, 4096, 2048),
     ("dp", "model", None)),
    ((2, 16, 16), ("pod", "data", "model"), (2, 4096, 2048),
     ("dp", "model", None)),
    ((2, 16, 16), ("pod", "data", "model"), (32, 40, 4096, 128),
     ("dp", "model", None, None)),
    ((4, 2), ("data", "model"), (8, 3, 6), ("dp", "dp", "model")),
    ((1, 4), ("data", "model"), (8, 8), ("dp", "model")),
    ((2, 2, 2), ("pod", "data", "model"), (6, 8, 4), ("model", "dp", "dp")),
])
def test_resolve_spec_matches_reference(shape, axes, dims, labels):
    """Dropped labels (absent, reused, trivial, not dividing) and the fused
    (pod, data) row axis resolve as the reference resolves them."""
    want = JS.resolve_spec(duck(shape, axes), dims, labels)
    got = TS.resolve_spec(axes, shape, dims, labels)
    assert got == tuple(entry_axes(e) for e in want)


def _trees(arch: str, axes):
    """{tree name: (reference PSpec tree, port PSpec tree)} of ``arch``'s
    full config: parameters, caches of (128, 32768), optimizer state."""
    jlm, tlm = JLM(j_get_config(arch)), LM(get_config(arch), device="cpu")
    jp, tp = jlm.params_spec(), tlm.params_spec()
    j_opt = j_make_optimizer(j_get_config(arch).optimizer)
    t_opt = make_optimizer(get_config(arch).optimizer)
    trees = {"params": (jp, tp),
             "opt_state": (j_opt.state_spec(jp), t_opt.state_spec(tp))}
    if get_config(arch).has_decoder:
        trees["caches"] = (jlm.cache_spec(128, 32768),
                           tlm.cache_spec(128, 32768))
    return trees


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_leaf_shards_as_the_reference(arch, mesh):
    """The port's placements name the reference's mesh axes on every dim
    of every leaf, so every local shard has the reference's shape."""
    shape, axes = MESHES[mesh]
    m = duck(shape, axes)
    j_rules = JSP.default_rules(j_fsdp_axes_for(j_get_config(arch), m))
    t_rules = TSP.default_rules(fsdp_axes_for(get_config(arch), m))
    assert j_rules == t_rules
    size = dict(zip(axes, shape))
    for name, (jt, tt) in _trees(arch, axes).items():
        jl, tl = j_leaves(jt), TSP.tree_leaves(tt)
        assert [p for p, _ in jl] == [p for p, _ in tl], name
        for (path, js), (_, ts) in zip(jl, tl):
            assert js.shape == ts.shape and js.logical == ts.logical, path
            want = tuple(entry_axes(e) for e in
                         JSP.partition_spec(js, j_rules, m))
            want += ((),) * (len(js.shape) - len(want))
            assert TSP.spec_axes(ts, t_rules, m) == want, (name, path)
            local = TS.local_shape(m, ts.shape,
                                   TSP.partition_spec(ts, t_rules, m))
            ref_local = tuple(n // int(np.prod([size[a] for a in ax]))
                              for n, ax in zip(js.shape, want))
            assert local == ref_local, (name, path)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_placement_factories_match_the_reference(mesh):
    """named / replicated / row_sharding / store_sharding: the reference's
    PartitionSpecs as one placement per mesh axis."""
    from jax.sharding import PartitionSpec as P
    shape, axes = MESHES[mesh]
    m = duck(shape, axes)

    def want(spec):
        return TS.axes_to_placements(m, [entry_axes(e) for e in spec])
    dp = JS.dp_entry(m)
    assert TS.dp_entry(m) == dp
    assert TS.replicated(m) == want(P())
    assert TS.row_sharding(m) == want(P(dp))
    assert TS.store_sharding(m) == want(P(None, dp, "model"))
    assert TS.store_sharding(m, model_axis=None, leading_dims=2) == want(
        P(None, None, dp, None))
    assert TS.named(m, dp, "model") == want(P(dp, "model"))


def test_noops_off_mesh():
    """Off-mesh every helper is the identity or the trivial answer."""
    assert TS.current_mesh() is None
    assert TS.model_axis_size() == 1
    x = torch.ones(2, 4, 8)
    assert TS.shard_act(x, "dp", None, "model") is x
    assert TS.shard_res(x) is x
    a, b = torch.arange(3), torch.arange(3, 8)
    np.testing.assert_array_equal(TS.concat_rows([a, b]).numpy(),
                                  np.arange(8))
    made = TS.mesh_tensor(x, lambda s: torch.zeros(s), (3, 5), ("dp", None))
    assert type(made) is torch.Tensor and made.shape == (3, 5)
    with TS.activation_sharding(None):
        assert TS.current_mesh() is None and TS.shard_act(x, "dp", None,
                                                          None) is x


def test_one_rank_mesh_is_a_noop(tmp_path):
    """On a registered mesh of one rank the constraints change nothing,
    while parameters are still DTensors with the spec's placements."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.dist.mesh import make_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'i'}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        x = TS.distribute({"x": torch.randn(4, 6, 8)},
                          {"x": TS.named(mesh, "data", "model", None)},
                          mesh)["x"]
        # an axis of one rank shards nothing: Replicate, the same layout
        assert isinstance(x, DTensor) and x.placements == (Replicate(),) * 2
        with TS.activation_sharding(mesh):
            assert TS.current_mesh() is mesh
            assert TS.shard_act(x, None, "dp", "model") is x
            assert TS.shard_res(x) is x
            cat = TS.concat_rows([x, x], axis=2)
            np.testing.assert_array_equal(
                cat.full_tensor().numpy(),
                torch.cat([x.full_tensor()] * 2, 2).numpy())
            assert TS.dp_axis_size() == 1 and TS.model_axis_size() == 1
        s = TSP.PSpec((64, 32), ("vocab", "embed"))
        rules = TSP.default_rules(("data",))
        assert TSP.spec_axes(s, rules, mesh) == (("model",), ("data",))
        assert TSP.partition_spec(s, rules, mesh) == [Replicate()] * 2
    finally:
        dist.destroy_process_group()


def test_dp_axis_size_of_group_mesh_and_registry():
    """A process group's world size (the GNN callers), a mesh's pod×data
    product, and the registered mesh's when given neither."""
    assert TS.dp_axis_size() == 1
    m = duck((2, 4, 8), ("pod", "data", "model"))
    assert TS.dp_axis_size(m) == 8 and TS.model_axis_size(m) == 8
    assert TS.data_axes(m) == ("pod", "data") and TS.dp_entry(m) == (
        "pod", "data")
    with TS.activation_sharding(m):
        assert TS.dp_axis_size() == 8


def test_rows_per_rank_follow_the_reference_pod_major():
    """Rows of a (16,)-vector placed over ("pod", "data") on a 2x2x2 mesh:
    rank r of a fake 8-rank group holds the block the reference's
    NamedSharding gives the device at flat mesh position r."""
    code = textwrap.dedent("""
        import json
        import numpy as np
        import torch
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.dist.mesh import make_mesh as j_make_mesh
        from repro_torch.dist import sharding as TS
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import distribute_tensor

        axes = ("pod", "data", "model")
        jm = j_make_mesh((2, 2, 2), axes)
        idx = NamedSharding(jm, P(("pod", "data"))).devices_indices_map((16,))
        want = [list(range(16))[idx[d][0]] for d in jm.devices.flat]
        got = []
        for r in range(8):
            dist.init_process_group("fake", store=FakeStore(), rank=r,
                                    world_size=8)
            mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=axes)
            plc = TS.placements(mesh, (16,), ("dp",))
            got.append(distribute_tensor(torch.arange(16), mesh, plc,
                                         src_data_rank=None)
                       .to_local().tolist())
            dist.destroy_process_group()
        print(json.dumps({"want": want, "got": got}))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    import json
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["got"] == out["want"]
    assert out["got"][0] == [0, 1, 2, 3] and out["got"][2] == [4, 5, 6, 7]
