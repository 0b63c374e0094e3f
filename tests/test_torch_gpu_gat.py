"""GAT's attention kernels (``csrc/gat_attention.cu``) on the card against
their plain twins, at GAT-PPI's two layer shapes (4 heads × 256
concatenated, 6 heads × 121 averaged) over the ppi-like cells' first batch
(its ELL built on the card, the padded COO's edges into row 0 included),
and on a small graph whose heavy rows split into pieces across buckets.
Every test needs an NVIDIA GPU and skips without one; no JAX:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_gat.py``.

Tolerance: the largest gap over the largest value of each output, 1e-5:
the same f32 sums in another order (the kernels sum a row's slots 32 at a
time with an online softmax, the twins edge by edge through
``index_add_``); ``dv`` and ``du`` are sums of terms of both signs whose
total is much smaller than the terms, so they are held to the same 1e-5 of
their terms' scale (``|go| · |z|``). Two runs of each kernel are bit-equal:
nothing is added with atomics.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core import host_batch
from repro_torch.kernels import attention_plan, ell_from_coo

GAT = importlib.import_module("repro_torch.kernels.gat_attention")
TOL = 1e-5

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _ppi_batch():
    """The first slot of the benchmark's epoch schedule on ppi-like
    (``perfbench/data/sbm.py`` at seed 0; 32 parts, 4 clusters a batch)."""
    from perfbench.data.sbm import make_sbm
    from repro_torch.graph import ClusterSampler, partition_graph
    from repro_torch.graph.structure import Graph
    graph = Graph(**make_sbm("ppi-like", seed=0), name="ppi-like")
    sampler = ClusterSampler(graph, 32, 4, seed=0,
                             parts=partition_graph(graph, 32, seed=0))
    return sampler.build_batch(sampler.clusters_at(0, mode="epoch"))


def _inputs(n, heads, width, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn((n, heads, width), generator=g, device=device)
    u, v = (torch.randn((n, heads), generator=g, device=device)
            for _ in range(2))
    return z, u, v, torch.randn((n, heads, width), generator=g,
                                device=device)


def _run(plan, z, u, v, go):
    o, lse = GAT.attention_forward(plan.fwd, z, u, v)
    dz, du, dv = GAT.attention_backward(plan, z, u, v, lse, go)
    torch.cuda.synchronize()
    return o, lse, dz, du, dv


def _check(plan, z, u, v, go) -> dict:
    """The kernels against the twins and against themselves; the gaps."""
    before = GAT.LAUNCHES
    got = _run(plan, z, u, v, go)
    assert GAT.LAUNCHES == before + GAT.LAUNCHES_FORWARD \
        + GAT.LAUNCHES_BACKWARD
    o, lse = GAT.attention_plain(plan.fwd, z, u, v)
    want = (o, lse, *GAT.attention_vjp_plain(plan, z, u, v, lse, go))
    scale = float(go.abs().max() * z.abs().max())
    gaps = {}
    for name, a, b in zip(("o", "lse", "dz", "du", "dv"), got, want):
        assert torch.isfinite(a).all(), name
        ref = scale if name in ("du", "dv") else float(b.abs().max())
        gaps[name] = float((a - b).abs().max()) / ref
        assert gaps[name] <= TOL, (name, gaps[name])
    again = _run(plan, z, u, v, go)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    return gaps


@pytest.mark.parametrize("heads,width", [(4, 256), (6, 121)],
                         ids=["concat-4x256", "average-6x121"])
def test_attention_kernels_match_plain_at_gat_ppi(cuda, heads, width):
    sg = _ppi_batch()
    batch = host_batch(sg, backend="ell").to(cuda)
    plan = attention_plan(batch.ell)
    print(heads, width, _check(plan, *_inputs(sg.n_ext, heads, width, cuda,
                                              heads)))


def test_attention_kernels_match_plain_on_split_rows(cuda):
    """A row of 300 edges (two full pieces and a remainder in another
    bucket), padding edges into row 0, rows with only their self loop, and
    widths of 1, 33 and 130 (one, two and five column groups a lane)."""
    r = np.random.default_rng(5)
    n = 400
    src = np.concatenate([r.integers(0, n, 1500), r.integers(0, n, 300),
                          r.integers(0, n, 700)])
    dst = np.concatenate([r.integers(1, 350, 1500), np.full(300, 7),
                          np.zeros(700, np.int64)])
    w = np.concatenate([r.random(1800) + 0.1, np.zeros(700)])
    ell = ell_from_coo(src, dst, w, n, with_transpose=True).to(cuda)
    plan = attention_plan(ell)
    for heads, width in ((2, 1), (3, 33), (1, 130)):
        _check(plan, *_inputs(n, heads, width, cuda, width))


def test_gat_layer_vjp_on_the_card_equals_the_plain_layer(cuda):
    """One GAT layer through ``torch.func.vjp``, as the LMC step takes it:
    the kernels over the ELL against ``gat_aggregate`` over the edge list,
    on the card, forward and every cotangent."""
    from repro_torch.models.gnn import EdgeList, LayerAux, make_gnn
    r = np.random.default_rng(11)
    n, e = 300, 2000
    src, dst = r.integers(0, n, e), r.integers(0, n, e)
    w = np.where(r.random(e) < 0.1, 0.0, r.random(e) + 0.1)
    gnn = make_gnn("gat", 16, 24, 7, 2, heads=3, out_heads=2,
                   generator=torch.Generator().manual_seed(0)).to(cuda)
    params = gnn.params()
    edges = EdgeList(*(torch.as_tensor(a, device=cuda) for a in (
        src.astype(np.int32), dst.astype(np.int32), w.astype(np.float32))))
    ell = ell_from_coo(src, dst, w, n, with_transpose=True).to(cuda)
    h = torch.randn((n, 16), device=cuda)
    for l, h_in in ((0, h), (1, torch.randn((n, 24), device=cuda))):
        lp = gnn.layer_params(params, l)
        ct = torch.randn((n, gnn.store_widths()[l]), device=cuda)
        outs = []
        for with_ell in (True, False):
            aux = gnn.prepare(LayerAux(edges=edges, x=h, h0=h, self_w=None,
                                       ell=ell if with_ell else None))
            out, vjp = torch.func.vjp(
                lambda p, x: gnn.layer_apply(p, l, x, aux), lp, h_in)
            outs.append((out, *vjp(ct)))
        (o1, g1, x1), (o2, g2, x2) = outs
        torch.testing.assert_close(o1, o2, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(x1, x2, rtol=1e-4, atol=1e-4)
        for k in g1:
            torch.testing.assert_close(g1[k], g2[k], rtol=1e-4, atol=1e-4)
