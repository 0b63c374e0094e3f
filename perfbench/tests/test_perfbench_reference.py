"""The plain reference agrees with ``repro_torch`` on the CPU at arxiv-cpu:
the LMC step (three steps of ``GNNTrainer`` on the pipeline path, the ELL
backend's plain twins) and exact serving, each through its driver's whole
run; and the reference's derivations equal the program's."""
import numpy as np
import pytest

from perfbench import harness
from perfbench.drivers import serve, train
from perfbench.reference import graph as rgraph
from perfbench.tests._small import small_ctx

# sound CPU runs read 0 to ~3e-8 (f32 sums in another order)
AGREE = 1e-5


@pytest.mark.parametrize("workload", ["gcn-arxiv.train", "gcnii-ppi.train"])
def test_reference_agrees_with_the_lmc_step(workload, cache):
    ctx = small_ctx(workload)
    ctx.config["limits"] = dict.fromkeys(ctx.config["limits"], AGREE)
    res = train.run(ctx)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["e2e"]["train_nodes_per_s"] > 0
    assert res["e2e"]["train_peak_mem_gib"] == 0   # no card, no peak


def test_reference_agrees_with_exact_serving(cache):
    ctx = small_ctx("gcn-arxiv.serve")
    ctx.config["limits"] = {"logits": AGREE}
    res = serve.run(ctx)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] == 20
    assert 0 < res["e2e"]["serve_p50_ms"] <= res["e2e"]["serve_p95_ms"]


def test_reference_derivations_equal_the_programs(cache):
    from repro_torch.graph.partition import partition_graph
    from repro_torch.graph.sampler import ClusterSampler
    from repro_torch.graph.structure import Graph
    arrays = harness.dataset("arxiv-cpu")
    graph = Graph(**arrays)
    parts = rgraph.partition(arrays["indptr"], arrays["indices"], 8)
    assert np.array_equal(parts, partition_graph(graph, 8, seed=0))
    seed = 2**33 + 1
    sampler = ClusterSampler(graph, 8, 2, parts=parts, seed=seed)
    for i in range(6):
        cids = rgraph.epoch_clusters(seed, i, 8, 2)
        assert np.array_equal(cids, sampler.clusters_at(i, mode="epoch"))
        nodes = np.concatenate([np.flatnonzero(parts == c) for c in cids])
        sub = rgraph.extended(arrays["indptr"], arrays["indices"], nodes)
        sg = sampler.build_batch(cids)
        assert sub["nb"] == sg.n_batch_real
        assert sub["ext"].shape[0] - sub["nb"] == sg.n_halo_real
        assert sub["w"].shape[0] == sg.n_edges_real
        halo = sg.halo_gids[:sg.n_halo_real]
        assert np.array_equal(np.sort(halo), sub["ext"][sub["nb"]:])
        beta = dict(zip(halo.tolist(), sg.beta[:sg.n_halo_real].tolist()))
        assert beta == dict(zip(sub["ext"][sub["nb"]:].tolist(),
                                sub["beta"].tolist()))
