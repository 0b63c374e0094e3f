"""The historical stores a layer each (``core/history.py``): one width
repeated keeps the stacked tensor, and a step and its commit give the same
bits on a store held as a tuple of layers; GAT's mixed widths are a tuple,
ride a checkpoint whole, and the paths that need one tensor (the row-sharded
step, elastic resharding, serving) refuse them with a ValueError."""
import numpy as np
import pytest
import torch

from repro_torch.core import LMC, HistoricalState, init_history
from repro_torch.core.history import stacked
from repro_torch.graph import ClusterSampler
from repro_torch.graph.synthetic import make_sbm_dataset
from repro_torch.models import make_gnn
from repro_torch.optim import sgd
from repro_torch.train import GNNTrainer


def _trainer(graph, arch, hidden, layers, **kw):
    gnn = make_gnn(arch, graph.feature_dim, hidden, graph.num_classes,
                   layers, generator=torch.Generator().manual_seed(0))
    return GNNTrainer(gnn, LMC, graph, ClusterSampler(graph, 8, 2, seed=3),
                      sgd(lr=0.2), device="cpu",
                      straggler_deadline=float("inf"), **kw)


def test_init_history_by_widths():
    one = init_history(3, 10, 4, device="cpu")
    assert isinstance(one.h, torch.Tensor) and one.h.shape == (3, 10, 4)
    assert one.v.shape == (2, 10, 4) and one.num_layers == 3
    assert init_history(3, 10, (4, 4, 4), device="cpu").h.shape == (3, 10, 4)
    mixed = init_history(3, 10, (8, 8, 5), device="cpu")
    assert [t.shape for t in mixed.h] == [(10, 8), (10, 8), (10, 5)]
    assert [t.shape for t in mixed.v] == [(10, 8), (10, 8)]
    assert mixed.num_layers == 3
    with pytest.raises(ValueError, match="widths for 3 layers"):
        init_history(3, 10, (8, 5), device="cpu")
    with pytest.raises(ValueError, match="one width"):
        stacked(mixed.h)
    assert stacked(one.h) is one.h


@pytest.mark.parametrize("arch", ["gcn", "gcnii"])
def test_a_store_of_layers_holds_the_stacked_stores_bits(arch):
    """Three steps at arxiv-cpu on the stacked store and on the same store
    held as a tuple of per-layer tensors: the same bits in every layer."""
    graph = make_sbm_dataset("arxiv-cpu", seed=0)
    a = _trainer(graph, arch, 32, 3)
    b = _trainer(graph, arch, 32, 3)
    assert isinstance(a.store.h, torch.Tensor)
    b.store = HistoricalState(tuple(t.clone() for t in a.store.h),
                              tuple(t.clone() for t in a.store.v))
    a.run(3)
    b.run(3)
    assert [r["loss"] for r in a.history] == [r["loss"] for r in b.history]
    assert torch.equal(a.store.h, stacked(b.store.h))
    assert torch.equal(a.store.v, stacked(b.store.v))
    assert a.store.h.abs().sum() > 0


def test_a_checkpoint_round_trips_gats_mixed_width_stores(tmp_path):
    graph = make_sbm_dataset("ppi-cpu", seed=0)
    tr = _trainer(graph, "gat", 32, 3, ckpt_dir=str(tmp_path), ckpt_every=2)
    tr.run(2)
    want = [t.clone() for t in (*tr.store.h, *tr.store.v)]
    assert isinstance(tr.store.h, tuple)
    assert [t.shape[1] for t in want] == [32, 32, graph.num_classes, 32, 32]
    assert any(t.abs().sum() > 0 for t in want)
    for t in (*tr.store.h, *tr.store.v):
        t.fill_(float("nan"))
    assert tr.restore() and tr.step_num == 2
    got = [*tr.store.h, *tr.store.v]
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
    tr.run(1)
    assert np.isfinite(tr.history[-1]["loss"])
    tr.close()


def test_one_tensor_paths_refuse_mixed_widths():
    from repro_torch.core.distributed import make_distributed_train_step
    from repro_torch.serve import GNNServer
    from repro_torch.train.elastic import rescale_lmc_state
    graph = make_sbm_dataset("ppi-cpu", seed=0)
    gnn = make_gnn("gat", graph.feature_dim, 32, graph.num_classes, 3)
    with pytest.raises(ValueError, match="one width"):
        make_distributed_train_step(gnn, LMC, graph.num_nodes)
    with pytest.raises(ValueError, match="one width"):
        GNNServer(gnn, graph, gnn.params(), device="cpu")
    store = init_history(3, graph.num_nodes, gnn.store_widths(),
                         device="cpu")
    with pytest.raises(ValueError, match="one width"):
        rescale_lmc_state(graph, store, old_num_parts=8, new_num_parts=4)
