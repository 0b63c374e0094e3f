"""Port parity, sampling: the partitioner, the pad sizes and the cluster
sampler are numpy copies of the reference's and must give *equal* arrays (no
tolerance) for the same graph and seed."""
import dataclasses

import numpy as np
import pytest

from repro import graph as jgraph
from repro.graph.partition import partition_balance as j_partition_balance
from repro.graph.structure import padded_sizes_for as j_padded_sizes_for

from repro_torch import graph as tgraph


@pytest.fixture(scope="module")
def port_graph():
    return tgraph.make_sbm_dataset("ppi-cpu", seed=3)


def _assert_subgraphs_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name))
        assert x.dtype == y.dtype, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


def test_partition_matches_reference(small_graph, small_parts, port_graph):
    parts = tgraph.partition_graph(port_graph, 16, seed=0)
    assert parts.dtype == small_parts.dtype
    np.testing.assert_array_equal(parts, small_parts)
    assert tgraph.edge_cut_fraction(port_graph, parts) == \
        jgraph.edge_cut_fraction(small_graph, small_parts)
    assert tgraph.partition_balance(parts, 16) == \
        j_partition_balance(small_parts, 16)
    np.testing.assert_array_equal(tgraph.partition_graph(port_graph, 1),
                                  jgraph.partition_graph(small_graph, 1))


@pytest.mark.parametrize("c,include_halo", [(1, True), (2, True),
                                            (4, False)])
def test_padded_sizes_match_reference(small_graph, small_parts, port_graph,
                                      c, include_halo):
    assert tgraph.padded_sizes_for(port_graph, small_parts, 16, c,
                                   include_halo) == \
        j_padded_sizes_for(small_graph, small_parts, 16, c, include_halo)


@pytest.mark.parametrize("kw", [
    {},
    {"include_halo": False, "edge_weight_mode": "local"},
    {"beta_spec": ("x2", 0.5), "stochastic": False},
])
def test_cluster_sampler_matches_reference(small_graph, small_parts,
                                           port_graph, kw):
    """The stateful stream (sample, epoch), the pure schedule API and the
    RNG state give identical subgraphs in both packages."""
    js = jgraph.ClusterSampler(small_graph, 16, 2, parts=small_parts, seed=5,
                               **kw)
    ts = tgraph.ClusterSampler(port_graph, 16, 2, parts=small_parts, seed=5,
                               **kw)
    assert (ts.pad_batch, ts.pad_halo, ts.pad_edges) == \
        (js.pad_batch, js.pad_halo, js.pad_edges)
    assert ts.batches_per_epoch == js.batches_per_epoch
    for _ in range(2):
        _assert_subgraphs_equal(ts.sample(), js.sample())
    for a, b in zip(ts.epoch(), js.epoch(), strict=True):
        _assert_subgraphs_equal(a, b)
    for i in (0, 3, 17):
        for mode in ("uniform", "epoch"):
            np.testing.assert_array_equal(ts.clusters_at(i, mode=mode),
                                          js.clusters_at(i, mode=mode))
    state = ts.state_dict()
    assert state == js.state_dict()
    first = ts.sample()
    ts.load_state_dict(state)
    _assert_subgraphs_equal(ts.sample(), first)
    with pytest.raises(ValueError, match="schedule mode"):
        ts.clusters_at(0, mode="bogus")


def test_cluster_sampler_partitions_itself_like_reference(small_graph,
                                                          port_graph):
    """Without ``parts`` both samplers partition the graph with their seed."""
    js = jgraph.ClusterSampler(small_graph, 8, 2, seed=1)
    ts = tgraph.ClusterSampler(port_graph, 8, 2, seed=1)
    np.testing.assert_array_equal(ts.parts, js.parts)
    _assert_subgraphs_equal(ts.build_batch(np.array([3, 5])),
                            js.build_batch(np.array([3, 5])))
