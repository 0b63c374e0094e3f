"""Store gateway: pad arbitrary target-node requests into bucket batches.

Serving requests name arbitrary target sets, unlike training batches which
come from the cluster sampler's partition. The gateway reuses the exact
training-batch machinery — ``build_subgraph`` (graph/structure.py) with
``num_parts=1, clusters_in_batch=1`` builds the 1-hop padded extension, and
``host_batch`` (core/lmc.py) re-buckets it into the ELL layout of the CUDA
SpMM — but with *request-bucket* pad shapes instead of sampler-epoch maxima:
target counts are rounded up to one of a few capacities so every batch has
one of ``len(buckets)`` shapes.

Pad sizes per bucket are worst-case by degree order: any ``b`` targets pull
at most ``sum(top-b degrees)`` halo nodes, and the subgraph's edges (into
batch rows + into halo rows from the extended set) are a subset of the
directed edge set, so the bounds below make ``build_subgraph`` overflow
impossible for in-range requests; the server still turns a (would-be-bug)
overflow into a typed response rather than a crash.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.lmc import Batch, host_batch
from repro_torch.graph.structure import Graph, PaddedSubgraph, build_subgraph
from repro_torch.serve.types import RequestTooLarge


def _round_up(x: int, mult: int) -> int:
    return max(mult, ((int(x) + mult - 1) // mult) * mult)


def request_pads(graph: Graph, bucket: int, *,
                 degrees: Optional[np.ndarray] = None,
                 halo_round: int = 64,
                 edge_round: int = 256) -> tuple[int, int]:
    """Worst-case ``(pad_halo, pad_edges)`` for any ``bucket`` target nodes."""
    if degrees is None:
        degrees = graph.degrees()
    deg_desc = np.sort(degrees)[::-1]
    n, ne = graph.num_nodes, graph.num_edges
    # any b targets have <= sum(top-b degrees) distinct neighbors
    halo_max = int(min(n, deg_desc[:bucket].sum()))
    pad_halo = min(_round_up(halo_max, halo_round), _round_up(n, halo_round))
    # e1 (into batch rows) <= sum(top-b degrees); e2 (into halo rows) <= sum
    # of the halo nodes' degrees; both are disjoint subsets of the directed
    # edge set, so the total never exceeds num_edges
    edge_max = int(min(ne, deg_desc[:bucket].sum()
                       + deg_desc[:pad_halo].sum()))
    pad_edges = min(_round_up(edge_max, edge_round), _round_up(ne, edge_round))
    return pad_halo, pad_edges


class StoreGateway:
    """Builds fixed-shape host batches for arbitrary target-node sets.

    ``agg_backend`` selects the aggregation path the batches are built for
    ("segment" | "ell"); every batch additionally carries ``ti_scale`` so the
    server can swap compensation to the store-free ti path without changing
    the batch (or its shape).
    """

    def __init__(self, graph: Graph, *, buckets=(8, 32, 128),
                 agg_backend: str = "segment", ell_buckets=(8, 32, 128)):
        assert agg_backend in ("segment", "ell"), agg_backend
        self.graph = graph
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.agg_backend = agg_backend
        self.ell_buckets = tuple(ell_buckets)
        self.degrees = graph.degrees()
        self.pads = {b: request_pads(graph, b, degrees=self.degrees)
                     for b in self.buckets}

    @property
    def max_targets(self) -> int:
        """Largest admissible target count (the top bucket's capacity)."""
        return self.buckets[-1]

    def bucket_for(self, n_targets: int) -> int:
        """Smallest bucket holding ``n_targets`` targets."""
        for b in self.buckets:
            if n_targets <= b:
                return b
        raise RequestTooLarge(
            f"{n_targets} target nodes exceed the largest pad bucket "
            f"({self.buckets[-1]})")

    def build(self, targets: np.ndarray) -> tuple[PaddedSubgraph, Batch]:
        """Padded subgraph + host Batch (CPU tensors) for unique target ids."""
        targets = np.asarray(targets, dtype=np.int64)
        bucket = self.bucket_for(targets.shape[0])
        pad_halo, pad_edges = self.pads[bucket]
        sg = build_subgraph(
            self.graph, targets, pad_batch=bucket, pad_halo=pad_halo,
            pad_edges=pad_edges, num_parts=1, clusters_in_batch=1,
            degrees=self.degrees)
        # "ti" host batches are "ell" batches + the α scales; "segment"
        # batches get the scales attached directly — either way the ti
        # compensation path needs no rebuild
        kind = "ti" if self.agg_backend == "ell" else "segment"
        hb = host_batch(sg, backend=kind, ell_buckets=self.ell_buckets,
                        with_transpose=False)
        if hb.ti_scale is None:
            hb = hb._replace(ti_scale=torch.from_numpy(sg.ti_scale))
        return sg, hb
