"""Cluster mini-batch sampler (Alg. 1 lines 2 & 4 + App. A.3.1 normalization).

A numpy copy of ``repro.graph.sampler``: the same seed gives the same
partition and the same ``PaddedSubgraph`` stream. Partitions V into B
clusters once (preprocessing), then per training step uniformly samples ``c``
clusters without replacement and emits the padded extended subgraph. Shapes
are fixed per sampler instance, so every batch has one set of tensor shapes.

Two sampling APIs coexist:

* the *stateful* API (:meth:`ClusterSampler.sample` / ``epoch``) advances the
  sampler's own RNG — the synchronous-trainer path;
* the *schedule* API (:meth:`ClusterSampler.clusters_at`) is a pure function
  of ``(seed, index)`` with no mutable state, for an asynchronous batch
  pipeline: batches can be built by a thread pool in any arrival order and
  the stream is still bit-identical to a synchronous walk of the same
  indices.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from repro_torch.graph.partition import partition_graph
from repro_torch.graph.structure import (Graph, PaddedSubgraph, build_subgraph,
                                         padded_sizes_for)

# domain-separation tags for the schedule API's per-index RNG streams, so
# uniform draws, epoch permutations and the stateful RNG can never collide
_SCHED_UNIFORM = 0x5A3D01
_SCHED_EPOCH = 0x5A3D02

SCHEDULE_MODES = ("uniform", "epoch")


class ClusterSampler:
    """Samples c-cluster mini-batches from a fixed partition of the graph.

    Thread-safety: :meth:`build_batch` and :meth:`clusters_at` are read-only
    with respect to sampler state and safe to call concurrently from worker
    threads. :meth:`sample` / :meth:`epoch` mutate ``self.rng`` and must stay
    on a single thread (the synchronous trainer path).
    """

    def __init__(
        self,
        graph: Graph,
        num_parts: int,
        clusters_per_batch: int = 1,
        *,
        seed: int = 0,
        include_halo: bool = True,
        edge_weight_mode: str = "global",
        beta_spec: tuple[str, float] = ("2x-x2", 1.0),
        parts: Optional[np.ndarray] = None,
        stochastic: bool = True,
    ) -> None:
        """Partition ``graph`` (unless ``parts`` is given) and fix batch shapes.

        Args:
            graph: host-side CSR graph to sample from.
            num_parts: number of clusters B the node set is partitioned into.
            clusters_per_batch: clusters c per mini-batch (Alg. 1 line 4).
            seed: seeds both the stateful RNG and the pure schedule API.
            include_halo: keep 1-hop out-of-batch neighbors (LMC/GAS view);
                ``False`` gives the Cluster-GCN batch-internal view.
            edge_weight_mode: ``"global"`` keeps whole-graph GCN normalization,
                ``"local"`` renormalizes by subgraph degrees (Cluster-GCN).
            beta_spec: ``(score, alpha)`` for the β convex-combination
                coefficients (paper App. A.4).
            parts: externally computed partition vector; skips partitioning.
            stochastic: shuffle cluster grouping per :meth:`epoch` call.
        """
        self.graph = graph
        self.num_parts = int(num_parts)
        self.c = int(clusters_per_batch)
        self.include_halo = include_halo
        self.edge_weight_mode = edge_weight_mode
        self.beta_spec = beta_spec
        self.stochastic = stochastic
        self.seed = int(seed)
        self.rng = np.random.default_rng(seed)
        self.parts = partition_graph(graph, num_parts, seed=seed) if parts is None else parts
        self.degrees = graph.degrees()
        self._nodes_of_part = [np.where(self.parts == p)[0] for p in range(self.num_parts)]
        self.pad_batch, self.pad_halo, self.pad_edges = padded_sizes_for(
            graph, self.parts, self.num_parts, self.c, include_halo)
        self.batches_per_epoch = self.num_parts // self.c

    # -- epoch iteration ----------------------------------------------------
    def epoch(self) -> Iterator[PaddedSubgraph]:
        """Yield B/c batches covering every cluster exactly once (stochastic
        grouping per epoch, matching Cluster-GCN/LMC practice).

        Stateful: advances ``self.rng`` when ``stochastic`` is set.
        """
        order = self.rng.permutation(self.num_parts) if self.stochastic \
            else np.arange(self.num_parts)
        for i in range(self.batches_per_epoch):
            cluster_ids = order[i * self.c:(i + 1) * self.c]
            yield self.build_batch(cluster_ids)

    def sample(self) -> PaddedSubgraph:
        """One uniformly sampled batch of c clusters (Alg. 1 line 4).

        Stateful: advances ``self.rng``; see :meth:`clusters_at` for the pure
        schedule-indexed equivalent used by the prefetch pipeline.
        """
        cluster_ids = self.rng.choice(self.num_parts, size=self.c, replace=False)
        return self.build_batch(cluster_ids)

    # -- pure schedule API (prefetch pipeline) -------------------------------
    def clusters_at(self, index: int, *, mode: str = "uniform") -> np.ndarray:
        """Cluster ids for schedule slot ``index`` — pure in ``(seed, index)``.

        ``mode="uniform"`` draws c clusters without replacement, independently
        per slot (the iid sampling of Alg. 1 line 4). ``mode="epoch"`` walks
        shuffled epochs: slot ``index`` maps to epoch ``index // (B/c)`` and
        position ``index % (B/c)`` inside that epoch's permutation, so every
        ``B/c`` consecutive slots cover each cluster exactly once.

        Because the draw depends only on the sampler seed and the slot index
        (not on any mutable RNG state), prefetch workers may build slots in
        any order and a resumed run replays the identical stream — the
        determinism contract of DESIGN.md §9.
        """
        index = int(index)
        if index < 0:
            raise ValueError(f"schedule index must be >= 0, got {index}")
        if mode == "uniform":
            rng = np.random.default_rng([self.seed, _SCHED_UNIFORM, index])
            return rng.choice(self.num_parts, size=self.c, replace=False)
        if mode == "epoch":
            e, s = divmod(index, self.batches_per_epoch)
            rng = np.random.default_rng([self.seed, _SCHED_EPOCH, e])
            order = rng.permutation(self.num_parts)
            return order[s * self.c:(s + 1) * self.c]
        raise ValueError(f"unknown schedule mode {mode!r}; "
                         f"expected one of {SCHEDULE_MODES}")

    def build_batch(self, cluster_ids: np.ndarray) -> PaddedSubgraph:
        """Materialize the padded extended subgraph for given cluster ids.

        Pure (no RNG) and thread-safe: prefetch workers call this
        concurrently for different schedule slots.
        """
        nodes = np.concatenate([self._nodes_of_part[int(p)] for p in cluster_ids])
        return build_subgraph(
            self.graph, nodes,
            pad_batch=self.pad_batch, pad_halo=self.pad_halo,
            pad_edges=self.pad_edges, num_parts=self.num_parts,
            clusters_in_batch=self.c, include_halo=self.include_halo,
            edge_weight_mode=self.edge_weight_mode, beta_spec=self.beta_spec,
            degrees=self.degrees)

    # -- state for checkpoint/restore ----------------------------------------
    def state_dict(self) -> dict:
        """Checkpointable state: the stateful RNG's bit-generator state."""
        return {"bit_generator": self.rng.bit_generator.state}

    def load_state_dict(self, state: dict) -> None:
        """Restore the stateful RNG (deterministic resume of :meth:`sample`)."""
        self.rng.bit_generator.state = state["bit_generator"]
