"""Graph data structures (numpy; a copy of ``repro.graph.structure``).

Host-side graphs are CSR over numpy; the device-facing mini-batch structure
(:class:`PaddedSubgraph`) is a statically-shaped padded COO over the *extended*
node set ``V_B ∪ (N(V_B) \\ V_B)`` — exactly the working set of LMC's Eq. (8)-(13).

Conventions
-----------
* Local row layout of a subgraph: rows ``[0, n_batch)`` are in-batch nodes,
  rows ``[n_batch, n_batch + n_halo)`` are 1-hop halo nodes.
* Edges are directed ``src -> dst`` message edges; the graph is undirected so
  both directions are materialized. Edges whose *destination* is a halo node and
  whose *source* is outside the extended set do not exist in the subgraph — this
  is what makes halo-row aggregations "incomplete up-to-date" (Eq. 10/13).
* Padding: padded edges have weight 0 and point at row 0; padded node rows have
  mask 0 and global id clipped to a valid index (store scatter/gather uses the
  mask to suppress them).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((int(x) + m - 1) // m) * m


# Upper bound on the message-invariance scale α = W_tot/W_in (backend="ti").
# α is the amplification applied to a halo node's in-subgraph messages; a node
# that shares only a sliver of its incident weight with the subgraph would
# otherwise amplify that sliver (and its noise) unboundedly. METIS-style
# partitions keep most weight internal, so the clip is rarely active.
TI_SCALE_CLIP = 32.0


@dataclasses.dataclass
class Graph:
    """Undirected graph in CSR form with features/labels/splits (host side)."""

    indptr: np.ndarray       # (n+1,) int64
    indices: np.ndarray      # (nnz,) int32, symmetric
    x: np.ndarray            # (n, dx) float32 node features
    y: np.ndarray            # (n,) int32 labels
    train_mask: np.ndarray   # (n,) bool
    val_mask: np.ndarray     # (n,) bool
    test_mask: np.ndarray    # (n,) bool
    name: str = "graph"

    @property
    def num_nodes(self) -> int:
        """Node count n."""
        return int(self.indptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        """Directed message-edge count (2x undirected edges)."""
        return int(self.indices.shape[0])

    @property
    def num_classes(self) -> int:
        """Label count (max label + 1)."""
        return int(self.y.max()) + 1

    @property
    def feature_dim(self) -> int:
        """Node feature dimension dx."""
        return int(self.x.shape[1])

    def degrees(self) -> np.ndarray:
        """Per-node (directed) degree, shape (n,) int64."""
        return np.diff(self.indptr).astype(np.int64)

    def neighbors(self, v: int) -> np.ndarray:
        """Neighbor ids of node ``v`` (a CSR slice view)."""
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    @staticmethod
    def from_edges(n: int, src: np.ndarray, dst: np.ndarray, x: np.ndarray,
                   y: np.ndarray, train_mask: np.ndarray, val_mask: np.ndarray,
                   test_mask: np.ndarray, name: str = "graph") -> "Graph":
        """Build a symmetric, dedup'd, self-loop-free CSR graph from edge lists."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        keep = src != dst
        src, dst = src[keep], dst[keep]
        # symmetrize + dedup via sorted unique of encoded pairs
        a = np.concatenate([src, dst])
        b = np.concatenate([dst, src])
        code = a * n + b
        code = np.unique(code)
        a, b = code // n, code % n
        order = np.argsort(a, kind="stable")
        a, b = a[order], b[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, a + 1, 1)
        indptr = np.cumsum(indptr)
        return Graph(indptr=indptr, indices=b.astype(np.int32), x=x, y=y,
                     train_mask=train_mask, val_mask=val_mask,
                     test_mask=test_mask, name=name)

    def gcn_edge_weights(self, src: np.ndarray, dst: np.ndarray,
                         degrees: Optional[np.ndarray] = None) -> np.ndarray:
        """Symmetric GCN normalization 1/sqrt((d_i+1)(d_j+1)) w/ self loops."""
        if degrees is None:
            degrees = self.degrees()
        d = degrees.astype(np.float64) + 1.0
        return (1.0 / np.sqrt(d[src] * d[dst])).astype(np.float32)


@dataclasses.dataclass
class PaddedSubgraph:
    """Statically-shaped device mini-batch for LMC / GAS / Cluster training.

    All arrays are numpy on build; the trainer moves them to device. Shapes are
    padded to sampler-level maxima so every batch of an epoch has one shape.
    """

    batch_gids: np.ndarray   # (NB,) int32 global ids of in-batch nodes (clipped pad)
    halo_gids: np.ndarray    # (NH,) int32 global ids of halo nodes (clipped pad)
    batch_mask: np.ndarray   # (NB,) float32 1/0 validity
    halo_mask: np.ndarray    # (NH,) float32
    edge_src: np.ndarray     # (E,) int32 local src rows (into [0, NB+NH))
    edge_dst: np.ndarray     # (E,) int32 local dst rows
    edge_w: np.ndarray       # (E,) float32, 0 for padding
    labels: np.ndarray       # (NB+NH,) int32 (0 where unlabeled/pad)
    labeled_mask: np.ndarray  # (NB+NH,) float32: train-labeled & valid
    beta: np.ndarray         # (NH,) float32 convex combination coefficients
    loss_scale: np.ndarray   # () float32: b/(c*|V_L|)  (App. A.3.1, Eq. 14)
    grad_scale: np.ndarray   # () float32: b/c          (App. A.3.1, Eq. 15)
    # (NH,) float32 message-invariance scales α_i = W_tot(i)/W_in(i): ratio of
    # a halo node's full-graph incident GCN edge weight to its in-subgraph
    # incident weight; 0 on padding rows. backend="ti" (DESIGN.md §11) uses
    # α ⊙ fresh as the compensation estimate instead of a store gather.
    ti_scale: np.ndarray = None
    # metadata (host only)
    n_batch_real: int = 0
    n_halo_real: int = 0
    n_edges_real: int = 0

    @property
    def n_batch(self) -> int:
        """Padded in-batch row count NB."""
        return int(self.batch_gids.shape[0])

    @property
    def n_halo(self) -> int:
        """Padded halo row count NH."""
        return int(self.halo_gids.shape[0])

    @property
    def n_ext(self) -> int:
        """Extended-set row count NB + NH (the local id space)."""
        return self.n_batch + self.n_halo


def beta_score(local_deg: np.ndarray, global_deg: np.ndarray,
               score: str = "2x-x2", alpha: float = 1.0) -> np.ndarray:
    """β_i = score(deg_local/deg_global) * α  (paper App. A.4)."""
    x = local_deg.astype(np.float64) / np.maximum(global_deg, 1)
    if score == "x2":
        s = x * x
    elif score == "2x-x2":
        s = 2 * x - x * x
    elif score == "x":
        s = x
    elif score == "1":
        s = np.ones_like(x)
    elif score == "sin":
        s = np.sin(x)
    else:
        raise ValueError(f"unknown beta score {score!r}")
    return np.clip(s * alpha, 0.0, 1.0).astype(np.float32)


def build_subgraph(
    graph: Graph,
    batch_nodes: np.ndarray,
    *,
    pad_batch: int,
    pad_halo: int,
    pad_edges: int,
    num_parts: int,
    clusters_in_batch: int,
    include_halo: bool = True,
    edge_weight_mode: str = "global",
    beta_spec: tuple[str, float] = ("2x-x2", 1.0),
    degrees: Optional[np.ndarray] = None,
) -> PaddedSubgraph:
    """Construct the padded extended subgraph for a sampled mini-batch.

    ``include_halo=False`` gives the Cluster-GCN view (edges internal to the
    batch only); ``edge_weight_mode='local'`` renormalizes by subgraph degrees
    (Cluster-GCN), ``'global'`` keeps whole-graph GCN normalization (GAS/LMC).
    """
    n = graph.num_nodes
    if degrees is None:
        degrees = graph.degrees()
    batch_nodes = np.asarray(batch_nodes, dtype=np.int64)
    nb = batch_nodes.shape[0]
    if nb > pad_batch:
        raise ValueError(f"batch {nb} exceeds pad_batch {pad_batch}")

    in_batch = np.zeros(n, dtype=bool)
    in_batch[batch_nodes] = True

    # gather all out-edges of batch nodes
    counts = (graph.indptr[batch_nodes + 1] - graph.indptr[batch_nodes]).astype(np.int64)
    nbr_of_batch = np.concatenate(
        [graph.indices[graph.indptr[v]:graph.indptr[v + 1]] for v in batch_nodes]
    ) if nb else np.zeros(0, np.int32)
    dst_rep = np.repeat(batch_nodes, counts)  # edges src=neighbor -> dst=batch node

    if include_halo:
        halo_nodes = np.unique(nbr_of_batch[~in_batch[nbr_of_batch]])
    else:
        halo_nodes = np.zeros(0, dtype=np.int64)
    nh = halo_nodes.shape[0]
    if nh > pad_halo:
        raise ValueError(f"halo {nh} exceeds pad_halo {pad_halo}")

    # local ids: batch rows [0, pad_batch), halo rows [pad_batch, ...)
    local_of = np.full(n, -1, dtype=np.int64)
    local_of[batch_nodes] = np.arange(nb)
    local_of[halo_nodes] = pad_batch + np.arange(nh)

    # Edges into batch rows: every neighbor of a batch node is in the extended set.
    e1_src_g = nbr_of_batch.astype(np.int64)
    e1_dst_g = dst_rep
    if not include_halo:
        keep = in_batch[e1_src_g]
        e1_src_g, e1_dst_g = e1_src_g[keep], e1_dst_g[keep]

    # Edges into halo rows: only sources inside the extended set survive (Eq. 10).
    if nh:
        hcounts = (graph.indptr[halo_nodes + 1] - graph.indptr[halo_nodes]).astype(np.int64)
        nbr_of_halo = np.concatenate(
            [graph.indices[graph.indptr[v]:graph.indptr[v + 1]] for v in halo_nodes])
        hdst = np.repeat(halo_nodes, hcounts)
        keep = local_of[nbr_of_halo] >= 0
        e2_src_g = nbr_of_halo[keep].astype(np.int64)
        e2_dst_g = hdst[keep]
        halo_local_deg = np.bincount(
            np.searchsorted(halo_nodes, e2_dst_g), minlength=nh).astype(np.int64)
        # message-invariance scales (backend="ti", DESIGN.md §11): per halo
        # node, the ratio of its *full-graph* incident GCN edge weight to its
        # *in-subgraph* incident weight. Always the global normalization —
        # W_tot has no meaning under subgraph-local renormalization. W_in > 0
        # for every real halo node (the batch neighbor that pulled it in is
        # in the subgraph, and the graph is symmetric), and W_in ⊆ W_tot so
        # α >= 1; the clip only bounds pathological fringe nodes whose
        # in-subgraph weight is a sliver of their total.
        w_tot = np.bincount(np.searchsorted(halo_nodes, hdst),
                            weights=graph.gcn_edge_weights(
                                nbr_of_halo.astype(np.int64), hdst, degrees),
                            minlength=nh)
        w_in = np.bincount(np.searchsorted(halo_nodes, e2_dst_g),
                           weights=graph.gcn_edge_weights(
                               e2_src_g, e2_dst_g, degrees),
                           minlength=nh)
        halo_ti = np.clip(w_tot / np.maximum(w_in, 1e-12),
                          1.0, TI_SCALE_CLIP).astype(np.float32)
    else:
        e2_src_g = e2_dst_g = np.zeros(0, dtype=np.int64)
        halo_local_deg = np.zeros(0, dtype=np.int64)
        halo_ti = np.zeros(0, dtype=np.float32)

    src_g = np.concatenate([e1_src_g, e2_src_g])
    dst_g = np.concatenate([e1_dst_g, e2_dst_g])
    ne = src_g.shape[0]
    if ne > pad_edges:
        raise ValueError(f"edges {ne} exceed pad_edges {pad_edges}")

    if edge_weight_mode == "global":
        ew = graph.gcn_edge_weights(src_g, dst_g, degrees)
    elif edge_weight_mode == "local":
        # degrees within the sub-view (Cluster-GCN renormalization)
        ld = np.zeros(n, dtype=np.int64)
        np.add.at(ld, dst_g, 1)
        d = ld.astype(np.float64) + 1.0
        ew = (1.0 / np.sqrt(d[src_g] * d[dst_g])).astype(np.float32)
    else:
        raise ValueError(edge_weight_mode)

    # padded arrays
    bg = np.zeros(pad_batch, np.int32)
    bg[:nb] = batch_nodes
    hg = np.zeros(pad_halo, np.int32)
    hg[:nh] = halo_nodes
    bm = np.zeros(pad_batch, np.float32)
    bm[:nb] = 1
    hm = np.zeros(pad_halo, np.float32)
    hm[:nh] = 1
    es = np.zeros(pad_edges, np.int32)
    ed = np.zeros(pad_edges, np.int32)
    ewp = np.zeros(pad_edges, np.float32)
    es[:ne] = local_of[src_g]
    ed[:ne] = local_of[dst_g]
    ewp[:ne] = ew

    n_ext = pad_batch + pad_halo
    labels = np.zeros(n_ext, np.int32)
    labeled = np.zeros(n_ext, np.float32)
    labels[:nb] = graph.y[batch_nodes]
    labeled[:nb] = graph.train_mask[batch_nodes].astype(np.float32)
    if nh:
        labels[pad_batch:pad_batch + nh] = graph.y[halo_nodes]
        labeled[pad_batch:pad_batch + nh] = graph.train_mask[halo_nodes].astype(np.float32)

    score, alpha = beta_spec
    beta = np.zeros(pad_halo, np.float32)
    ti_scale = np.zeros(pad_halo, np.float32)
    if nh:
        beta[:nh] = beta_score(halo_local_deg, degrees[halo_nodes], score, alpha)
        ti_scale[:nh] = halo_ti

    n_labeled_total = max(int(graph.train_mask.sum()), 1)
    b_over_c = float(num_parts) / float(max(clusters_in_batch, 1))
    loss_scale = np.float32(b_over_c / n_labeled_total)
    grad_scale = np.float32(b_over_c)

    return PaddedSubgraph(
        batch_gids=bg, halo_gids=hg, batch_mask=bm, halo_mask=hm,
        edge_src=es, edge_dst=ed, edge_w=ewp, labels=labels,
        labeled_mask=labeled, beta=beta, loss_scale=loss_scale,
        grad_scale=grad_scale, ti_scale=ti_scale,
        n_batch_real=nb, n_halo_real=nh, n_edges_real=ne)


def padded_sizes_for(graph: Graph, parts: np.ndarray, num_parts: int, c: int,
                     include_halo: bool = True) -> tuple[int, int, int]:
    """Worst-case (pad_batch, pad_halo, pad_edges) over any c-cluster batch.

    Conservative: sums the c largest per-cluster stats, rounded up to friendly
    multiples so one jit shape covers every epoch. Per-cluster halo sizes and
    halo volumes are computed exactly (cheap: one CSR sweep per cluster).
    """
    degrees = graph.degrees()
    src = np.repeat(np.arange(graph.num_nodes), np.diff(graph.indptr))
    dst = graph.indices
    sizes = np.bincount(parts, minlength=num_parts).astype(np.int64)
    vol = np.zeros(num_parts, dtype=np.int64)
    np.add.at(vol, parts, degrees)

    # per-cluster halo node count and halo volume (degrees of halo nodes)
    halo_sizes = np.zeros(num_parts, dtype=np.int64)
    halo_vols = np.zeros(num_parts, dtype=np.int64)
    if include_halo:
        cross = parts[src] != parts[dst]
        for p in range(num_parts):
            # halo of cluster p = unique dst of cross edges leaving p
            h = np.unique(dst[cross & (parts[src] == p)])
            halo_sizes[p] = h.size
            halo_vols[p] = degrees[h].sum()

    top_sizes = np.sort(sizes)[::-1][:c].sum()
    top_vol = np.sort(vol)[::-1][:c].sum()
    top_halo = min(np.sort(halo_sizes)[::-1][:c].sum(), graph.num_nodes)
    top_halo_vol = np.sort(halo_vols)[::-1][:c].sum()

    pad_batch = _round_up(top_sizes, 64)
    pad_halo = _round_up(max(top_halo, 1), 64) if include_halo else 64
    # edges into batch rows ≤ batch volume; edges into halo rows ≤ halo volume
    pad_edges = _round_up(top_vol + top_halo_vol + 64, 256)
    return int(pad_batch), int(pad_halo), int(pad_edges)
