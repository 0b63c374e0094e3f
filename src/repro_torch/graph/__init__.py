"""Graph substrate (numpy): structures, partitioning, sampling, synthetic data."""
from repro_torch.graph.structure import (TI_SCALE_CLIP, Graph, PaddedSubgraph,
                                         beta_score, build_subgraph,
                                         padded_sizes_for)
from repro_torch.graph.partition import (edge_cut_fraction, partition_balance,
                                         partition_graph)
from repro_torch.graph.sampler import ClusterSampler
from repro_torch.graph.synthetic import DATASET_PRESETS, make_sbm_dataset

__all__ = ["Graph", "PaddedSubgraph", "beta_score", "build_subgraph",
           "padded_sizes_for", "TI_SCALE_CLIP", "partition_graph",
           "edge_cut_fraction", "partition_balance", "ClusterSampler",
           "make_sbm_dataset", "DATASET_PRESETS"]
