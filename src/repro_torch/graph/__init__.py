"""Graph substrate (numpy): structures and synthetic datasets."""
from repro_torch.graph.structure import (TI_SCALE_CLIP, Graph, PaddedSubgraph,
                                         beta_score, build_subgraph)
from repro_torch.graph.synthetic import DATASET_PRESETS, make_sbm_dataset

__all__ = ["Graph", "PaddedSubgraph", "beta_score", "build_subgraph",
           "TI_SCALE_CLIP", "make_sbm_dataset", "DATASET_PRESETS"]
