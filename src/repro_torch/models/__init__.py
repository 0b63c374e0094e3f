"""The paper's GNN families as an ``nn.Module`` (reference parameter layout)."""
from repro_torch.models.gnn import (GNN, EdgeList, LayerAux, make_gnn,
                                    segment_spmm)

__all__ = ["GNN", "EdgeList", "LayerAux", "make_gnn", "segment_spmm"]
