"""The paper's GNN families and the LM zoo as ``nn.Module``s (reference
parameter layouts)."""
from repro_torch.models.gnn import (GNN, EdgeList, LayerAux, make_gnn,
                                    segment_spmm)
from repro_torch.models.lm import LM

__all__ = ["GNN", "EdgeList", "LayerAux", "LM", "make_gnn", "segment_spmm"]
