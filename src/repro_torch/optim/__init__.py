"""Optimizers on parameter trees: SGD with momentum, AdamW, global-norm clip."""
from repro_torch.optim.optimizers import (Optimizer, adamw, global_norm_clip,
                                          sgd, tree_leaves, tree_map)

__all__ = ["Optimizer", "sgd", "adamw", "global_norm_clip", "tree_map",
           "tree_leaves"]
