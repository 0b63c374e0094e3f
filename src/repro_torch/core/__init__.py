"""LMC core: the paper's primary contribution.

  history.py   — historical embedding / auxiliary-variable stores (H̄, V̄)
  methods.py   — LMC / GAS / Cluster-GCN / ablations as one config space
  lmc.py       — the training step (make_train_step) and the compensated
                 forward (make_infer_step), with deferred store writes
  exact.py     — full-batch ground truth and exact per-layer values
"""
from repro_torch.core.history import HistoricalState, init_history
from repro_torch.core.methods import (CB_ONLY, CF_ONLY, CLUSTER, GAS, LMC,
                                      METHODS, RHO_BUDGET_DEFAULT, TI,
                                      MBMethod)
from repro_torch.core.lmc import (AGG_BACKENDS, Batch, commit_rows,
                                  host_batch, make_infer_step,
                                  make_train_step, to_device_batch)
from repro_torch.core.exact import (FullGraphData, accuracy,
                                    backward_sgd_grads, exact_layer_values,
                                    from_graph, full_grads, full_loss)

__all__ = [
    "HistoricalState", "init_history", "MBMethod", "METHODS",
    "LMC", "GAS", "CLUSTER", "CF_ONLY", "CB_ONLY", "TI", "RHO_BUDGET_DEFAULT",
    "AGG_BACKENDS", "Batch", "host_batch", "make_train_step",
    "make_infer_step", "commit_rows", "to_device_batch", "FullGraphData",
    "from_graph", "full_loss", "full_grads", "accuracy",
    "exact_layer_values", "backward_sgd_grads",
]
