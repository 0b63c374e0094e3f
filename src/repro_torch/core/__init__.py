"""LMC core: the paper's primary contribution (serving half so far).

  history.py   — historical embedding / auxiliary-variable stores (H̄, V̄)
  methods.py   — LMC / GAS / Cluster-GCN / ablations as one config space
  lmc.py       — the compensated forward (make_infer_step)
  exact.py     — full-batch ground truth and exact per-layer values
"""
from repro_torch.core.history import HistoricalState, init_history
from repro_torch.core.methods import (CB_ONLY, CF_ONLY, CLUSTER, GAS, LMC,
                                      METHODS, RHO_BUDGET_DEFAULT, TI,
                                      MBMethod)
from repro_torch.core.lmc import (Batch, commit_rows, host_batch,
                                  make_infer_step, to_device_batch)
from repro_torch.core.exact import (FullGraphData, accuracy,
                                    exact_layer_values, from_graph, full_loss)

__all__ = [
    "HistoricalState", "init_history", "MBMethod", "METHODS",
    "LMC", "GAS", "CLUSTER", "CF_ONLY", "CB_ONLY", "TI", "RHO_BUDGET_DEFAULT",
    "Batch", "host_batch", "make_infer_step", "commit_rows",
    "to_device_batch", "FullGraphData", "from_graph", "full_loss",
    "accuracy", "exact_layer_values",
]
