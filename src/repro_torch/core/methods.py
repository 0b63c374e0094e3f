"""Mini-batch method space: LMC, GAS, Cluster-GCN, TI and ablations as one
config.

The unified train step (core/lmc.py) is parameterized by how halo (1-hop
out-of-batch) values are approximated in each direction:

  forward  ĥ = (1-β)·H̄(historical) + β·h̃(incomplete fresh)     (Eq. 9)
  backward V̂ = (1-β)·V̄(historical) + β·Ṽ(incomplete fresh)     (Eq. 12)

=> LMC        : fwd 'lmc',        bwd 'lmc'
   GAS        : fwd 'historical', bwd 'none'   (discard halo adjoints)
   Cluster-GCN: sampler drops the halo entirely (include_halo=False)
   C_f-only   : fwd 'lmc',        bwd 'none'   (Fig. 4 ablation)
   C_b-only   : fwd 'historical', bwd 'lmc'
   TI         : fwd 'lmc',        bwd 'lmc', store_writes=False — paired with
                ``make_train_step(..., backend="ti")``, which substitutes the
                message-invariant transform of in-batch messages for every
                H̄/V̄ read (arXiv 2502.19693; DESIGN.md §11). The estimator
                never reads the historical store, so the store refresh is
                pure waste and the method switches it off.

``store_writes`` controls the historical-store *refresh* path (the per-layer
scatter of fresh in-batch rows into H̄/V̄). It is orthogonal to the modes:
switching it off under a store-*reading* mode ('lmc'/'historical') freezes
the store at its initial contents rather than erroring — useful for
ablations, required for the store-free TI estimator.
"""
from __future__ import annotations

import dataclasses

# Thm 2's convergence bound tolerates a bias term geometric in the staleness ρ
# of every historical row read by a step. This is the one shared ρ-budget
# definition: the training tier (train/health.py HealthConfig.rho_budget) and
# the serving tier (serve/policy.py DegradationPolicy) must both read it so
# the two enforcement points cannot drift apart. Measured on the quickstart
# presets the realized ρ of cluster sampling stays well under this; rows past
# the budget are treated as unreliable (training: health event / strict error;
# serving: degrade the request to the store-free ti path).
RHO_BUDGET_DEFAULT = 64


@dataclasses.dataclass(frozen=True)
class MBMethod:
    name: str
    fwd_mode: str = "lmc"       # 'lmc' | 'historical' | 'fresh' | 'none'
    bwd_mode: str = "lmc"       # 'lmc' | 'none' | 'fresh'
    include_halo: bool = True   # sampler-level: False = Cluster-GCN view
    edge_weight_mode: str = "global"  # 'global' (GAS/LMC) | 'local' (Cluster)
    store_writes: bool = True   # refresh H̄/V̄ batch rows each step

    def validate(self) -> None:
        assert self.fwd_mode in ("lmc", "historical", "fresh", "none")
        assert self.bwd_mode in ("lmc", "none", "fresh")
        if not self.include_halo:
            assert self.fwd_mode == "none" and self.bwd_mode == "none"


LMC = MBMethod("lmc", fwd_mode="lmc", bwd_mode="lmc")
GAS = MBMethod("gas", fwd_mode="historical", bwd_mode="none")
CLUSTER = MBMethod("cluster", fwd_mode="none", bwd_mode="none",
                   include_halo=False, edge_weight_mode="local")
CF_ONLY = MBMethod("cf_only", fwd_mode="lmc", bwd_mode="none")
CB_ONLY = MBMethod("cb_only", fwd_mode="historical", bwd_mode="lmc")
TI = MBMethod("ti", fwd_mode="lmc", bwd_mode="lmc", store_writes=False)

METHODS = {m.name: m for m in (LMC, GAS, CLUSTER, CF_ONLY, CB_ONLY, TI)}
