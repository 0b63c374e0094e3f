"""Training-tier support shared with serving: health guard and fault plans."""
from repro_torch.train.health import (FaultPlan, HealthConfig, HealthGuard,
                                      ServeWorkerFault)

__all__ = ["FaultPlan", "HealthConfig", "HealthGuard", "ServeWorkerFault"]
