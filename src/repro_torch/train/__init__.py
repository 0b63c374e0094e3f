"""Training tier: the synchronous LMC trainer, the health guard and fault plans."""
from repro_torch.train.health import (FaultPlan, HealthConfig, HealthGuard,
                                      ServeWorkerFault)
from repro_torch.train.loop import GNNTrainer

__all__ = ["GNNTrainer", "FaultPlan", "HealthConfig", "HealthGuard",
           "ServeWorkerFault"]
