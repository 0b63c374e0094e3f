"""Training tier: the supervised LMC trainer, the health guard and fault
plans, elastic rescaling."""
from repro_torch.train.elastic import rescale_lmc_state
from repro_torch.train.health import (FailureInjector, FaultPlan, HealthConfig,
                                      HealthGuard, PipelineFault,
                                      ServeWorkerFault, SimulatedPreemption,
                                      StalenessBudgetError,
                                      TrainingDivergedError)
from repro_torch.train.loop import GNNTrainer

__all__ = ["GNNTrainer", "FailureInjector", "FaultPlan", "HealthConfig",
           "HealthGuard", "PipelineFault", "ServeWorkerFault",
           "SimulatedPreemption", "StalenessBudgetError",
           "TrainingDivergedError", "rescale_lmc_state"]
