"""Fault-tolerant training supervisor (port of ``repro/runtime``)."""

from repro_torch.runtime.supervisor import (FailureInjector, SimulatedFailure,
                                            StepResult, Supervisor,
                                            TrainLoopConfig)

__all__ = ["FailureInjector", "SimulatedFailure", "StepResult", "Supervisor",
           "TrainLoopConfig"]
