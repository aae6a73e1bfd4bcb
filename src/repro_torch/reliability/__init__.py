"""Reliability subsystem of the PyTorch port (mirrors
:mod:`repro.reliability`): correlated failure domains, repair queues, spot
eviction and checkpointed retrains, compiled into the engine's control
stage (see :mod:`repro_torch.reliability.specs` for the declarative layer
and :mod:`repro_torch.reliability.compile` for the tensor lowering)."""
from repro_torch.reliability.compile import (CompiledReliability, RelEvent,
                                             check_no_double_apply,
                                             compile_reliability)
from repro_torch.reliability.specs import (CheckpointSpec, DomainOutageModel,
                                           ReliabilitySpec, RepairSpec,
                                           SpotPoolSpec, TopologySpec)

__all__ = [
    "TopologySpec", "DomainOutageModel", "RepairSpec", "SpotPoolSpec",
    "CheckpointSpec", "ReliabilitySpec", "CompiledReliability", "RelEvent",
    "compile_reliability", "check_no_double_apply",
]
