"""Saga subsystem: state machines, orchestration, fan-out, checkpoints, DSL."""

from hypervisor_tpu_torch.saga.state_machine import (
    Saga,
    SagaState,
    SagaStateError,
    SagaStep,
    StepState,
    STEP_TRANSITION_MATRIX,
    SAGA_TRANSITION_MATRIX,
)
from hypervisor_tpu_torch.saga.orchestrator import SagaOrchestrator, SagaTimeoutError
from hypervisor_tpu_torch.saga.fan_out import (
    FanOutBranch,
    FanOutGroup,
    FanOutOrchestrator,
    FanOutPolicy,
)
from hypervisor_tpu_torch.saga.checkpoint import CheckpointManager, SemanticCheckpoint
from hypervisor_tpu_torch.saga.dsl import (
    SagaDefinition,
    SagaDSLError,
    SagaDSLFanOut,
    SagaDSLParser,
    SagaDSLStep,
)

__all__ = [
    "Saga",
    "SagaState",
    "SagaStateError",
    "SagaStep",
    "StepState",
    "STEP_TRANSITION_MATRIX",
    "SAGA_TRANSITION_MATRIX",
    "SagaOrchestrator",
    "SagaTimeoutError",
    "FanOutBranch",
    "FanOutGroup",
    "FanOutOrchestrator",
    "FanOutPolicy",
    "CheckpointManager",
    "SemanticCheckpoint",
    "SagaDefinition",
    "SagaDSLError",
    "SagaDSLFanOut",
    "SagaDSLParser",
    "SagaDSLStep",
]
