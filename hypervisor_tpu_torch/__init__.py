"""PyTorch/CUDA port of the hypervisor's governance wave (NVIDIA Hopper).

This package stands beside the JAX package `hypervisor_tpu`, which stays
the reference: the same tables, the same fused governance wave, the
same results bit for bit. It imports `torch` and numpy only — never
`jax` and never any module of `hypervisor_tpu` (its tests import both).

Idiom:

* tables are plain dataclasses of tensors (`tables.state`), with the
  reference's packed-per-dtype column layout kept bit for bit;
* ops are plain functions on tensors. Where the JAX package donates a
  table to a jitted wave, the port updates the tensor IN PLACE (each
  such function says so in its docstring);
* every entry point takes an explicit `device`, defaulting to "cuda".
  Without CUDA it raises (`resolve_device`); it never drops quietly to
  the CPU. Tests pass `device="cpu"`;
* the wave's hand-written Hopper kernels (`kernels.mtu`, `kernels.wave`,
  sources in `csrc/`) run for CUDA tensors; CPU tensors take each
  kernel's plain PyTorch version beside it;
* the `Hypervisor` facade (`core`) and its host engines (sessions, rings,
  liability, sagas, audit, verification, security, integrations) are
  the reference's, with the same names: `Hypervisor()` builds its state
  on CUDA, `Hypervisor(device="cpu")` on the CPU.

**u32 convention.** torch's CPU `uint32` has no add, shift or
bitwise-not, so every u32 word (SHA-256 message and digest words, u32
metric counters and histogram buckets) is STORED as an `int32` tensor
holding the same 32 bits. At the numpy boundary that is
`arr.view(np.int32)` in and `arr.view(np.uint32)` out (`u32.py`). The
plain SHA-256 computes in `int64` masked with `& 0xFFFFFFFF`; the CUDA
kernels reinterpret the same storage as `uint32_t`.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for
    but absent (the port never falls back to the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hypervisor_tpu_torch: CUDA is not available on this machine; "
            "pass device='cpu' explicitly to run the plain PyTorch path"
        )
    return dev


from hypervisor_tpu_torch.config import DEFAULT_CONFIG, HypervisorConfig  # noqa: E402
from hypervisor_tpu_torch.core import Hypervisor, ManagedSession  # noqa: E402
from hypervisor_tpu_torch.models import (  # noqa: E402
    ActionDescriptor,
    ConsistencyMode,
    ExecutionRing,
    ReversibilityLevel,
    SessionConfig,
    SessionParticipant,
    SessionState,
)
from hypervisor_tpu_torch.session import (  # noqa: E402
    CausalViolationError,
    DeadlockError,
    IntentLock,
    IntentLockManager,
    IsolationLevel,
    LockContentionError,
    LockIntent,
    SessionLifecycleError,
    SessionParticipantError,
    SessionVFS,
    SharedSessionObject,
    VectorClock,
    VectorClockManager,
    VFSEdit,
    VFSPermissionError,
)
from hypervisor_tpu_torch.rings import (  # noqa: E402
    ActionClassifier,
    AgentCallProfile,
    BreachEvent,
    BreachSeverity,
    ClassificationResult,
    RingBreachDetector,
    RingCheckResult,
    RingElevation,
    RingElevationError,
    RingElevationManager,
    RingEnforcer,
)
from hypervisor_tpu_torch.liability import (  # noqa: E402
    AgentRiskProfile,
    AttributionResult,
    CausalAttributor,
    CausalNode,
    FaultAttribution,
    LedgerEntry,
    LedgerEntryType,
    LiabilityEdge,
    LiabilityLedger,
    LiabilityMatrix,
    QuarantineManager,
    QuarantineReason,
    QuarantineRecord,
    SlashingEngine,
    SlashResult,
    VoucherClip,
    VouchingEngine,
    VouchingError,
    VouchRecord,
)
from hypervisor_tpu_torch.reversibility import (  # noqa: E402
    ReversibilityEntry,
    ReversibilityRegistry,
)
from hypervisor_tpu_torch.saga import (  # noqa: E402
    CheckpointManager,
    FanOutBranch,
    FanOutGroup,
    FanOutOrchestrator,
    FanOutPolicy,
    Saga,
    SagaDefinition,
    SagaDSLError,
    SagaDSLFanOut,
    SagaDSLParser,
    SagaDSLStep,
    SagaOrchestrator,
    SagaState,
    SagaStateError,
    SagaStep,
    SagaTimeoutError,
    SemanticCheckpoint,
    StepState,
)
from hypervisor_tpu_torch.audit import (  # noqa: E402
    CommitmentEngine,
    CommitmentRecord,
    DeltaEngine,
    EphemeralGC,
    GCResult,
    RetentionPolicy,
    SemanticDelta,
    VFSChange,
)
from hypervisor_tpu_torch.verification import (  # noqa: E402
    TransactionHistoryVerifier,
    TransactionRecord,
    VerificationResult,
    VerificationStatus,
)
from hypervisor_tpu_torch.observability import (  # noqa: E402
    CausalTraceId,
    EventHandler,
    EventType,
    HypervisorEvent,
    HypervisorEventBus,
)
from hypervisor_tpu_torch.security import (  # noqa: E402
    AgentRateLimiter,
    HandoffStatus,
    KillReason,
    KillResult,
    KillSwitch,
    RateLimitExceeded,
    RateLimitStats,
    StepHandoff,
    TokenBucket,
)

__all__ = [
    "resolve_device",
    "DEFAULT_CONFIG",
    "HypervisorConfig",
    "Hypervisor",
    "ManagedSession",
    "ActionDescriptor",
    "ConsistencyMode",
    "ExecutionRing",
    "ReversibilityLevel",
    "SessionConfig",
    "SessionParticipant",
    "SessionState",
    "SharedSessionObject",
    "SessionLifecycleError",
    "SessionParticipantError",
    "SessionVFS",
    "VFSEdit",
    "VFSPermissionError",
    "VectorClock",
    "VectorClockManager",
    "CausalViolationError",
    "IntentLock",
    "IntentLockManager",
    "LockIntent",
    "LockContentionError",
    "DeadlockError",
    "IsolationLevel",
    "RingEnforcer",
    "RingCheckResult",
    "ActionClassifier",
    "ClassificationResult",
    "RingElevation",
    "RingElevationError",
    "RingElevationManager",
    "RingBreachDetector",
    "BreachEvent",
    "BreachSeverity",
    "AgentCallProfile",
    "VouchingEngine",
    "VouchingError",
    "VouchRecord",
    "SlashingEngine",
    "SlashResult",
    "VoucherClip",
    "LiabilityMatrix",
    "LiabilityEdge",
    "CausalAttributor",
    "CausalNode",
    "FaultAttribution",
    "AttributionResult",
    "QuarantineManager",
    "QuarantineReason",
    "QuarantineRecord",
    "LiabilityLedger",
    "LedgerEntry",
    "LedgerEntryType",
    "AgentRiskProfile",
    "ReversibilityRegistry",
    "ReversibilityEntry",
    "Saga",
    "SagaState",
    "SagaStateError",
    "SagaStep",
    "StepState",
    "SagaOrchestrator",
    "SagaTimeoutError",
    "FanOutOrchestrator",
    "FanOutPolicy",
    "FanOutGroup",
    "FanOutBranch",
    "CheckpointManager",
    "SemanticCheckpoint",
    "SagaDSLParser",
    "SagaDSLError",
    "SagaDefinition",
    "SagaDSLStep",
    "SagaDSLFanOut",
    "DeltaEngine",
    "SemanticDelta",
    "VFSChange",
    "CommitmentEngine",
    "CommitmentRecord",
    "EphemeralGC",
    "GCResult",
    "RetentionPolicy",
    "TransactionHistoryVerifier",
    "TransactionRecord",
    "VerificationResult",
    "VerificationStatus",
    "HypervisorEventBus",
    "HypervisorEvent",
    "EventType",
    "EventHandler",
    "CausalTraceId",
    "AgentRateLimiter",
    "RateLimitExceeded",
    "RateLimitStats",
    "TokenBucket",
    "KillSwitch",
    "KillReason",
    "KillResult",
    "HandoffStatus",
    "StepHandoff",
]
