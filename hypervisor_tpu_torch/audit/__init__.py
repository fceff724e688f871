"""Audit subsystem: Merkle-chained deltas, commitments, ephemeral GC."""

from hypervisor_tpu_torch.audit.delta import (
    DeltaEngine,
    SemanticDelta,
    VFSChange,
    merkle_root_device,
    merkle_root_host,
)
from hypervisor_tpu_torch.audit.commitment import CommitmentEngine, CommitmentRecord
from hypervisor_tpu_torch.audit.frontier import MerkleFrontier
from hypervisor_tpu_torch.audit.gc import EphemeralGC, GCResult, RetentionPolicy

__all__ = [
    "DeltaEngine",
    "SemanticDelta",
    "VFSChange",
    "merkle_root_host",
    "merkle_root_device",
    "CommitmentEngine",
    "CommitmentRecord",
    "MerkleFrontier",
    "EphemeralGC",
    "GCResult",
    "RetentionPolicy",
]
