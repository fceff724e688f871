"""Joint Liability subsystem: vouching, slashing, attribution, quarantine, ledger."""

from hypervisor_tpu_torch.liability.collusion import (
    CollusionDetector,
    CollusionFinding,
)
from hypervisor_tpu_torch.liability.matrix import LiabilityEdge, LiabilityMatrix
from hypervisor_tpu_torch.liability.vouching import VouchingEngine, VouchingError, VouchRecord
from hypervisor_tpu_torch.liability.slashing import SlashingEngine, SlashResult, VoucherClip
from hypervisor_tpu_torch.liability.attribution import (
    AttributionResult,
    CausalAttributor,
    CausalNode,
    FaultAttribution,
)
from hypervisor_tpu_torch.liability.quarantine import (
    QuarantineManager,
    QuarantineReason,
    QuarantineRecord,
)
from hypervisor_tpu_torch.liability.ledger import (
    AgentRiskProfile,
    LedgerEntry,
    LedgerEntryType,
    LiabilityLedger,
)

__all__ = [
    "CollusionDetector",
    "CollusionFinding",
    "LiabilityEdge",
    "LiabilityMatrix",
    "VouchingEngine",
    "VouchingError",
    "VouchRecord",
    "SlashingEngine",
    "SlashResult",
    "VoucherClip",
    "AttributionResult",
    "CausalAttributor",
    "CausalNode",
    "FaultAttribution",
    "QuarantineManager",
    "QuarantineReason",
    "QuarantineRecord",
    "AgentRiskProfile",
    "LedgerEntry",
    "LedgerEntryType",
    "LiabilityLedger",
]
