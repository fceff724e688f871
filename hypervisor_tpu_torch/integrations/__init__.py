"""Integration adapters: Nexus (trust), CMVK (drift), IATP (manifests).

All Protocol-based with zero hard dependencies — mock seams for tests
(reference `integrations/__init__.py:1-8`).
"""

from hypervisor_tpu_torch.integrations.nexus_adapter import (
    NexusAdapter,
    NexusAgentVerifier,
    NexusScoreResult,
    NexusTrustScorer,
    TIER_TO_SIGMA,
)
from hypervisor_tpu_torch.integrations.cmvk_adapter import (
    CMVKAdapter,
    CMVKVerifier,
    DriftCheckResult,
    DriftSeverity,
    DriftThresholds,
)
from hypervisor_tpu_torch.integrations.iatp_adapter import (
    IATPAdapter,
    IATPManifest,
    IATPTrustLevel,
    ManifestAnalysis,
    REVERSIBILITY_MAP,
    TRUST_LEVEL_RING_HINTS,
)

__all__ = [
    "NexusAdapter",
    "NexusAgentVerifier",
    "NexusScoreResult",
    "NexusTrustScorer",
    "TIER_TO_SIGMA",
    "CMVKAdapter",
    "CMVKVerifier",
    "DriftCheckResult",
    "DriftSeverity",
    "DriftThresholds",
    "IATPAdapter",
    "IATPManifest",
    "IATPTrustLevel",
    "ManifestAnalysis",
    "REVERSIBILITY_MAP",
    "TRUST_LEVEL_RING_HINTS",
]
