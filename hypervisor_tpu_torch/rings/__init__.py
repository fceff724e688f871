"""Execution-ring enforcement: the 4-ring privilege gate.

Capability parity with reference `rings/enforcer.py:28-137`. The decision
logic itself lives in the vectorized op `ops.rings.ring_check`; this module
is the host facade that runs the same op on scalars and renders the status
code into the reference's result/reason shape. A 10k-agent enforcement wave
calls the op directly on the agent table columns.
"""

from __future__ import annotations

from dataclasses import dataclass


from hypervisor_tpu_torch.config import DEFAULT_CONFIG
from hypervisor_tpu_torch.models import ActionDescriptor, ExecutionRing
from hypervisor_tpu_torch.ops import rings as ring_ops
from hypervisor_tpu_torch.rings.classifier import ActionClassifier, ClassificationResult
from hypervisor_tpu_torch.rings.elevation import (
    RingElevation,
    RingElevationError,
    RingElevationManager,
)
from hypervisor_tpu_torch.rings.breach_detector import (
    AgentCallProfile,
    BreachEvent,
    BreachSeverity,
    RingBreachDetector,
)

__all__ = [
    "RingCheckResult",
    "RingEnforcer",
    "ActionClassifier",
    "ClassificationResult",
    "RingElevation",
    "RingElevationError",
    "RingElevationManager",
    "AgentCallProfile",
    "BreachEvent",
    "BreachSeverity",
    "RingBreachDetector",
]


@dataclass
class RingCheckResult:
    """Outcome of one privilege-gate check."""

    allowed: bool
    required_ring: ExecutionRing
    agent_ring: ExecutionRing
    sigma_eff: float
    reason: str
    requires_consensus: bool = False
    requires_sre_witness: bool = False


def _render_reason(
    code: int,
    sigma_eff: float,
    agent_ring: int,
    required: int,
    trust=None,
) -> str:
    t = trust if trust is not None else DEFAULT_CONFIG.trust
    if code == ring_ops.CHECK_OK:
        return "Access granted"
    if code == ring_ops.CHECK_NEEDS_SRE_WITNESS:
        return "Ring 0 actions require SRE Witness co-sign"
    if code == ring_ops.CHECK_SIGMA_BELOW_RING1:
        return f"Ring 1 requires σ_eff > {t.ring1_threshold}, got {sigma_eff:.3f}"
    if code == ring_ops.CHECK_NEEDS_CONSENSUS:
        return "Ring 1 non-reversible actions require consensus"
    if code == ring_ops.CHECK_SIGMA_BELOW_RING2:
        return f"Ring 2 requires σ_eff > {t.ring2_threshold}, got {sigma_eff:.3f}"
    return f"Agent ring {agent_ring} insufficient for required ring {required}"


class RingEnforcer:
    """Privilege gate over the 4-ring model (thresholds in `config.TrustConfig`).

    `trust` injects a non-default TrustConfig so host verdicts and
    reasons agree with the device gateway wave, which evaluates at the
    session state's live config (`ops.gateway.check_actions`).
    """

    def __init__(self, trust=None) -> None:
        self.trust = trust if trust is not None else DEFAULT_CONFIG.trust
        # Published threshold attributes follow the injected config.
        self.RING_1_THRESHOLD = self.trust.ring1_threshold
        self.RING_2_THRESHOLD = self.trust.ring2_threshold

    def check(
        self,
        agent_ring: ExecutionRing,
        action: ActionDescriptor,
        sigma_eff: float,
        has_consensus: bool = False,
        has_sre_witness: bool = False,
    ) -> RingCheckResult:
        """Single-action check.

        Scalar mirror of `ops.rings.ring_check` (same precedence, same
        codes); kept in Python so one-off checks don't pay device dispatch.
        Parity between the two is pinned by `tests/parity/test_ring_ops.py`.
        """
        required = action.required_ring
        code = self._check_code(
            agent_ring.value, required.value, sigma_eff, has_consensus,
            has_sre_witness, self.trust,
        )
        return RingCheckResult(
            allowed=code == ring_ops.CHECK_OK,
            required_ring=required,
            agent_ring=agent_ring,
            sigma_eff=sigma_eff,
            reason=_render_reason(
                code, sigma_eff, agent_ring.value, required.value,
                trust=self.trust,
            ),
            requires_consensus=code == ring_ops.CHECK_NEEDS_CONSENSUS,
            requires_sre_witness=code == ring_ops.CHECK_NEEDS_SRE_WITNESS,
        )

    @staticmethod
    def _check_code(
        agent_ring: int,
        required: int,
        sigma_eff: float,
        has_consensus: bool,
        has_sre_witness: bool,
        trust=None,
    ) -> int:
        t = trust if trust is not None else DEFAULT_CONFIG.trust
        if required == 0 and not has_sre_witness:
            return ring_ops.CHECK_NEEDS_SRE_WITNESS
        if required == 1 and sigma_eff < t.ring1_threshold:
            return ring_ops.CHECK_SIGMA_BELOW_RING1
        if required == 1 and not has_consensus:
            return ring_ops.CHECK_NEEDS_CONSENSUS
        if required == 2 and sigma_eff < t.ring2_threshold:
            return ring_ops.CHECK_SIGMA_BELOW_RING2
        if agent_ring > required:
            return ring_ops.CHECK_RING_INSUFFICIENT
        return ring_ops.CHECK_OK

    def compute_ring(
        self, sigma_eff: float, has_consensus: bool = False
    ) -> ExecutionRing:
        """Ring from sigma_eff (scalar path of `ops.rings.compute_rings`)."""
        return ExecutionRing.from_sigma_eff(sigma_eff, has_consensus)

    def should_demote(self, current_ring: ExecutionRing, sigma_eff: float) -> bool:
        """True when the agent's sigma no longer supports its ring."""
        return self.compute_ring(sigma_eff).value > current_ring.value
