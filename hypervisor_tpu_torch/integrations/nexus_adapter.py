"""Nexus adapter: external reputation scores -> normalized sigma.

Capability parity with reference `integrations/nexus_adapter.py:92-220`:
Protocol-typed scorer/verifier (no hard dependency), 0-1000 score
normalization, tier mapping at >=900/700/500/300, 300s TTL cache,
slash/outcome push-back with cache invalidation, async peer verification,
defaulting to sigma 0.50 without a scorer.

Batch twist: `resolve_sigma_batch` resolves many DIDs in one pass and
returns a float32 vector ready to drop into the agent table's sigma column.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Optional, Protocol

import numpy as np

from hypervisor_tpu_torch.config import DEFAULT_CONFIG
from hypervisor_tpu_torch.utils.clock import Clock, utc_now

NEXUS_SCORE_SCALE = DEFAULT_CONFIG.trust.score_scale

TIER_TO_SIGMA = {
    "verified_partner": 0.95,
    "trusted": 0.80,
    "standard": 0.60,
    "probationary": 0.35,
    "untrusted": 0.10,
}

# (min score, tier), checked in order.
_TIER_LADDER = (
    (900, "verified_partner"),
    (700, "trusted"),
    (500, "standard"),
    (300, "probationary"),
)


class NexusTrustScorer(Protocol):
    """Contract of the external Nexus ReputationEngine."""

    def calculate_trust_score(
        self,
        verification_level: str,
        history: Any,
        capabilities: Optional[dict] = None,
        privacy: Optional[dict] = None,
    ) -> Any: ...

    def slash_reputation(
        self,
        agent_did: str,
        reason: str,
        severity: str,
        evidence_hash: Optional[str] = None,
        trace_id: Optional[str] = None,
        broadcast: bool = True,
    ) -> Any: ...

    def record_task_outcome(self, agent_did: str, outcome: str) -> Any: ...


class NexusAgentVerifier(Protocol):
    """Contract of the external Nexus AgentRegistry.verify_peer."""

    async def verify_peer(
        self,
        peer_did: str,
        min_score: int = 700,
        required_capabilities: Optional[list[str]] = None,
    ) -> Any: ...


@dataclass
class NexusScoreResult:
    agent_did: str
    raw_nexus_score: int
    normalized_sigma: float
    tier: str
    successful_tasks: int = 0
    failed_tasks: int = 0
    times_slashed: int = 0
    resolved_at: datetime = field(default_factory=utc_now)


class NexusAdapter:
    """Trust-score resolution with TTL caching and reputation push-back."""

    DEFAULT_SIGMA = 0.50

    def __init__(
        self,
        scorer: Optional[NexusTrustScorer] = None,
        verifier: Optional[NexusAgentVerifier] = None,
        cache_ttl_seconds: int = 300,
        clock: Clock = utc_now,
    ) -> None:
        self._scorer = scorer
        self._verifier = verifier
        self._cache_ttl = cache_ttl_seconds
        self._clock = clock
        self._cache: dict[str, NexusScoreResult] = {}

    def resolve_sigma(
        self,
        agent_did: str,
        verification_level: str = "standard",
        history: Optional[Any] = None,
        capabilities: Optional[dict] = None,
    ) -> float:
        """Normalized sigma in [0,1]; cached for `cache_ttl_seconds`."""
        cached = self._cache.get(agent_did)
        if cached is not None and self._fresh(cached):
            return cached.normalized_sigma
        if self._scorer is None:
            return self.DEFAULT_SIGMA

        score = self._scorer.calculate_trust_score(
            verification_level=verification_level,
            history=history,
            capabilities=capabilities,
        )
        raw = getattr(score, "total_score", 500)
        result = NexusScoreResult(
            agent_did=agent_did,
            raw_nexus_score=raw,
            normalized_sigma=raw / NEXUS_SCORE_SCALE,
            tier=self._tier(raw),
            successful_tasks=getattr(score, "successful_tasks", 0),
            failed_tasks=getattr(score, "failed_tasks", 0),
            resolved_at=self._clock(),
        )
        self._cache[agent_did] = result
        return result.normalized_sigma

    def resolve_sigma_batch(
        self, agent_dids: list[str], verification_level: str = "standard"
    ) -> np.ndarray:
        """f32[N] sigma vector for an admission wave (one cache pass)."""
        return np.array(
            [self.resolve_sigma(d, verification_level) for d in agent_dids],
            np.float32,
        )

    def report_task_outcome(self, agent_did: str, outcome: str) -> None:
        if self._scorer:
            self._scorer.record_task_outcome(agent_did, outcome)
            self._cache.pop(agent_did, None)

    def report_slash(
        self,
        agent_did: str,
        reason: str,
        severity: str = "medium",
        evidence_hash: Optional[str] = None,
    ) -> None:
        if self._scorer:
            self._scorer.slash_reputation(
                agent_did=agent_did,
                reason=reason,
                severity=severity,
                evidence_hash=evidence_hash,
            )
            self._cache.pop(agent_did, None)

    async def verify_agent(self, agent_did: str, min_score: int = 500) -> bool:
        """Registry check; permissive when no verifier is wired."""
        if self._verifier is None:
            return True
        result = await self._verifier.verify_peer(agent_did, min_score=min_score)
        return getattr(result, "is_verified", False)

    def get_cached_result(self, agent_did: str) -> Optional[NexusScoreResult]:
        return self._cache.get(agent_did)

    def invalidate_cache(self, agent_did: Optional[str] = None) -> None:
        if agent_did:
            self._cache.pop(agent_did, None)
        else:
            self._cache.clear()

    @staticmethod
    def _tier(score: int) -> str:
        for floor, tier in _TIER_LADDER:
            if score >= floor:
                return tier
        return "untrusted"

    def _fresh(self, result: NexusScoreResult) -> bool:
        return (self._clock() - result.resolved_at).total_seconds() < self._cache_ttl
