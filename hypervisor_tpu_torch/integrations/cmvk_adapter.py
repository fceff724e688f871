"""CMVK adapter: behavioral drift detection -> slash/demote decisions.

Capability parity with reference `integrations/cmvk_adapter.py:91-250`:
Protocol-typed verifier, severity ladder 0.15/0.30/0.50/0.75 (injectable
`DriftThresholds`), should_slash = HIGH|CRITICAL, should_demote = MEDIUM,
no-verifier pass-through, per-agent drift history / rate / mean, and an
on-drift callback.

Organized as score -> ladder -> book: one `_score` helper normalizes the
verifier (or its absence) to a (score, explanation) pair, the severity
ladder is data (walked, not if-chained), and results are booked into
per-agent accounts that carry running violation/score sums so the rate
and mean queries are O(1) instead of history scans.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Callable, Optional, Protocol

from hypervisor_tpu_torch.utils.clock import Clock, utc_now


class CMVKVerifier(Protocol):
    """Contract of the external CMVK verify_embeddings."""

    def verify_embeddings(
        self,
        embedding_a: Any,
        embedding_b: Any,
        metric: str = "cosine",
        weights: Any = None,
        threshold_profile: Optional[str] = None,
        explain: bool = False,
    ) -> Any: ...


class DriftSeverity(str, enum.Enum):
    NONE = "none"
    LOW = "low"
    MEDIUM = "medium"
    HIGH = "high"
    CRITICAL = "critical"


@dataclass
class DriftThresholds:
    """Severity cut points (reference `cmvk_adapter.py:77-83`)."""

    low: float = 0.15
    medium: float = 0.30
    high: float = 0.50
    critical: float = 0.75

    def ladder(self) -> tuple[tuple[float, DriftSeverity], ...]:
        """Cut points walked top-down; first match wins."""
        return (
            (self.critical, DriftSeverity.CRITICAL),
            (self.high, DriftSeverity.HIGH),
            (self.medium, DriftSeverity.MEDIUM),
            (self.low, DriftSeverity.LOW),
        )


@dataclass
class DriftCheckResult:
    agent_did: str
    session_id: str
    drift_score: float
    severity: DriftSeverity
    passed: bool
    explanation: Optional[str] = None
    action_id: Optional[str] = None
    checked_at: datetime = field(default_factory=utc_now)

    @property
    def should_slash(self) -> bool:
        return self.severity in (DriftSeverity.HIGH, DriftSeverity.CRITICAL)

    @property
    def should_demote(self) -> bool:
        return self.severity is DriftSeverity.MEDIUM


@dataclass
class _AgentAccount:
    """Per-agent drift bookkeeping with running aggregates."""

    checks: list[DriftCheckResult] = field(default_factory=list)
    violations: int = 0
    score_sum: float = 0.0

    def book(self, result: DriftCheckResult) -> None:
        self.checks.append(result)
        self.score_sum += result.drift_score
        if not result.passed:
            self.violations += 1


class CMVKAdapter:
    """Drift checks with severity classification and per-agent accounts."""

    def __init__(
        self,
        verifier: Optional[CMVKVerifier] = None,
        thresholds: Optional[DriftThresholds] = None,
        on_drift_detected: Optional[Callable[[DriftCheckResult], None]] = None,
        clock: Clock = utc_now,
    ) -> None:
        self._verifier = verifier
        self.thresholds = thresholds or DriftThresholds()
        self._on_drift = on_drift_detected
        self._clock = clock
        self._accounts: dict[str, _AgentAccount] = {}
        self._check_count = 0
        self._violation_count = 0

    # ── the check ───────────────────────────────────────────────────────

    def check_behavioral_drift(
        self,
        agent_did: str,
        session_id: str,
        claimed_embedding: Any,
        observed_embedding: Any,
        action_id: Optional[str] = None,
        metric: str = "cosine",
        threshold_profile: Optional[str] = None,
    ) -> DriftCheckResult:
        """Compare claimed vs observed behavior; classify the drift."""
        score, explanation = self._score(
            claimed_embedding, observed_embedding, metric, threshold_profile
        )
        severity = self._classify(score)
        result = DriftCheckResult(
            agent_did=agent_did,
            session_id=session_id,
            drift_score=score,
            severity=severity,
            passed=severity in (DriftSeverity.NONE, DriftSeverity.LOW),
            explanation=explanation,
            action_id=action_id,
            checked_at=self._clock(),
        )
        self._book(result)
        if not result.passed and self._on_drift is not None:
            self._on_drift(result)
        return result

    def _score(
        self,
        claimed: Any,
        observed: Any,
        metric: str,
        threshold_profile: Optional[str],
    ) -> tuple[float, Optional[str]]:
        """Normalize the verifier (or its absence) to (score, explanation)."""
        if self._verifier is None:
            return 0.0, None  # pass-through: no backing service
        verdict = self._verifier.verify_embeddings(
            embedding_a=claimed,
            embedding_b=observed,
            metric=metric,
            threshold_profile=threshold_profile,
            explain=True,
        )
        explanation = getattr(verdict, "explanation", None)
        return (
            getattr(verdict, "drift_score", 0.0),
            str(explanation) if explanation else None,
        )

    def _classify(self, score: float) -> DriftSeverity:
        for cut, severity in self.thresholds.ladder():
            if score >= cut:
                return severity
        return DriftSeverity.NONE

    def _book(self, result: DriftCheckResult) -> None:
        self._accounts.setdefault(result.agent_did, _AgentAccount()).book(result)
        self._check_count += 1
        if not result.passed:
            self._violation_count += 1

    # ── per-agent queries ───────────────────────────────────────────────

    def get_agent_drift_history(
        self, agent_did: str, session_id: Optional[str] = None
    ) -> list[DriftCheckResult]:
        account = self._accounts.get(agent_did)
        if account is None:
            return []
        if session_id is None:
            return list(account.checks)
        return [r for r in account.checks if r.session_id == session_id]

    def get_drift_rate(
        self, agent_did: str, session_id: Optional[str] = None
    ) -> float:
        account = self._accounts.get(agent_did)
        if account is None or not account.checks:
            return 0.0
        if session_id is None:  # O(1) from the running aggregates
            return account.violations / len(account.checks)
        scoped = self.get_agent_drift_history(agent_did, session_id)
        if not scoped:
            return 0.0
        return sum(1 for r in scoped if not r.passed) / len(scoped)

    def get_mean_drift_score(
        self, agent_did: str, session_id: Optional[str] = None
    ) -> float:
        account = self._accounts.get(agent_did)
        if account is None or not account.checks:
            return 0.0
        if session_id is None:
            return account.score_sum / len(account.checks)
        scoped = self.get_agent_drift_history(agent_did, session_id)
        if not scoped:
            return 0.0
        return sum(r.drift_score for r in scoped) / len(scoped)

    @property
    def total_checks(self) -> int:
        return self._check_count

    @property
    def total_violations(self) -> int:
        return self._violation_count
