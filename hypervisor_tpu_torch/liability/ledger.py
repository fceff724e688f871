"""Persistent liability ledger: per-agent risk history and admission scoring.

Capability parity with reference `liability/ledger.py:59-177`: nine entry
types, risk formula (+0.15*max(sev,0.5) per slash, +0.10*max(sev,0.3) per
quarantine, +0.05*sev per fault, -0.05 per clean session, clamped [0,1]),
admit/probation/deny at 0.3/0.6.

Re-designed as an *incremental* ledger: each agent carries a running
accumulator struct updated at record() time with the same weights the
device plane applies to its `risk_score` f32 column, so
`compute_risk_profile` is O(1) instead of the reference's O(history)
re-scan. The raw entry history is still kept per agent for audit reads.
"""

from __future__ import annotations

import enum
import secrets
from dataclasses import dataclass, field
from datetime import datetime
from typing import Optional

from hypervisor_tpu_torch.config import DEFAULT_CONFIG
from hypervisor_tpu_torch.utils.clock import utc_now


class LedgerEntryType(str, enum.Enum):
    VOUCH_GIVEN = "vouch_given"
    VOUCH_RECEIVED = "vouch_received"
    VOUCH_RELEASED = "vouch_released"
    SLASH_RECEIVED = "slash_received"
    SLASH_CASCADED = "slash_cascaded"
    QUARANTINE_ENTERED = "quarantine_entered"
    QUARANTINE_RELEASED = "quarantine_released"
    FAULT_ATTRIBUTED = "fault_attributed"
    CLEAN_SESSION = "clean_session"


#: Risk effect per entry type: (counter, config weight key, severity floor).
#: Weight is looked up on `DEFAULT_CONFIG.ledger` at absorb time. A floor of
#: None means the charge ignores severity entirely (flat credit/charge); the
#: clean-session entry is the one negative (crediting) weight.
_RISK_EFFECTS: dict[LedgerEntryType, tuple[str, str, Optional[float], float]] = {
    LedgerEntryType.SLASH_RECEIVED: ("slashes", "slash_weight", 0.5, +1.0),
    LedgerEntryType.SLASH_CASCADED: ("slashes", "slash_weight", 0.5, +1.0),
    LedgerEntryType.QUARANTINE_ENTERED: (
        "quarantines", "quarantine_weight", 0.3, +1.0),
    LedgerEntryType.FAULT_ATTRIBUTED: ("faults", "fault_weight", 0.0, +1.0),
    LedgerEntryType.CLEAN_SESSION: ("cleans", "clean_session_credit", None, -1.0),
}


@dataclass
class LedgerEntry:
    entry_id: str = field(default_factory=lambda: secrets.token_hex(6))
    agent_did: str = ""
    entry_type: LedgerEntryType = LedgerEntryType.CLEAN_SESSION
    session_id: str = ""
    timestamp: datetime = field(default_factory=utc_now)
    severity: float = 0.0
    details: str = ""
    related_agent: Optional[str] = None


@dataclass
class AgentRiskProfile:
    agent_did: str
    total_entries: int = 0
    slash_count: int = 0
    quarantine_count: int = 0
    clean_session_count: int = 0
    fault_score_avg: float = 0.0
    risk_score: float = 0.0
    recommendation: str = "admit"


@dataclass
class _RiskAccumulator:
    """Running per-agent risk state (device twin: risk_score f32 column)."""

    raw_risk: float = 0.0  # pre-clamp weighted sum
    slashes: int = 0
    quarantines: int = 0
    cleans: int = 0
    faults: int = 0
    fault_severity_sum: float = 0.0
    entries: list[LedgerEntry] = field(default_factory=list)

    def absorb(self, entry: LedgerEntry) -> None:
        effect = _RISK_EFFECTS.get(entry.entry_type)
        if effect is not None:
            counter, weight_key, floor, sign = effect
            setattr(self, counter, getattr(self, counter) + 1)
            weight = getattr(DEFAULT_CONFIG.ledger, weight_key)
            magnitude = 1.0 if floor is None else max(entry.severity, floor)
            self.raw_risk += sign * weight * magnitude
            if entry.entry_type is LedgerEntryType.FAULT_ATTRIBUTED:
                self.fault_severity_sum += entry.severity
        self.entries.append(entry)

    @property
    def risk_score(self) -> float:
        return max(0.0, min(1.0, self.raw_risk))

    def snapshot(self, agent_did: str, recommendation: str) -> AgentRiskProfile:
        """Project the running accumulator into the public profile shape."""
        faults_mean = self.fault_severity_sum / self.faults if self.faults else 0.0
        return AgentRiskProfile(
            agent_did=agent_did,
            total_entries=len(self.entries),
            slash_count=self.slashes,
            quarantine_count=self.quarantines,
            clean_session_count=self.cleans,
            fault_score_avg=round(faults_mean, 4),
            risk_score=round(self.risk_score, 4),
            recommendation=recommendation,
        )


class LiabilityLedger:
    """Append-only liability event history with O(1) running risk profiles."""

    PROBATION_THRESHOLD = DEFAULT_CONFIG.ledger.probation_threshold
    DENY_THRESHOLD = DEFAULT_CONFIG.ledger.deny_threshold

    def __init__(self) -> None:
        self._accounts: dict[str, _RiskAccumulator] = {}
        self._entry_count = 0

    def record(
        self,
        agent_did: str,
        entry_type: LedgerEntryType,
        session_id: str = "",
        **attrs: object,
    ) -> LedgerEntry:
        """Append one event; `attrs` may carry severity, details, and
        related_agent (only — entry_id/timestamp are ledger-assigned)."""
        stray = set(attrs) - {"severity", "details", "related_agent"}
        if stray:
            raise TypeError(f"record() got unexpected fields: {sorted(stray)}")
        entry = LedgerEntry(
            agent_did=agent_did,
            entry_type=entry_type,
            session_id=session_id,
            **attrs,  # type: ignore[arg-type]
        )
        self._accounts.setdefault(agent_did, _RiskAccumulator()).absorb(entry)
        self._entry_count += 1
        return entry

    def get_agent_history(self, agent_did: str) -> list[LedgerEntry]:
        account = self._accounts.get(agent_did)
        return list(account.entries) if account else []

    def _recommend(self, risk: float) -> str:
        """Descend the threshold ladder (deny ≥ 0.6, probation ≥ 0.3)."""
        ladder = (
            (self.DENY_THRESHOLD, "deny"),
            (self.PROBATION_THRESHOLD, "probation"),
        )
        return next(
            (label for threshold, label in ladder if risk >= threshold), "admit"
        )

    def compute_risk_profile(self, agent_did: str) -> AgentRiskProfile:
        """O(1) read of the running accumulator (formula in module docstring)."""
        account = self._accounts.get(agent_did)
        if account is None or not account.entries:
            return AgentRiskProfile(agent_did=agent_did, recommendation="admit")
        return account.snapshot(agent_did, self._recommend(account.risk_score))

    def should_admit(self, agent_did: str) -> tuple[bool, str]:
        profile = self.compute_risk_profile(agent_did)
        if profile.recommendation == "deny":
            return False, f"Risk score {profile.risk_score:.2f} exceeds threshold"
        return True, profile.recommendation

    @property
    def total_entries(self) -> int:
        return self._entry_count

    @property
    def tracked_agents(self) -> list[str]:
        return list(self._accounts)
