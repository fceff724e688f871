"""Quarantine: read-only isolation with forensic preservation.

Capability parity with reference `liability/quarantine.py:56-177`
(reasons enum, default 300s duration, escalation merging into an
existing record, tick() auto-release sweeps, forensic data retention,
filtered history) — re-built around a two-tier store: live records are
keyed by (agent, session) for O(1) membership checks on the hot path,
and every record that leaves the live tier (release, expiry) moves to
an append-only archive. The reference instead linearly scans one flat
dict on every lookup. Quarantined agents keep read access for forensic
replay but cannot write, execute saga steps, or elevate (enforced by
callers via `is_quarantined` — device plane: the FLAG_QUARANTINED bit
in the agent table).
"""

from __future__ import annotations

import enum
import secrets
from dataclasses import dataclass, field
from datetime import datetime, timedelta
from typing import Optional

from hypervisor_tpu_torch.config import DEFAULT_CONFIG
from hypervisor_tpu_torch.utils.clock import Clock, utc_now


class QuarantineReason(str, enum.Enum):
    BEHAVIORAL_DRIFT = "behavioral_drift"
    LIABILITY_VIOLATION = "liability_violation"
    RING_BREACH = "ring_breach"
    RATE_LIMIT_EXCEEDED = "rate_limit_exceeded"
    MANUAL = "manual"
    CASCADE_SLASH = "cascade_slash"


@dataclass
class QuarantineRecord:
    quarantine_id: str = field(
        default_factory=lambda: f"quar:{secrets.token_hex(4)}"
    )
    agent_did: str = ""
    session_id: str = ""
    reason: QuarantineReason = QuarantineReason.MANUAL
    details: str = ""
    entered_at: datetime = field(default_factory=utc_now)
    expires_at: Optional[datetime] = None
    released_at: Optional[datetime] = None
    is_active: bool = True
    forensic_data: dict = field(default_factory=dict)

    @property
    def is_expired(self) -> bool:
        return self.expired_at(utc_now())

    def expired_at(self, now: datetime) -> bool:
        return self.expires_at is not None and now > self.expires_at

    @property
    def duration_seconds(self) -> float:
        end = self.released_at or utc_now()
        return (end - self.entered_at).total_seconds()

    @property
    def remaining_seconds(self) -> float:
        """Seconds until auto-release (0 when lapsed; inf if indefinite)."""
        if self.expires_at is None:
            return float("inf")
        return max(0.0, (self.expires_at - utc_now()).total_seconds())


class QuarantineManager:
    """Two-tier quarantine store: live keyed map + append-only archive."""

    DEFAULT_QUARANTINE_SECONDS = int(
        DEFAULT_CONFIG.quarantine.default_duration_seconds
    )

    def __init__(self, clock: Clock = utc_now) -> None:
        self._clock = clock
        self._live: dict[tuple[str, str], QuarantineRecord] = {}
        self._archive: list[QuarantineRecord] = []

    def quarantine(
        self,
        agent_did: str,
        session_id: str,
        reason: QuarantineReason,
        details: str = "",
        duration_seconds: Optional[int] = None,
        forensic_data: Optional[dict] = None,
    ) -> QuarantineRecord:
        """Isolate an agent; re-quarantining escalates the existing record."""
        live = self.get_active_quarantine(agent_did, session_id)
        if live is not None:
            live.details += f"; escalated: {details}"
            if forensic_data:
                live.forensic_data.update(forensic_data)
            return live

        now = self._clock()
        window = duration_seconds or self.DEFAULT_QUARANTINE_SECONDS
        record = QuarantineRecord(
            agent_did=agent_did,
            session_id=session_id,
            reason=reason,
            details=details,
            entered_at=now,
            expires_at=now + timedelta(seconds=window) if window else None,
            forensic_data=dict(forensic_data or {}),
        )
        self._live[(agent_did, session_id)] = record
        return record

    def release(self, agent_did: str, session_id: str) -> Optional[QuarantineRecord]:
        record = self.get_active_quarantine(agent_did, session_id)
        if record is not None:
            self._retire(record, self._clock())
        return record

    def is_quarantined(self, agent_did: str, session_id: str) -> bool:
        return self.get_active_quarantine(agent_did, session_id) is not None

    def get_active_quarantine(
        self, agent_did: str, session_id: str
    ) -> Optional[QuarantineRecord]:
        """O(1) live lookup; an expired record is lazily retired."""
        record = self._live.get((agent_did, session_id))
        if record is None:
            return None
        now = self._clock()
        if record.expired_at(now):
            self._retire(record, now)
            return None
        return record

    def tick(self) -> list[QuarantineRecord]:
        """Release every expired quarantine; returns the newly released."""
        now = self._clock()
        expired = [r for r in self._live.values() if r.expired_at(now)]
        for record in expired:
            self._retire(record, now)
        return expired

    def get_history(
        self, agent_did: Optional[str] = None, session_id: Optional[str] = None
    ) -> list[QuarantineRecord]:
        match = [
            r
            for r in (*self._archive, *self._live.values())
            if (agent_did is None or r.agent_did == agent_did)
            and (session_id is None or r.session_id == session_id)
        ]
        match.sort(key=lambda r: r.entered_at)
        return match

    @property
    def active_quarantines(self) -> list[QuarantineRecord]:
        now = self._clock()
        return [r for r in self._live.values() if not r.expired_at(now)]

    @property
    def quarantine_count(self) -> int:
        return len(self.active_quarantines)

    def _retire(self, record: QuarantineRecord, now: datetime) -> None:
        record.is_active = False
        record.released_at = now
        self._live.pop((record.agent_did, record.session_id), None)
        self._archive.append(record)
