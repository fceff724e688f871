"""Ring-breach anomaly detection over sliding call windows.

Capability parity with reference `rings/breach_detector.py:58-218`: per
(agent, session) sliding window (60s, capacity 1000), anomaly rate = share
of calls into more-privileged rings, severity ladder 0.3/0.5/0.7/0.9,
circuit breaker tripping on HIGH/CRITICAL with a 30s cooldown, and a
minimum of 5 windowed calls before analysis.

Array-native re-design: each profile's window is a preallocated numpy ring
buffer of (timestamp f64, called_ring i8) so pruning is a binary search and
the anomaly rate is one vectorized comparison — the same layout the device
plane uses for a [n_agents, window] batched sweep.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from datetime import datetime, timedelta
from typing import Optional

import numpy as np

from hypervisor_tpu_torch.config import DEFAULT_CONFIG, BreachConfig
from hypervisor_tpu_torch.models import ExecutionRing
from hypervisor_tpu_torch.utils.clock import Clock, utc_now


class BreachSeverity(str, enum.Enum):
    NONE = "none"
    LOW = "low"
    MEDIUM = "medium"
    HIGH = "high"
    CRITICAL = "critical"


@dataclass
class BreachEvent:
    agent_did: str
    session_id: str
    severity: BreachSeverity
    anomaly_score: float
    call_count_window: int
    expected_rate: float
    actual_rate: float
    timestamp: datetime = field(default_factory=utc_now)
    details: str = ""


class AgentCallProfile:
    """Ring buffer of recent ring calls for one (agent, session)."""

    __slots__ = (
        "agent_did", "session_id", "_ts", "_called", "_head", "_size",
        "total_calls", "ring_call_counts", "breaker_tripped", "breaker_tripped_at",
    )

    def __init__(self, agent_did: str, session_id: str, capacity: int) -> None:
        self.agent_did = agent_did
        self.session_id = session_id
        self._ts = np.zeros(capacity, np.float64)
        self._called = np.zeros(capacity, np.int8)
        self._head = 0   # next write slot
        self._size = 0
        self.total_calls = 0
        self.ring_call_counts: dict[int, int] = {}
        self.breaker_tripped = False
        self.breaker_tripped_at: Optional[datetime] = None

    def push(self, ts: float, called_ring: int) -> None:
        cap = len(self._ts)
        self._ts[self._head] = ts
        self._called[self._head] = called_ring
        self._head = (self._head + 1) % cap
        self._size = min(self._size + 1, cap)
        self.total_calls += 1
        self.ring_call_counts[called_ring] = self.ring_call_counts.get(called_ring, 0) + 1

    def window(self, cutoff_ts: float) -> tuple[np.ndarray, np.ndarray]:
        """(timestamps, called_rings) of calls at/after the cutoff."""
        cap = len(self._ts)
        if self._size < cap:
            ts = self._ts[: self._size]
            called = self._called[: self._size]
        else:
            order = np.roll(np.arange(cap), -self._head)
            ts = self._ts[order]
            called = self._called[order]
        keep = ts >= cutoff_ts
        return ts[keep], called[keep]


class RingBreachDetector:
    """Sliding-window anomaly scoring with a per-profile circuit breaker."""

    def __init__(
        self,
        window_seconds: int = 0,
        config: BreachConfig = DEFAULT_CONFIG.breach,
        clock: Clock = utc_now,
    ) -> None:
        self.config = config
        self.window_seconds = window_seconds or int(config.window_seconds)
        self._clock = clock
        self._profiles: dict[tuple[str, str], AgentCallProfile] = {}
        self._history: list[BreachEvent] = []

    def record_call(
        self,
        agent_did: str,
        session_id: str,
        agent_ring: ExecutionRing,
        called_ring: ExecutionRing,
    ) -> Optional[BreachEvent]:
        """Log one ring call; returns a BreachEvent when anomalous."""
        key = (agent_did, session_id)
        profile = self._profiles.get(key)
        if profile is None:
            profile = AgentCallProfile(agent_did, session_id, self.config.window_capacity)
            self._profiles[key] = profile

        now = self._clock()
        profile.push(now.timestamp(), called_ring.value)

        if profile.breaker_tripped and profile.breaker_tripped_at is not None:
            cooldown_end = profile.breaker_tripped_at + timedelta(
                seconds=self.config.circuit_breaker_cooldown_seconds
            )
            if now < cooldown_end:
                return None

        return self._analyze(profile, agent_ring, now)

    def _analyze(
        self, profile: AgentCallProfile, agent_ring: ExecutionRing, now: datetime
    ) -> Optional[BreachEvent]:
        cutoff = now.timestamp() - self.window_seconds
        _, called = profile.window(cutoff)
        total = len(called)
        if total < self.config.min_calls_for_analysis:
            return None

        anomalous = int(np.count_nonzero(called < agent_ring.value))
        rate = anomalous / total
        c = self.config
        if rate >= c.critical_threshold:
            severity = BreachSeverity.CRITICAL
        elif rate >= c.high_threshold:
            severity = BreachSeverity.HIGH
        elif rate >= c.medium_threshold:
            severity = BreachSeverity.MEDIUM
        elif rate >= c.low_threshold:
            severity = BreachSeverity.LOW
        else:
            return None

        if severity in (BreachSeverity.HIGH, BreachSeverity.CRITICAL):
            profile.breaker_tripped = True
            profile.breaker_tripped_at = now

        event = BreachEvent(
            agent_did=profile.agent_did,
            session_id=profile.session_id,
            severity=severity,
            anomaly_score=rate,
            call_count_window=total,
            expected_rate=0.0,
            actual_rate=rate,
            timestamp=now,
            details=(
                f"{anomalous}/{total} calls to more-privileged rings "
                f"in {self.window_seconds}s window"
            ),
        )
        self._history.append(event)
        return event

    def is_breaker_tripped(self, agent_did: str, session_id: str) -> bool:
        """Breaker state with automatic cooldown release."""
        profile = self._profiles.get((agent_did, session_id))
        if profile is None or not profile.breaker_tripped:
            return False
        if profile.breaker_tripped_at is not None:
            cooldown_end = profile.breaker_tripped_at + timedelta(
                seconds=self.config.circuit_breaker_cooldown_seconds
            )
            if self._clock() >= cooldown_end:
                profile.breaker_tripped = False
                return False
        return True

    def reset_breaker(self, agent_did: str, session_id: str) -> None:
        profile = self._profiles.get((agent_did, session_id))
        if profile is not None:
            profile.breaker_tripped = False
            profile.breaker_tripped_at = None

    def get_agent_stats(self, agent_did: str, session_id: str) -> dict:
        profile = self._profiles.get((agent_did, session_id))
        if profile is None:
            return {"total_calls": 0, "window_calls": 0, "breaker_tripped": False}
        cutoff = self._clock().timestamp() - self.window_seconds
        _, called = profile.window(cutoff)
        return {
            "total_calls": profile.total_calls,
            "window_calls": len(called),
            "breaker_tripped": profile.breaker_tripped,
            "ring_distribution": dict(profile.ring_call_counts),
        }

    @property
    def breach_history(self) -> list[BreachEvent]:
        return list(self._history)

    @property
    def breach_count(self) -> int:
        return len(self._history)
