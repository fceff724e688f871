"""Kill switch: graceful agent termination with saga-step handoff.

Capability parity with reference `security/kill_switch.py:64-180`
(per-session substitute pools, each in-flight step handed to a
substitute or marked COMPENSATED, killed agents removed from the pool,
kill history retained) — with the pool kept as a rotating deque so
consecutive handoffs round-robin across the available substitutes
instead of piling onto the first one.
"""

from __future__ import annotations

import enum
import secrets
from collections import deque
from dataclasses import dataclass, field
from datetime import datetime
from typing import Optional

from hypervisor_tpu_torch.utils.clock import Clock, utc_now


class KillReason(str, enum.Enum):
    BEHAVIORAL_DRIFT = "behavioral_drift"
    RATE_LIMIT = "rate_limit"
    RING_BREACH = "ring_breach"
    MANUAL = "manual"
    QUARANTINE_TIMEOUT = "quarantine_timeout"
    SESSION_TIMEOUT = "session_timeout"


class HandoffStatus(str, enum.Enum):
    PENDING = "pending"
    HANDED_OFF = "handed_off"
    FAILED = "failed"
    COMPENSATED = "compensated"


@dataclass
class StepHandoff:
    step_id: str
    saga_id: str
    from_agent: str
    to_agent: Optional[str] = None
    status: HandoffStatus = HandoffStatus.PENDING


@dataclass
class KillResult:
    kill_id: str = field(default_factory=lambda: f"kill:{secrets.token_hex(4)}")
    agent_did: str = ""
    session_id: str = ""
    reason: KillReason = KillReason.MANUAL
    timestamp: datetime = field(default_factory=utc_now)
    handoffs: list[StepHandoff] = field(default_factory=list)
    handoff_success_count: int = 0
    compensation_triggered: bool = False
    details: str = ""


class KillSwitch:
    """Terminate an agent, rehoming its in-flight saga steps first."""

    def __init__(self, clock: Clock = utc_now) -> None:
        self._clock = clock
        self._log: list[KillResult] = []
        self._pools: dict[str, deque[str]] = {}

    # ── substitute pools ────────────────────────────────────────────────

    def register_substitute(self, session_id: str, agent_did: str) -> None:
        self._pools.setdefault(session_id, deque()).append(agent_did)

    def unregister_substitute(self, session_id: str, agent_did: str) -> None:
        pool = self._pools.get(session_id)
        if pool and agent_did in pool:
            pool.remove(agent_did)

    def drop_session(self, session_id: str) -> None:
        """Retire a terminated session's whole substitute pool (pools
        would otherwise accumulate across session lifetimes forever)."""
        self._pools.pop(session_id, None)

    def substitutes(self, session_id: str) -> list[str]:
        """Current substitute pool for a session (registration order)."""
        return list(self._pools.get(session_id, ()))

    def _next_substitute(self, session_id: str) -> Optional[str]:
        """Rotate the session pool; returns None when it is empty."""
        pool = self._pools.get(session_id)
        if not pool:
            return None
        pool.rotate(-1)
        return pool[-1]

    # ── the switch ──────────────────────────────────────────────────────

    def kill(
        self,
        agent_did: str,
        session_id: str,
        reason: KillReason,
        in_flight_steps: Optional[list[dict]] = None,
        details: str = "",
    ) -> KillResult:
        """Kill with handoff: substitute per step, else route to compensation.

        The victim leaves the substitute pool before rehoming starts, so
        it can never be chosen as its own substitute. Step descriptors
        validate BEFORE any pool mutation: a malformed entry must not
        leave the pool rotated (or the victim unregistered) for a kill
        that then fails.
        """
        for info in in_flight_steps or ():
            if not isinstance(info, dict):
                raise TypeError(
                    f"in_flight_steps entries must be dicts "
                    f"({{'step_id', 'saga_id'}}), got {type(info).__name__}"
                )
        self.unregister_substitute(session_id, agent_did)
        handoffs = [
            self._rehome(info, agent_did, session_id)
            for info in in_flight_steps or ()
        ]
        result = KillResult(
            agent_did=agent_did,
            session_id=session_id,
            reason=reason,
            timestamp=self._clock(),
            handoffs=handoffs,
            handoff_success_count=sum(
                h.status is HandoffStatus.HANDED_OFF for h in handoffs
            ),
            compensation_triggered=any(
                h.status is HandoffStatus.COMPENSATED for h in handoffs
            ),
            details=details,
        )
        self._log.append(result)
        return result

    def _rehome(self, info: dict, victim: str, session_id: str) -> StepHandoff:
        handoff = StepHandoff(
            step_id=info.get("step_id", ""),
            saga_id=info.get("saga_id", ""),
            from_agent=victim,
        )
        substitute = self._next_substitute(session_id)
        if substitute is None:
            handoff.status = HandoffStatus.COMPENSATED
        else:
            handoff.to_agent = substitute
            handoff.status = HandoffStatus.HANDED_OFF
        return handoff

    # ── history ─────────────────────────────────────────────────────────

    @property
    def kill_history(self) -> list[KillResult]:
        return list(self._log)

    @property
    def total_kills(self) -> int:
        return len(self._log)

    @property
    def total_handoffs(self) -> int:
        return sum(r.handoff_success_count for r in self._log)
