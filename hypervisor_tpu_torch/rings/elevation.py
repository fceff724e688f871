"""Time-bounded ring elevation (sudo-with-TTL) + ring inheritance.

Capability parity with reference `rings/elevation.py:44-207`: grants must
target a strictly more privileged ring (Ring 0 excluded — SRE Witness
protocol only), one active grant per (agent, session), TTL default 300s
capped at 3600s, `tick()` expiry sweeps, and child agents inheriting
`min(parent+1, 3)`. Uses the injectable clock so expiry is testable and the
device-plane expiry sweep (vectorized compare on an expires_at column) sees
the same timestamps.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from datetime import datetime, timedelta
from typing import Optional

from hypervisor_tpu_torch.config import DEFAULT_CONFIG
from hypervisor_tpu_torch.models import ExecutionRing
from hypervisor_tpu_torch.utils.clock import Clock, utc_now


class RingElevationError(Exception):
    """Invalid elevation request or unknown grant."""


@dataclass
class RingElevation:
    """One time-bounded elevation grant.

    Constructed via `granted()`, which stamps the TTL window from the
    manager's clock; direct construction is for tests back-dating expiry.
    """

    agent_did: str
    session_id: str
    original_ring: ExecutionRing
    elevated_ring: ExecutionRing
    granted_at: datetime
    expires_at: datetime
    attestation: Optional[str] = None
    reason: str = ""
    is_active: bool = True
    elevation_id: str = field(default_factory=lambda: f"elev:{uuid.uuid4().hex[:8]}")

    @classmethod
    def granted(cls, now: datetime, ttl: float, **spec: object) -> "RingElevation":
        return cls(
            granted_at=now,
            expires_at=now + timedelta(seconds=ttl),
            **spec,  # type: ignore[arg-type]
        )

    @property
    def is_expired(self) -> bool:
        return self.expired_at(utc_now())

    def expired_at(self, now: datetime) -> bool:
        return now > self.expires_at

    @property
    def remaining_seconds(self) -> float:
        return max(0.0, (self.expires_at - utc_now()).total_seconds())


class RingElevationManager:
    """Grant table for temporary elevations with inheritance tracking."""

    DEFAULT_TTL = int(DEFAULT_CONFIG.elevation.default_ttl_seconds)
    MAX_ELEVATION_TTL = int(DEFAULT_CONFIG.elevation.max_ttl_seconds)

    def __init__(self, clock: Clock = utc_now) -> None:
        self._clock = clock
        self._grants: dict[str, RingElevation] = {}
        self._parent_of: dict[str, str] = {}
        self._children_of: dict[str, list[str]] = {}

    def request_elevation(
        self,
        agent_did: str,
        session_id: str,
        current_ring: ExecutionRing,
        target_ring: ExecutionRing,
        ttl_seconds: int = 0,
        attestation: Optional[str] = None,
        reason: str = "",
    ) -> RingElevation:
        """Grant a TTL-bounded elevation or raise RingElevationError.

        Refusal rules, checked in order: the target must be strictly more
        privileged; Ring 0 is unreachable here (SRE Witness protocol only);
        and at most one live grant per (agent, session).
        """
        if target_ring.value >= current_ring.value:
            raise RingElevationError(
                f"Target ring {target_ring.value} is not more privileged "
                f"than current ring {current_ring.value}"
            )
        if target_ring is ExecutionRing.RING_0_ROOT:
            raise RingElevationError(
                "Ring 0 elevation not available via elevation manager — "
                "requires SRE Witness protocol"
            )
        held = self.get_active_elevation(agent_did, session_id)
        if held is not None:
            raise RingElevationError(
                f"Agent {agent_did} already has active elevation "
                f"to ring {held.elevated_ring.value}"
            )

        grant = RingElevation.granted(
            self._clock(),
            min(ttl_seconds if ttl_seconds > 0 else self.DEFAULT_TTL,
                self.MAX_ELEVATION_TTL),
            agent_did=agent_did,
            session_id=session_id,
            original_ring=current_ring,
            elevated_ring=target_ring,
            attestation=attestation,
            reason=reason,
        )
        self._grants[grant.elevation_id] = grant
        return grant

    def _live(self, now: datetime):
        """Grants that are active and unexpired as of `now`."""
        return (
            g for g in self._grants.values()
            if g.is_active and not g.expired_at(now)
        )

    def get_active_elevation(
        self, agent_did: str, session_id: str
    ) -> Optional[RingElevation]:
        wanted = (agent_did, session_id)
        return next(
            (g for g in self._live(self._clock())
             if (g.agent_did, g.session_id) == wanted),
            None,
        )

    def get_effective_ring(
        self, agent_did: str, session_id: str, base_ring: ExecutionRing
    ) -> ExecutionRing:
        """Elevated ring if a live grant exists, else the base ring."""
        g = self.get_active_elevation(agent_did, session_id)
        return g.elevated_ring if g is not None else base_ring

    def get(self, elevation_id: str):
        """The grant for one elevation id, or None (any state)."""
        return self._grants.get(elevation_id)

    def revoke_elevation(self, elevation_id: str) -> None:
        g = self._grants.get(elevation_id)
        if g is None:
            raise RingElevationError(f"Elevation {elevation_id} not found")
        g.is_active = False

    def tick(self) -> list[RingElevation]:
        """Expiry sweep; returns newly-expired grants for event emission."""
        now = self._clock()
        expired = [
            g for g in self._grants.values() if g.is_active and g.expired_at(now)
        ]
        for g in expired:
            g.is_active = False
        return expired

    # ── ring inheritance ─────────────────────────────────────────────

    def register_child(
        self, parent_did: str, child_did: str, parent_ring: ExecutionRing
    ) -> ExecutionRing:
        """Record a spawn edge; the child inherits at most parent+1 (capped at 3)."""
        self._parent_of[child_did] = parent_did
        self._children_of.setdefault(parent_did, []).append(child_did)
        return self.get_max_child_ring(parent_ring)

    def get_parent(self, child_did: str) -> Optional[str]:
        return self._parent_of.get(child_did)

    def get_children(self, parent_did: str) -> list[str]:
        return list(self._children_of.get(parent_did, ()))

    @staticmethod
    def get_max_child_ring(parent_ring: ExecutionRing) -> ExecutionRing:
        return ExecutionRing(min(parent_ring.value + 1, ExecutionRing.RING_3_SANDBOX.value))

    @property
    def active_elevations(self) -> list[RingElevation]:
        return list(self._live(self._clock()))

    @property
    def elevation_count(self) -> int:
        return len(self._grants)
