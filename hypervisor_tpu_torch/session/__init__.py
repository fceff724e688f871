"""Shared Session Objects: lifecycle FSM + participant registry + VFS substrate.

Capability parity with reference `session/__init__.py:20-191`: the five-state
lifecycle (created -> handshaking -> active -> terminating -> archived) with
guarded transitions, join uniqueness/capacity/min-sigma enforcement, ring
updates, consistency-mode forcing, and VFS snapshots that also capture
participant ring/sigma metadata.

In the TPU design a session is one row of the `SessionTable` and its
participants are rows of the `AgentTable`; this host object is the
authoritative single-call API and the writer that keeps those device
columns in sync (see `core.HypervisorState`).
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Any, Optional

from hypervisor_tpu_torch.models import (
    ConsistencyMode,
    ExecutionRing,
    SessionConfig,
    SessionParticipant,
    SessionState,
    new_id,
)
from hypervisor_tpu_torch.session.vfs import SessionVFS, VFSEdit, VFSPermissionError
from hypervisor_tpu_torch.session.vector_clock import (
    CausalViolationError,
    VectorClock,
    VectorClockManager,
)
from hypervisor_tpu_torch.session.intent_locks import (
    DeadlockError,
    IntentLock,
    IntentLockManager,
    LockContentionError,
    LockIntent,
)
from hypervisor_tpu_torch.session.isolation import IsolationLevel

__all__ = [
    "SharedSessionObject",
    "SessionLifecycleError",
    "SessionParticipantError",
    "SessionVFS",
    "VFSEdit",
    "VFSPermissionError",
    "VectorClock",
    "VectorClockManager",
    "CausalViolationError",
    "IntentLock",
    "IntentLockManager",
    "LockIntent",
    "LockContentionError",
    "DeadlockError",
    "IsolationLevel",
]


class SessionLifecycleError(Exception):
    """Invalid session lifecycle transition."""


class SessionParticipantError(Exception):
    """Participant admission / membership violation."""


class SharedSessionObject:
    """One multi-agent Shared Session: FSM + participants + state substrate."""

    def __init__(
        self,
        config: SessionConfig,
        creator_did: str,
        session_id: Optional[str] = None,
    ) -> None:
        self.session_id = session_id or new_id("session")
        self.creator_did = creator_did
        self.config = config
        self.state = SessionState.CREATED
        self.consistency_mode = config.consistency_mode
        self.vfs_namespace = f"/sessions/{self.session_id}"
        self.vfs = SessionVFS(self.session_id, namespace=self.vfs_namespace)
        self.created_at = datetime.now(timezone.utc)
        self.terminated_at: Optional[datetime] = None
        self._participants: dict[str, SessionParticipant] = {}
        self._meta_snapshots: dict[str, Any] = {}

    # ── participants ─────────────────────────────────────────────────

    @property
    def participants(self) -> list[SessionParticipant]:
        return [p for p in self._participants.values() if p.is_active]

    @property
    def participant_count(self) -> int:
        return len(self.participants)

    def join(
        self,
        agent_did: str,
        sigma_raw: float = 0.0,
        sigma_eff: float = 0.0,
        ring: ExecutionRing = ExecutionRing.RING_3_SANDBOX,
    ) -> SessionParticipant:
        """Admit an agent. Enforces uniqueness, capacity, and the session's
        min sigma_eff (sandbox agents are exempt from the sigma floor)."""
        self._expect(SessionState.HANDSHAKING, SessionState.ACTIVE)
        if agent_did in self._participants:
            raise SessionParticipantError(f"Agent {agent_did} already in session")
        if self.participant_count >= self.config.max_participants:
            raise SessionParticipantError(
                f"Session at capacity ({self.config.max_participants})"
            )
        if (
            sigma_eff < self.config.min_sigma_eff
            and ring != ExecutionRing.RING_3_SANDBOX
        ):
            raise SessionParticipantError(
                f"σ_eff {sigma_eff:.2f} below minimum {self.config.min_sigma_eff:.2f}"
            )
        participant = SessionParticipant(
            agent_did=agent_did, ring=ring, sigma_raw=sigma_raw, sigma_eff=sigma_eff
        )
        self._participants[agent_did] = participant
        return participant

    def leave(self, agent_did: str) -> None:
        if agent_did not in self._participants:
            raise SessionParticipantError(f"Agent {agent_did} not in session")
        self._participants[agent_did].is_active = False

    def get_participant(self, agent_did: str) -> SessionParticipant:
        if agent_did not in self._participants:
            raise SessionParticipantError(f"Agent {agent_did} not in session")
        return self._participants[agent_did]

    def update_ring(self, agent_did: str, new_ring: ExecutionRing) -> None:
        self.get_participant(agent_did).ring = new_ring

    # ── lifecycle FSM ────────────────────────────────────────────────

    def _expect(self, *allowed: SessionState) -> None:
        if self.state not in allowed:
            raise SessionLifecycleError(
                f"Operation not allowed in state {self.state.value}. "
                f"Allowed: {[s.value for s in allowed]}"
            )

    def begin_handshake(self) -> None:
        self._expect(SessionState.CREATED)
        self.state = SessionState.HANDSHAKING

    def activate(self) -> None:
        self._expect(SessionState.HANDSHAKING)
        if not self._participants:
            raise SessionLifecycleError("Cannot activate session with no participants")
        self.state = SessionState.ACTIVE

    def terminate(self) -> None:
        self._expect(SessionState.ACTIVE, SessionState.HANDSHAKING)
        self.state = SessionState.TERMINATING
        self.terminated_at = datetime.now(timezone.utc)

    def archive(self) -> None:
        self._expect(SessionState.TERMINATING)
        self.state = SessionState.ARCHIVED

    def force_consistency_mode(self, mode: ConsistencyMode) -> None:
        """Override the consistency mode (e.g. STRONG once non-reversible
        actions register). Device plane: flips the session's mode column,
        routing its updates through the consensus/psum barrier."""
        self.consistency_mode = mode

    # ── snapshots ────────────────────────────────────────────────────

    def create_vfs_snapshot(self, snapshot_id: Optional[str] = None) -> str:
        """Snapshot VFS state + participant ring/sigma metadata (ACTIVE only)."""
        self._expect(SessionState.ACTIVE)
        sid = self.vfs.create_snapshot(snapshot_id)
        self._meta_snapshots[sid] = {
            "created_at": datetime.now(timezone.utc).isoformat(),
            "participant_states": {
                did: {"ring": p.ring.value, "sigma_eff": p.sigma_eff}
                for did, p in self._participants.items()
            },
        }
        return sid

    def restore_vfs_snapshot(self, snapshot_id: str, agent_did: str) -> None:
        self._expect(SessionState.ACTIVE)
        self.vfs.restore_snapshot(snapshot_id, agent_did)

    def __repr__(self) -> str:
        return (
            f"SharedSessionObject(id={self.session_id!r}, state={self.state.value}, "
            f"participants={self.participant_count}, mode={self.consistency_mode.value})"
        )
