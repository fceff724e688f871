"""Intent locks: declared read/write/exclusive access with deadlock detection.

Capability parity with reference `session/intent_locks.py:48-215`
(compatibility matrix where only READ+READ coexist, contention errors,
wait-for-graph deadlock DFS, release by lock/agent/session, contention
points). The compatibility check is a 3x3 boolean matrix lookup — the same
table the device-plane batched conflict prepass uses.
"""

from __future__ import annotations

import enum
import uuid
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Optional

import numpy as np


class LockIntent(str, enum.Enum):
    READ = "read"
    WRITE = "write"
    EXCLUSIVE = "exclusive"

    @property
    def code(self) -> int:
        return _INTENT_CODES[self]


_INTENT_CODES = {LockIntent.READ: 0, LockIntent.WRITE: 1, LockIntent.EXCLUSIVE: 2}

# compat[existing, requested] — True only for READ+READ.
COMPAT_MATRIX = np.zeros((3, 3), bool)
COMPAT_MATRIX[0, 0] = True


class LockContentionError(Exception):
    """Requested lock conflicts with existing locks."""


class DeadlockError(Exception):
    """Acquiring the lock would close a cycle in the wait-for graph."""


@dataclass
class IntentLock:
    lock_id: str = field(default_factory=lambda: f"lock:{uuid.uuid4().hex[:8]}")
    agent_did: str = ""
    session_id: str = ""
    resource_path: str = ""
    intent: LockIntent = LockIntent.READ
    acquired_at: datetime = field(default_factory=lambda: datetime.now(timezone.utc))
    is_active: bool = True
    saga_step_id: Optional[str] = None


class IntentLockManager:
    """Lock table keyed by resource, with contention + deadlock prechecks."""

    def __init__(self) -> None:
        self._locks: dict[str, IntentLock] = {}
        self._by_resource: dict[str, list[str]] = {}
        self._wait_for: dict[str, set[str]] = {}

    def acquire(
        self,
        agent_did: str,
        session_id: str,
        resource_path: str,
        intent: LockIntent,
        saga_step_id: Optional[str] = None,
    ) -> IntentLock:
        """Acquire or raise LockContentionError / DeadlockError."""
        conflicts = self._conflicting_locks(resource_path, agent_did, intent)
        if conflicts:
            blockers = {c.agent_did for c in conflicts}
            if self._closes_cycle(agent_did, blockers):
                raise DeadlockError(
                    f"Deadlock detected: {agent_did} would wait on "
                    f"{blockers} which are waiting on {agent_did}"
                )
            names = ", ".join(c.agent_did for c in conflicts)
            raise LockContentionError(
                f"Lock contention on {resource_path}: "
                f"{agent_did} ({intent.value}) conflicts with {names}"
            )

        lock = IntentLock(
            agent_did=agent_did,
            session_id=session_id,
            resource_path=resource_path,
            intent=intent,
            saga_step_id=saga_step_id,
        )
        self._locks[lock.lock_id] = lock
        self._by_resource.setdefault(resource_path, []).append(lock.lock_id)
        return lock

    def release(self, lock_id: str) -> None:
        lock = self._locks.get(lock_id)
        if lock is None:
            return
        lock.is_active = False
        held = self._by_resource.get(lock.resource_path, [])
        if lock_id in held:
            held.remove(lock_id)
        self._wait_for.pop(lock.agent_did, None)

    def release_agent_locks(self, agent_did: str, session_id: str) -> int:
        victims = [
            l.lock_id
            for l in self._locks.values()
            if l.is_active and l.agent_did == agent_did and l.session_id == session_id
        ]
        for lid in victims:
            self.release(lid)
        return len(victims)

    def release_session_locks(self, session_id: str) -> int:
        victims = [
            l.lock_id
            for l in self._locks.values()
            if l.is_active and l.session_id == session_id
        ]
        for lid in victims:
            self.release(lid)
        return len(victims)

    def get_agent_locks(self, agent_did: str, session_id: str) -> list[IntentLock]:
        return [
            l
            for l in self._locks.values()
            if l.is_active and l.agent_did == agent_did and l.session_id == session_id
        ]

    def get_resource_locks(self, resource_path: str) -> list[IntentLock]:
        return [
            self._locks[lid]
            for lid in self._by_resource.get(resource_path, [])
            if lid in self._locks and self._locks[lid].is_active
        ]

    def declare_wait(self, agent_did: str, waiting_on: set[str]) -> None:
        """Record that an agent is blocked waiting on others (wait-for edge)."""
        self._wait_for.setdefault(agent_did, set()).update(waiting_on)

    # -- internals -----------------------------------------------------

    def _conflicting_locks(
        self, resource_path: str, agent_did: str, intent: LockIntent
    ) -> list[IntentLock]:
        return [
            l
            for l in self.get_resource_locks(resource_path)
            if l.agent_did != agent_did
            and not COMPAT_MATRIX[l.intent.code, intent.code]
        ]

    def _closes_cycle(self, agent_did: str, blockers: set[str]) -> bool:
        """DFS over the wait-for graph: would agent wait on itself transitively?"""
        seen: set[str] = set()
        stack = list(blockers)
        while stack:
            cur = stack.pop()
            if cur == agent_did:
                return True
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(self._wait_for.get(cur, ()))
        return False

    @property
    def active_lock_count(self) -> int:
        return sum(1 for l in self._locks.values() if l.is_active)

    @property
    def contention_points(self) -> list[str]:
        """Resources where >1 distinct agents currently hold locks."""
        out = []
        for path, lock_ids in self._by_resource.items():
            holders = {
                self._locks[lid].agent_did
                for lid in lock_ids
                if lid in self._locks and self._locks[lid].is_active
            }
            if len(holders) > 1:
                out.append(path)
        return out
