"""Semantic checkpoints: record achieved goals, skip them on replay.

Capability parity with reference `saga/checkpoint.py:39-163`: goal-hash
keyed dedup (sha256(goal:step)[:16]), is_achieved skip checks, per-step
invalidation, replay plans listing steps without valid checkpoints.
"""

from __future__ import annotations

import hashlib
import uuid
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Optional

from hypervisor_tpu_torch.utils.clock import utc_now


@dataclass
class SemanticCheckpoint:
    """One achieved-goal record."""

    checkpoint_id: str = field(default_factory=lambda: f"ckpt:{uuid.uuid4().hex[:8]}")
    saga_id: str = ""
    step_id: str = ""
    goal_description: str = ""
    goal_hash: str = ""
    achieved_at: datetime = field(default_factory=utc_now)
    state_snapshot: dict[str, Any] = field(default_factory=dict)
    is_valid: bool = True
    invalidated_reason: Optional[str] = None

    @staticmethod
    def compute_goal_hash(goal: str, step_id: str) -> str:
        return hashlib.sha256(f"{goal}:{step_id}".encode()).hexdigest()[:16]


class CheckpointManager:
    """Goal-hash-indexed checkpoint store for partial saga replay."""

    def __init__(self) -> None:
        self._by_saga: dict[str, list[SemanticCheckpoint]] = {}
        self._by_hash: dict[str, SemanticCheckpoint] = {}

    def save(
        self,
        saga_id: str,
        step_id: str,
        goal_description: str,
        state_snapshot: Optional[dict] = None,
    ) -> SemanticCheckpoint:
        ckpt = SemanticCheckpoint(
            saga_id=saga_id,
            step_id=step_id,
            goal_description=goal_description,
            goal_hash=SemanticCheckpoint.compute_goal_hash(goal_description, step_id),
            state_snapshot=state_snapshot or {},
        )
        self._by_saga.setdefault(saga_id, []).append(ckpt)
        self._by_hash[ckpt.goal_hash] = ckpt
        return ckpt

    def is_achieved(self, saga_id: str, goal_description: str, step_id: str) -> bool:
        return self.get_checkpoint(saga_id, goal_description, step_id) is not None

    def get_checkpoint(
        self, saga_id: str, goal_description: str, step_id: str
    ) -> Optional[SemanticCheckpoint]:
        h = SemanticCheckpoint.compute_goal_hash(goal_description, step_id)
        ckpt = self._by_hash.get(h)
        if ckpt is not None and ckpt.saga_id == saga_id and ckpt.is_valid:
            return ckpt
        return None

    def invalidate(self, saga_id: str, step_id: str, reason: str = "") -> int:
        """Invalidate all of a step's checkpoints; returns the count."""
        count = 0
        for ckpt in self._by_saga.get(saga_id, ()):
            if ckpt.step_id == step_id and ckpt.is_valid:
                ckpt.is_valid = False
                ckpt.invalidated_reason = reason
                count += 1
        return count

    def get_saga_checkpoints(self, saga_id: str) -> list[SemanticCheckpoint]:
        return [c for c in self._by_saga.get(saga_id, ()) if c.is_valid]

    def get_replay_plan(self, saga_id: str, steps: list[str]) -> list[str]:
        """Steps that still need execution (no valid checkpoint)."""
        achieved = {c.step_id for c in self.get_saga_checkpoints(saga_id)}
        return [s for s in steps if s not in achieved]

    @property
    def total_checkpoints(self) -> int:
        return sum(len(v) for v in self._by_saga.values())

    @property
    def valid_checkpoints(self) -> int:
        return sum(1 for v in self._by_saga.values() for c in v if c.is_valid)
