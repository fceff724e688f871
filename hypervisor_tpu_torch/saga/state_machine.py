"""Saga state machines (`hypervisor_tpu.saga.state_machine`, copied).

Seven step states and five saga states, each machine declared once as
an edge spec and compiled into a boolean validity matrix
(`STEP_TRANSITION_MATRIX` u8[7, 7], `SAGA_TRANSITION_MATRIX` u8[5, 5]).
`ops.saga_ops` packs the matrices into bit words for whole-table tests;
the host classes below index them directly, so host and device agree on
legality. Declaration order is each state's device code.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, fields
from datetime import datetime, timezone
from typing import Any, Optional

import numpy as np


def utc_now() -> datetime:
    return datetime.now(timezone.utc)


class SagaStateError(Exception):
    """Invalid saga/step state transition."""


class _CodedState(str, enum.Enum):
    """str-valued state whose definition order is its device int code."""

    @property
    def code(self) -> int:
        # Keyed by (class, name): members of different enums with one
        # string value compare equal as strings.
        return _CODE_OF[type(self), self.name]


class StepState(_CodedState):
    PENDING = "pending"
    EXECUTING = "executing"
    COMMITTED = "committed"
    COMPENSATING = "compensating"
    COMPENSATED = "compensated"
    COMPENSATION_FAILED = "compensation_failed"
    FAILED = "failed"


class SagaState(_CodedState):
    RUNNING = "running"
    COMPENSATING = "compensating"
    COMPLETED = "completed"
    FAILED = "failed"
    ESCALATED = "escalated"


_CODE_OF: dict[tuple[type, str], int] = {
    (cls, member.name): i
    for cls in (StepState, SagaState)
    for i, member in enumerate(cls)
}


def _compile_edges(cls: type[_CodedState], edge_spec: str) -> np.ndarray:
    """Compile ``"a -> b c"`` edge lines into a validity matrix. Anything
    not listed is illegal."""
    matrix = np.zeros((len(cls), len(cls)), np.uint8)
    for line in edge_spec.strip().splitlines():
        src, _, dsts = line.partition("->")
        for dst in dsts.split():
            matrix[cls(src.strip()).code, cls(dst).code] = 1
    return matrix


# Forward path on top, compensation path below. Terminal states have no
# outgoing edges except COMMITTED, which may still be rolled back.
STEP_TRANSITION_MATRIX = _compile_edges(
    StepState,
    """
    pending      -> executing
    executing    -> committed failed
    committed    -> compensating
    compensating -> compensated compensation_failed
    """,
)

SAGA_TRANSITION_MATRIX = _compile_edges(
    SagaState,
    """
    running      -> compensating completed failed
    compensating -> completed failed escalated
    """,
)

# States whose entry stamps `completed_at`.
_STEP_DONE_STAMP = frozenset(
    (StepState.COMMITTED, StepState.COMPENSATED,
     StepState.COMPENSATION_FAILED, StepState.FAILED)
)
_SAGA_DONE_STAMP = frozenset(
    (SagaState.COMPLETED, SagaState.FAILED, SagaState.ESCALATED)
)


def _checked_move(holder: Any, matrix: np.ndarray, target: _CodedState,
                  kind: str) -> None:
    """Shared transition guard: one matrix lookup, rich error on refusal."""
    current = holder.state
    if not matrix[current.code, target.code]:
        legal = [m.value for m in type(target) if matrix[current.code, m.code]]
        raise SagaStateError(
            f"Invalid {kind} transition: {current.value} → {target.value}. "
            f"Allowed: {legal}"
        )
    holder.state = target


def _wire(value: Any) -> Any:
    """Project one attribute to its wire form for `to_dict`."""
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, datetime):
        return value.isoformat()
    return value


@dataclass
class SagaStep:
    """One step of a saga: the constructor takes its definition; what the
    runtime mutates is initialised by the dataclass machinery."""

    step_id: str
    action_id: str
    agent_did: str
    execute_api: str
    undo_api: Optional[str] = None
    timeout_seconds: int = 300
    max_retries: int = 0

    state: StepState = field(default=StepState.PENDING, init=False)
    execute_result: Optional[Any] = field(default=None, init=False)
    compensation_result: Optional[Any] = field(default=None, init=False)
    error: Optional[str] = field(default=None, init=False)
    started_at: Optional[datetime] = field(default=None, init=False)
    completed_at: Optional[datetime] = field(default=None, init=False)
    retry_count: int = field(default=0, init=False)

    def transition(self, new_state: StepState) -> None:
        _checked_move(self, STEP_TRANSITION_MATRIX, new_state, "step")
        if new_state is StepState.EXECUTING:
            self.started_at = utc_now()
        elif new_state in _STEP_DONE_STAMP:
            self.completed_at = utc_now()


# Wire projection of a step inside a persisted saga.
_STEP_WIRE_FIELDS = ("step_id", "action_id", "agent_did", "state", "error")


@dataclass
class Saga:
    """An ordered multi-step transaction with compensation semantics."""

    saga_id: str
    session_id: str
    steps: list[SagaStep] = field(default_factory=list)
    state: SagaState = SagaState.RUNNING
    created_at: datetime = field(default_factory=utc_now)
    completed_at: Optional[datetime] = None
    error: Optional[str] = None

    def transition(self, new_state: SagaState) -> None:
        _checked_move(self, SAGA_TRANSITION_MATRIX, new_state, "saga")
        if new_state in _SAGA_DONE_STAMP:
            self.completed_at = utc_now()

    @property
    def committed_steps(self) -> list[SagaStep]:
        return [s for s in self.steps if s.state is StepState.COMMITTED]

    @property
    def committed_steps_reversed(self) -> list[SagaStep]:
        """Rollback order: last committed first."""
        return self.committed_steps[::-1]

    def to_dict(self) -> dict:
        """Serialize for persistence: every non-step field plus a wire
        projection of each step."""
        out = {
            f.name: _wire(getattr(self, f.name))
            for f in fields(self)
            if f.name != "steps"
        }
        out["steps"] = [
            {k: _wire(getattr(s, k)) for k in _STEP_WIRE_FIELDS}
            for s in self.steps
        ]
        return out

    @classmethod
    def from_dict(cls, data: dict) -> "Saga":
        """Rehydrate a persisted saga."""
        saga = cls(saga_id=data["saga_id"], session_id=data["session_id"])
        saga.state = SagaState(data["state"])
        saga.error = data.get("error")
        for s in data.get("steps", ()):
            step = SagaStep(
                step_id=s["step_id"],
                action_id=s["action_id"],
                agent_did=s["agent_did"],
                execute_api=s.get("execute_api", ""),
                undo_api=s.get("undo_api"),
            )
            step.state = StepState(s["state"])
            step.error = s.get("error")
            saga.steps.append(step)
        return saga
