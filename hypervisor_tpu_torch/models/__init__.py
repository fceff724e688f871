"""Core data models: enums, session config, participants, action descriptors.

API-parity layer with the reference's `models.py:12-132`, re-designed for an
array-native runtime: every enum doubles as a compact integer code usable as a
column dtype in the HBM-resident tables (int8), and the threshold logic is
mirrored by vectorized ops in `hypervisor_tpu_torch.ops.rings`.
"""

from __future__ import annotations

import enum
import uuid
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Optional

from hypervisor_tpu_torch.config import DEFAULT_CONFIG

__all__ = [
    "ConsistencyMode",
    "ExecutionRing",
    "ReversibilityLevel",
    "SessionState",
    "SessionConfig",
    "SessionParticipant",
    "ActionDescriptor",
]


class ConsistencyMode(str, enum.Enum):
    """Session consistency mode (reference `models.py:12-16`).

    STRONG maps to a cross-chip consensus barrier (psum over ICI) in the
    device plane; EVENTUAL maps to local updates reconciled between batches.
    """

    STRONG = "strong"
    EVENTUAL = "eventual"

    @property
    def code(self) -> int:
        """int8 column code for the session table."""
        return 0 if self is ConsistencyMode.STRONG else 1

    @classmethod
    def from_code(cls, code: int) -> "ConsistencyMode":
        return cls.STRONG if code == 0 else cls.EVENTUAL


class ExecutionRing(enum.IntEnum):
    """Hardware-inspired privilege rings 0-3 (reference `models.py:19-42`).

    Lower number = more privileged. Stored as int8 in the agent table; the
    batched threshold derivation lives in `ops.rings.compute_rings`.
    """

    RING_0_ROOT = 0        # hypervisor config & slashing; needs SRE witness
    RING_1_PRIVILEGED = 1  # non-reversible actions; sigma_eff > 0.95 + consensus
    RING_2_STANDARD = 2    # reversible actions; sigma_eff > 0.60
    RING_3_SANDBOX = 3     # read-only / unknown agents

    @classmethod
    def from_sigma_eff(
        cls, sigma_eff: float, has_consensus: bool = False
    ) -> "ExecutionRing":
        """Scalar ring derivation (thresholds per reference `models.py:34-42`)."""
        t = DEFAULT_CONFIG.trust
        if sigma_eff > t.ring1_threshold and has_consensus:
            return cls.RING_1_PRIVILEGED
        if sigma_eff > t.ring2_threshold:
            return cls.RING_2_STANDARD
        return cls.RING_3_SANDBOX


class ReversibilityLevel(str, enum.Enum):
    """Action reversibility with risk-weight ranges (reference `models.py:45-66`)."""

    FULL = "full"
    PARTIAL = "partial"
    NONE = "none"

    @property
    def code(self) -> int:
        return _REVERSIBILITY_CODES[self]

    @property
    def risk_weight_range(self) -> tuple[float, float]:
        return _RISK_RANGES[self]

    @property
    def default_risk_weight(self) -> float:
        lo, hi = _RISK_RANGES[self]
        return (lo + hi) / 2.0


_REVERSIBILITY_CODES = {
    ReversibilityLevel.FULL: 0,
    ReversibilityLevel.PARTIAL: 1,
    ReversibilityLevel.NONE: 2,
}
_RISK_RANGES = {
    ReversibilityLevel.FULL: (0.1, 0.3),
    ReversibilityLevel.PARTIAL: (0.5, 0.8),
    ReversibilityLevel.NONE: (0.9, 1.0),
}
# Default risk weights by reversibility code, importable by device ops.
RISK_WEIGHT_DEFAULTS = tuple(
    (lo + hi) / 2.0 for lo, hi in (_RISK_RANGES[r] for r in _REVERSIBILITY_CODES)
)


class SessionState(str, enum.Enum):
    """Session lifecycle FSM (reference `models.py:69-76`).

    Codes are ordered so the FSM's forward progression is monotone in the
    int8 session-state column.
    """

    CREATED = "created"
    HANDSHAKING = "handshaking"
    ACTIVE = "active"
    TERMINATING = "terminating"
    ARCHIVED = "archived"

    @property
    def code(self) -> int:
        return _SESSION_STATE_CODES[self]

    @classmethod
    def from_code(cls, code: int) -> "SessionState":
        return _SESSION_STATES_BY_CODE[code]


_SESSION_STATE_CODES = {s: i for i, s in enumerate(SessionState)}
_SESSION_STATES_BY_CODE = {i: s for s, i in _SESSION_STATE_CODES.items()}


@dataclass
class SessionConfig:
    """Per-session configuration (reference `models.py:79-88`)."""

    consistency_mode: ConsistencyMode = ConsistencyMode.EVENTUAL
    max_participants: int = 10
    max_duration_seconds: int = 3600
    min_sigma_eff: float = 0.60
    enable_audit: bool = True
    enable_blockchain_commitment: bool = False


@dataclass
class SessionParticipant:
    """An agent inside a session (reference `models.py:91-101`).

    Host-side view of one row of the agent table.
    """

    agent_did: str
    ring: ExecutionRing = ExecutionRing.RING_3_SANDBOX
    sigma_raw: float = 0.0
    sigma_eff: float = 0.0
    joined_at: datetime = field(default_factory=lambda: datetime.now(timezone.utc))
    is_active: bool = True


@dataclass
class ActionDescriptor:
    """An action from an IATP capability manifest (reference `models.py:103-132`)."""

    action_id: str
    name: str
    execute_api: str
    undo_api: Optional[str] = None
    reversibility: ReversibilityLevel = ReversibilityLevel.NONE
    undo_window_seconds: int = 0
    compensation_method: Optional[str] = None
    is_read_only: bool = False
    is_admin: bool = False

    def __post_init__(self) -> None:
        # API callers ship the enum's VALUE ("none"/"partial"/"full");
        # required_ring gates with identity checks, so a raw string
        # would silently demote an irreversible action's required ring
        # from 1 to 2 — coerce here, once, for every construction path
        # (gateway, /rings/check, join manifests).
        if not isinstance(self.reversibility, ReversibilityLevel):
            self.reversibility = ReversibilityLevel(self.reversibility)

    @property
    def risk_weight(self) -> float:
        """omega, derived from the reversibility level's default."""
        return self.reversibility.default_risk_weight

    @property
    def required_ring(self) -> ExecutionRing:
        """Minimum ring for this action (derivation per reference `models.py:122-132`)."""
        if self.is_admin:
            return ExecutionRing.RING_0_ROOT
        if self.reversibility is ReversibilityLevel.NONE and not self.is_read_only:
            return ExecutionRing.RING_1_PRIVILEGED
        if self.is_read_only:
            return ExecutionRing.RING_3_SANDBOX
        return ExecutionRing.RING_2_STANDARD


def new_id(prefix: str) -> str:
    """Generate a namespaced unique id, e.g. ``session:<uuid4>``."""
    return f"{prefix}:{uuid.uuid4()}"
