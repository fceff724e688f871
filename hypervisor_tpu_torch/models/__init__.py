"""Session enums and config: the codes and fields `create_sessions_batch`
and the wave read, copied from `hypervisor_tpu.models` (same values)."""

from __future__ import annotations

import enum
from dataclasses import dataclass


class ConsistencyMode(str, enum.Enum):
    """Session consistency mode; `code` is the session-table column value."""

    STRONG = "strong"
    EVENTUAL = "eventual"

    @property
    def code(self) -> int:
        return 0 if self is ConsistencyMode.STRONG else 1


class SessionState(str, enum.Enum):
    """Session lifecycle FSM; codes are declaration order (0..4)."""

    CREATED = "created"
    HANDSHAKING = "handshaking"
    ACTIVE = "active"
    TERMINATING = "terminating"
    ARCHIVED = "archived"

    @property
    def code(self) -> int:
        return _SESSION_STATE_CODES[self]


_SESSION_STATE_CODES = {s: i for i, s in enumerate(SessionState)}


@dataclass
class SessionConfig:
    """Per-session configuration."""

    consistency_mode: ConsistencyMode = ConsistencyMode.EVENTUAL
    max_participants: int = 10
    max_duration_seconds: int = 3600
    min_sigma_eff: float = 0.60
    enable_audit: bool = True
