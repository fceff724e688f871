"""Per-saga isolation levels (capability parity: reference `session/isolation.py:13-59`).

The level decides which consistency machinery engages: vector clocks,
intent locks, and whether concurrent writers are tolerated. In the device
plane the level is an int8 scalar gating which prepasses run in the batched
write path.
"""

from __future__ import annotations

import enum


class IsolationLevel(str, enum.Enum):
    SNAPSHOT = "snapshot"            # read from saga-start snapshot; buffered writes
    READ_COMMITTED = "read_committed"  # reads see latest committed versions
    SERIALIZABLE = "serializable"    # fully ordered; clocks + locks enforced

    @property
    def code(self) -> int:
        return {"snapshot": 0, "read_committed": 1, "serializable": 2}[self.value]

    @property
    def requires_vector_clocks(self) -> bool:
        return self in (IsolationLevel.READ_COMMITTED, IsolationLevel.SERIALIZABLE)

    @property
    def requires_intent_locks(self) -> bool:
        return self is IsolationLevel.SERIALIZABLE

    @property
    def allows_concurrent_writes(self) -> bool:
        return self is not IsolationLevel.SERIALIZABLE

    @property
    def coordination_cost(self) -> str:
        return {0: "low", 1: "moderate", 2: "high"}[self.code]
