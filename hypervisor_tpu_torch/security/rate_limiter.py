"""Per-agent per-ring token-bucket rate limiting, array-native.

Capability parity with reference `security/rate_limiter.py:72-176`:
per-ring defaults (Ring0 100rps/200 burst ... Ring3 5/10), raising
`check` plus boolean `try_check`, bucket recreated full on ring change,
per-agent stats.

Unlike the reference (one TokenBucket object per key), ALL buckets here
live in parallel numpy columns — tokens, refill stamp, ring, request and
rejection counters — indexed by interning the (agent, session) pair.
Refill-then-consume is the same branch-free arithmetic as the device op
(`ops.rate_limit.consume`), applied to one row for the scalar API or to
a whole row batch via `check_many`, so host and device decisions agree
bit-for-bit. The scalar `TokenBucket` remains as the standalone twin for
callers that want an unkeyed bucket.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime
from typing import Optional, Sequence

import numpy as np

from hypervisor_tpu_torch.config import DEFAULT_CONFIG
from hypervisor_tpu_torch.models import ExecutionRing
from hypervisor_tpu_torch.tables.intern import ColumnStore
from hypervisor_tpu_torch.utils.clock import Clock, utc_now


class RateLimitExceeded(Exception):
    """An agent exceeded its ring's request budget."""


_cfg = DEFAULT_CONFIG.rate_limit
DEFAULT_RING_LIMITS: dict[ExecutionRing, tuple[float, float]] = {
    ring: (_cfg.ring_rates[ring.value], _cfg.ring_bursts[ring.value])
    for ring in ExecutionRing
}
_FALLBACK_LIMIT = (20.0, 40.0)


@dataclass
class TokenBucket:
    """Scalar token bucket (standalone twin of one limiter row)."""

    capacity: float
    tokens: float
    refill_rate: float
    last_refill: datetime = field(default_factory=utc_now)
    _clock: Clock = utc_now

    def consume(self, tokens: float = 1.0) -> bool:
        self._refill()
        if self.tokens >= tokens:
            self.tokens -= tokens
            return True
        return False

    def _refill(self) -> None:
        now = self._clock()
        elapsed = (now - self.last_refill).total_seconds()
        self.tokens = min(self.capacity, self.tokens + elapsed * self.refill_rate)
        self.last_refill = now

    @property
    def available(self) -> float:
        self._refill()
        return self.tokens


@dataclass
class RateLimitStats:
    agent_did: str
    ring: ExecutionRing
    total_requests: int = 0
    rejected_requests: int = 0
    tokens_available: float = 0.0
    capacity: float = 0.0


class AgentRateLimiter:
    """All (agent, session) buckets as parallel columns over interned rows."""

    def __init__(
        self,
        ring_limits: Optional[dict[ExecutionRing, tuple[float, float]]] = None,
        clock: Clock = utc_now,
    ) -> None:
        limits = ring_limits or DEFAULT_RING_LIMITS
        # Ring-indexed parameter vectors (the device op's rates/bursts).
        self._rates = np.array(
            [limits.get(ExecutionRing(r), _FALLBACK_LIMIT)[0] for r in range(4)],
            np.float64,
        )
        self._bursts = np.array(
            [limits.get(ExecutionRing(r), _FALLBACK_LIMIT)[1] for r in range(4)],
            np.float64,
        )
        self._clock = clock
        self._epoch = clock()
        self._t = ColumnStore(
            grow=64,
            tokens=np.float64,
            stamp=np.float64,
            ring=np.int8,
            total=np.int64,
            rejected=np.int64,
        )

    # ── scalar API ──────────────────────────────────────────────────────

    def check(
        self,
        agent_did: str,
        session_id: str,
        ring: ExecutionRing,
        cost: float = 1.0,
    ) -> bool:
        """Consume or raise RateLimitExceeded."""
        row = self._row(agent_did, session_id, ring)
        allowed = self._decide(np.array([row]), cost)[0]
        if not allowed:
            raise RateLimitExceeded(
                f"Agent {agent_did} exceeded rate limit for ring "
                f"{int(self._t.ring[row])} "
                f"({int(self._t.rejected[row])} rejections)"
            )
        return True

    def try_check(
        self,
        agent_did: str,
        session_id: str,
        ring: ExecutionRing,
        cost: float = 1.0,
    ) -> bool:
        """Non-raising variant."""
        row = self._row(agent_did, session_id, ring)
        return bool(self._decide(np.array([row]), cost)[0])

    # ── batch API (admission/step waves) ────────────────────────────────

    def check_many(
        self,
        agent_dids: Sequence[str],
        session_ids: Sequence[str],
        rings: Sequence[ExecutionRing],
        cost: float = 1.0,
    ) -> np.ndarray:
        """Decide a whole wave at once; returns bool[N] (no exceptions)."""
        rows = np.array(
            [
                self._row(a, s, r)
                for a, s, r in zip(agent_dids, session_ids, rings)
            ],
            np.int64,
        )
        if len(np.unique(rows)) == len(rows):
            return self._decide(rows, cost)
        # Duplicate keys in one wave must settle sequentially so each
        # request sees the balance its predecessors left behind.
        return np.array(
            [self._decide(rows[i : i + 1], cost)[0] for i in range(len(rows))]
        )

    # ── ring changes & stats ────────────────────────────────────────────

    def update_ring(
        self, agent_did: str, session_id: str, new_ring: ExecutionRing
    ) -> None:
        """Ring change: bucket recreated at full burst for the new ring."""
        row = self._row(agent_did, session_id, new_ring)
        self._t.ring[row] = new_ring.value
        self._t.tokens[row] = self._bursts[new_ring.value]
        self._t.stamp[row] = self._now()

    def get_stats(self, agent_did: str, session_id: str) -> Optional[RateLimitStats]:
        row = self._t.lookup(f"{agent_did}\x00{session_id}")
        if row < 0:
            return None
        self._refill(np.array([row]))
        ring = ExecutionRing(int(self._t.ring[row]))
        return RateLimitStats(
            agent_did=agent_did,
            ring=ring,
            total_requests=int(self._t.total[row]),
            rejected_requests=int(self._t.rejected[row]),
            tokens_available=float(self._t.tokens[row]),
            capacity=float(self._bursts[ring.value]),
        )

    @property
    def tracked_agents(self) -> int:
        return len(self._t)

    # ── column mechanics ────────────────────────────────────────────────

    def _now(self) -> float:
        return (self._clock() - self._epoch).total_seconds()

    def _row(self, agent_did: str, session_id: str, ring: ExecutionRing) -> int:
        row, is_new = self._t.row_for(f"{agent_did}\x00{session_id}")
        if is_new:
            # A fresh bucket starts at full burst for its ring.
            self._t.ring[row] = ring.value
            self._t.tokens[row] = self._bursts[ring.value]
            self._t.stamp[row] = self._now()
        return row

    def _refill(self, rows: np.ndarray) -> None:
        now = self._now()
        ring = np.clip(self._t.ring[rows].astype(np.int64), 0, 3)
        elapsed = np.maximum(now - self._t.stamp[rows], 0.0)
        self._t.tokens[rows] = np.minimum(
            self._bursts[ring], self._t.tokens[rows] + elapsed * self._rates[ring]
        )
        self._t.stamp[rows] = now

    def _decide(self, rows: np.ndarray, cost: float) -> np.ndarray:
        """Refill-then-consume over a row batch (ops.rate_limit.consume twin)."""
        self._refill(rows)
        allowed = self._t.tokens[rows] >= cost
        self._t.tokens[rows] = np.where(
            allowed, self._t.tokens[rows] - cost, self._t.tokens[rows]
        )
        np.add.at(self._t.total, rows, 1)
        np.add.at(self._t.rejected, rows, (~allowed).astype(np.int64))
        return allowed
