"""Vector clocks as dense int arrays — causal consistency for shared state.

Capability parity with reference `session/vector_clock.py:19-165`
(tick/merge/happens-before/concurrency, per-path + per-agent clocks, strict
writes raising CausalViolationError, conflict counting), re-designed for the
array substrate: a clock is a dense int32 vector indexed by agent slot, and
the manager holds two growable matrices — path clocks [P, A] and agent
clocks [N, A] — so happens-before over a batch of pending writes is two
vectorized comparisons (`ops.clock_ops`) instead of per-dict loops.
"""

from __future__ import annotations

import numpy as np

from hypervisor_tpu_torch.tables.intern import InternTable


class CausalViolationError(Exception):
    """A write would violate causal ordering (agent has stale state)."""


class VectorClock:
    """A causal clock over agent components.

    Internally a dense int32 vector aligned to an agent-slot registry; the
    dict-style API (`clocks`, `get`) is kept for reference-compatibility.
    """

    __slots__ = ("_agents", "_v")

    def __init__(self, agents: InternTable | None = None, v: np.ndarray | None = None):
        self._agents = agents if agents is not None else InternTable()
        self._v = v if v is not None else np.zeros(len(self._agents), np.int32)

    # -- dict-compatible views ----------------------------------------
    @property
    def clocks(self) -> dict[str, int]:
        return {
            self._agents.string(i): int(c)
            for i, c in enumerate(self._v[: len(self._agents)])
            if c > 0
        }

    def get(self, agent_did: str) -> int:
        h = self._agents.lookup(agent_did)
        return 0 if h < 0 or h >= len(self._v) else int(self._v[h])

    # -- mutation ------------------------------------------------------
    def tick(self, agent_did: str) -> None:
        h = self._agents.intern(agent_did)
        self._ensure(h + 1)
        self._v[h] += 1

    def _ensure(self, n: int) -> None:
        if len(self._v) < n:
            grown = np.zeros(max(n, 2 * len(self._v) + 1), np.int32)
            grown[: len(self._v)] = self._v
            self._v = grown

    def _aligned(self, other: "VectorClock") -> tuple[np.ndarray, np.ndarray]:
        """Views of both vectors over a shared component space."""
        if self._agents is other._agents:
            n = max(len(self._v), len(other._v))
            a = np.zeros(n, np.int32)
            b = np.zeros(n, np.int32)
            a[: len(self._v)] = self._v
            b[: len(other._v)] = other._v
            return a, b
        # Different registries: align by agent name.
        names = set(self.clocks) | set(other.clocks)
        a = np.array([self.get(x) for x in names], np.int32)
        b = np.array([other.get(x) for x in names], np.int32)
        return a, b

    # -- causal order --------------------------------------------------
    def merge(self, other: "VectorClock") -> "VectorClock":
        """Component-wise max. Result shares self's agent registry when possible."""
        if self._agents is other._agents:
            a, b = self._aligned(other)
            return VectorClock(self._agents, np.maximum(a, b))
        merged = self.copy()
        for name, c in other.clocks.items():
            h = merged._agents.intern(name)
            merged._ensure(h + 1)
            merged._v[h] = max(merged._v[h], c)
        return merged

    def happens_before(self, other: "VectorClock") -> bool:
        a, b = self._aligned(other)
        return bool(np.all(a <= b) and np.any(a < b))

    def is_concurrent(self, other: "VectorClock") -> bool:
        return not self.happens_before(other) and not other.happens_before(self)

    def copy(self) -> "VectorClock":
        c = VectorClock(self._agents, self._v.copy())
        return c

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, VectorClock):
            return NotImplemented
        a, b = self._aligned(other)
        return bool(np.all(a == b))

    def __repr__(self) -> str:
        return f"VectorClock({self.clocks})"


class VectorClockManager:
    """Per-path and per-agent clocks with strict-write conflict rejection.

    All clocks in one manager share a single agent-slot registry, so every
    comparison is a dense vector op over aligned components.
    """

    def __init__(self) -> None:
        self._agents = InternTable()
        self._paths: dict[str, VectorClock] = {}
        self._agent_clocks: dict[str, VectorClock] = {}
        self._conflicts = 0

    def _blank(self) -> VectorClock:
        return VectorClock(self._agents, np.zeros(len(self._agents), np.int32))

    def read(self, path: str, agent_did: str) -> VectorClock:
        """Record a read: the agent's clock absorbs the path's state."""
        path_clock = self._paths.get(path, self._blank())
        agent_clock = self._agent_clocks.get(agent_did, self._blank())
        self._agent_clocks[agent_did] = agent_clock.merge(path_clock)
        return path_clock.copy()

    def write(self, path: str, agent_did: str, strict: bool = True) -> VectorClock:
        """Record a write; under strict mode reject writers with stale state.

        Raises CausalViolationError when the agent's clock happens-before the
        path's clock (the agent must re-read first).
        """
        path_clock = self._paths.get(path, self._blank())
        agent_clock = self._agent_clocks.get(agent_did, self._blank())

        if strict and path_clock.clocks:
            if agent_clock.happens_before(path_clock):
                self._conflicts += 1
                raise CausalViolationError(
                    f"Agent {agent_did} has stale state for {path}. "
                    f"Agent clock: {agent_clock.clocks}, "
                    f"Path clock: {path_clock.clocks}. "
                    f"Must re-read before writing."
                )

        agent_clock.tick(agent_did)
        new_path_clock = path_clock.merge(agent_clock)
        self._paths[path] = new_path_clock
        self._agent_clocks[agent_did] = agent_clock
        return new_path_clock

    def get_path_clock(self, path: str) -> VectorClock:
        return self._paths.get(path, self._blank()).copy()

    def get_agent_clock(self, agent_did: str) -> VectorClock:
        return self._agent_clocks.get(agent_did, self._blank()).copy()

    @property
    def conflict_count(self) -> int:
        return self._conflicts

    @property
    def tracked_paths(self) -> int:
        return len(self._paths)

    def path_matrix(self) -> tuple[list[str], np.ndarray]:
        """Dense [P, A] snapshot of all path clocks (device-mirror export)."""
        paths = list(self._paths)
        a = len(self._agents)
        m = np.zeros((len(paths), a), np.int32)
        for i, p in enumerate(paths):
            v = self._paths[p]._v
            m[i, : min(a, len(v))] = v[: min(a, len(v))]
        return paths, m
