"""Batched intent-lock waves: conflict gate -> deadlock sweep -> grant
(`hypervisor_tpu.runtime.lock_wave`).

The runtime caller for `ops.locks`. A wave of lock requests is vetted in
batches on the wave's torch device ("cuda" unless the caller asks for
another):

  * requests against distinct resources vet together in one dense
    conflict pass against the held-lock table,
  * repeated resources inside a wave settle in occurrence order, so the
    intra-wave winner is the earliest submission (sequential semantics),
  * blocked requests settle sequentially through the manager's cycle
    check: one whose blockers can already (transitively) reach it is
    refused DEADLOCK with no wait edge recorded — exactly the
    single-call API's DeadlockError — while contended ones record their
    wait edges for later requests in the same wave to see,
  * survivors are granted into the embedded `IntentLockManager`, so the
    single-call API and the wave API share one lock table.

Request batches and the held-lock snapshot are padded to power-of-two
buckets of at least 8 rows. `deadlock_report()` gives standing-cycle
membership plus a suggested victim (the lowest-sigma agent on a cycle)
for the kill switch to break the deadlock.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from hypervisor_tpu_torch import resolve_device
from hypervisor_tpu_torch.ops import locks as lock_ops
from hypervisor_tpu_torch.session.intent_locks import (
    IntentLock,
    IntentLockManager,
    LockIntent,
)
from hypervisor_tpu_torch.tables.intern import InternTable

# Per-request outcome codes.
LOCK_GRANTED = 0
LOCK_CONTENTION = 1
LOCK_DEADLOCK = 2


@dataclass
class LockReport:
    status: np.ndarray                   # int8[B] LOCK_* per request
    locks: list[Optional[IntentLock]]    # granted lock objects (None if refused)
    blockers: list[set[str]]             # blocking agent DIDs per request


@dataclass
class DeadlockReport:
    on_cycle: list[str]                  # agents on a standing wait cycle
    victim: Optional[str]                # lowest-sigma cycle member


class LockWave:
    """Batched acquire path over a shared IntentLockManager."""

    def __init__(
        self,
        manager: Optional[IntentLockManager] = None,
        max_agents: int = 64,
        max_paths: int = 256,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.manager = manager if manager is not None else IntentLockManager()
        self._agents = InternTable()
        self._paths = InternTable()
        self._max_agents = max_agents
        self._max_paths = max_paths
        self._staged: list[tuple[str, str, str, LockIntent, Optional[str]]] = []
        self._sigma = np.full(max_agents, 0.5, np.float32)

    def observe_sigma(self, agent_did: str, sigma: float) -> None:
        """Record an agent's trust for deadlock victim ranking."""
        row = self._agents.intern(agent_did)
        self._check_capacity()
        self._sigma[row] = sigma

    def submit(
        self,
        agent_did: str,
        session_id: str,
        resource_path: str,
        intent: LockIntent,
        saga_step_id: Optional[str] = None,
    ) -> int:
        """Stage one lock request; returns its wave index."""
        self._staged.append((agent_did, session_id, resource_path, intent, saga_step_id))
        return len(self._staged) - 1

    # ── internals ────────────────────────────────────────────────────

    def _check_capacity(self) -> None:
        if len(self._agents) > self._max_agents:
            raise RuntimeError("agent capacity exceeded; raise max_agents")
        if len(self._paths) > self._max_paths:
            raise RuntimeError("path capacity exceeded; raise max_paths")

    @staticmethod
    def _bucket(n: int) -> int:
        """Pad sizes to power-of-two buckets (at least 8), as the
        reference does for its compiled shapes."""
        return 1 << max(3, (max(n, 1) - 1).bit_length())

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _held_arrays(self):
        """Snapshot the manager's active locks as padded device tensors."""
        held = [lock for lock in self.manager._locks.values() if lock.is_active]
        self._check_capacity()
        cap = self._bucket(len(held))
        path = np.full(cap, -1, np.int32)
        agent = np.full(cap, -1, np.int32)
        intent = np.zeros(cap, np.int8)
        active = np.zeros(cap, bool)
        for row, lock in enumerate(held):
            path[row] = self._paths.intern(lock.resource_path)
            agent[row] = self._agents.intern(lock.agent_did)
            intent[row] = lock.intent.code
            active[row] = True
        self._check_capacity()
        return self._put(path), self._put(agent), self._put(intent), self._put(active)

    def _wait_matrix(self) -> np.ndarray:
        n = self._max_agents
        rows = {
            waiter: (self._agents.intern(waiter), [self._agents.intern(b) for b in blockers])
            for waiter, blockers in self.manager._wait_for.items()
        }
        self._check_capacity()  # before any fixed-size matrix indexing
        wait = np.zeros((n, n), bool)
        for wrow, brows in rows.values():
            wait[wrow, brows] = True
        return wait

    # ── the wave ─────────────────────────────────────────────────────

    def flush(self) -> LockReport:
        """Vet and grant every staged request; returns per-request outcomes."""
        staged, self._staged = self._staged, []
        b = len(staged)
        status = np.zeros(b, np.int8)
        locks: list[Optional[IntentLock]] = [None] * b
        blockers: list[set[str]] = [set() for _ in range(b)]
        if not b:
            return LockReport(status, locks, blockers)

        req_agent = np.array([self._agents.intern(a) for a, *_ in staged], np.int32)
        req_path = np.array([self._paths.intern(p) for _, _, p, _, _ in staged], np.int32)
        req_intent = np.array([i.code for *_, i, _ in staged], np.int8)
        self._check_capacity()

        # Occurrence order: the i-th request for a path vets in batch i.
        occ = np.zeros(b, np.int64)
        seen: dict[int, int] = {}
        for i, p in enumerate(req_path):
            occ[i] = seen.get(int(p), 0)
            seen[int(p)] = int(occ[i]) + 1

        for batch_no in range(int(occ.max()) + 1):
            sel = np.nonzero(occ == batch_no)[0]
            hp, ha, hi, hact = self._held_arrays()
            # Pad the request batch to a bucket; padded rows use a path no
            # held lock can occupy, so they gate clean.
            cap = self._bucket(len(sel))
            bp = np.full(cap, -2, np.int32)
            ba = np.full(cap, -2, np.int32)
            bi = np.zeros(cap, np.int8)
            bp[: len(sel)] = req_path[sel]
            ba[: len(sel)] = req_agent[sel]
            bi[: len(sel)] = req_intent[sel]
            gate = lock_ops.conflict_gate(hp, ha, hi, hact, self._put(bp), self._put(ba),
                                          self._put(bi), n_agents=self._max_agents)
            blocked = gate.blocked.cpu().numpy()[: len(sel)]
            blocker_rows = gate.blockers.cpu().numpy()[: len(sel)]

            # Grants are conflict-free by the dense gate. The blocked
            # subset settles sequentially through the manager's own cycle
            # check, in submission order: a refused request's wait edges
            # are visible to the next one exactly as in the single-call
            # API, so a cross-path deadlock forming inside one batch is
            # refused, not silently recorded.
            for k, i in enumerate(sel):
                agent, session, path, intent, step = staged[i]
                if not blocked[k]:
                    locks[i] = self.manager.acquire(agent, session, path, intent,
                                                    saga_step_id=step)
                    continue
                names = {
                    self._agents.string(int(r))
                    for r in np.nonzero(blocker_rows[k])[0]
                    if r < len(self._agents)
                }
                blockers[i] = names
                if self.manager._closes_cycle(agent, names):
                    # Refused outright; no wait edge is recorded (the
                    # single-call API raises DeadlockError without waiting).
                    status[i] = LOCK_DEADLOCK
                else:
                    status[i] = LOCK_CONTENTION
                    # The refused requester now waits on its blockers.
                    self.manager.declare_wait(agent, names)

        return LockReport(status=status, locks=locks, blockers=blockers)

    # ── standing-state sweeps ────────────────────────────────────────

    def deadlock_report(self) -> DeadlockReport:
        """Who is on a wait cycle right now, and whom to kill to break it."""
        sweep = lock_ops.deadlock_sweep(
            self._put(self._wait_matrix()),
            torch.zeros((1,), dtype=torch.int32, device=self.device),
            torch.zeros((1, self._max_agents), dtype=torch.bool, device=self.device),
            self._put(self._sigma),
        )
        on = np.nonzero(sweep.on_cycle.cpu().numpy())[0]
        victim_row = int(sweep.victim)
        members = [self._agents.string(int(r)) for r in on if r < len(self._agents)]
        victim = (self._agents.string(victim_row)
                  if 0 <= victim_row < len(self._agents) else None)
        return DeadlockReport(on_cycle=members, victim=victim)

    def contention_counts(self) -> dict[str, int]:
        """Distinct-holder counts per resource (>1 = contention point)."""
        hp, ha, _hi, hact = self._held_arrays()
        counts = lock_ops.contention_counts(hp, ha, hact, n_paths=self._max_paths,
                                            n_agents=self._max_agents).cpu().numpy()
        return {
            self._paths.string(p): int(c)
            for p, c in enumerate(counts[: len(self._paths)])
            if c > 0
        }
