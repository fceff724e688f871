"""Batched VFS write waves: rate limit -> causal prepass -> apply
(`hypervisor_tpu.runtime.write_wave`).

The host engines guard each write with a per-call token bucket
(`security/rate_limiter.py`) and a per-path vector-clock check
(`session/vector_clock.py`); here a whole wave of writes clears both
gates as tensor ops on the wave's device ("cuda" unless the caller asks
for another) before one host pass applies the survivors to the
SessionVFS:

  1. `ops.rate_limit.consume` refills and spends every writer's bucket
     at once (per-ring rates and bursts),
  2. `ops.clock_ops.batched_write_prepass` validates the wave against
     the [paths x writers] clock matrix — stale writers are rejected
     with CONFLICT, admitted writers tick and join clocks.

The clock matrices and the token columns live on the device. Repeated
writers or paths inside one wave settle in occurrence order: the i-th
write to a path (or by a writer) lands in gate batch i, so ordering
matches sequential submission while each batch stays one tensor op.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from hypervisor_tpu_torch import resolve_device
from hypervisor_tpu_torch.config import DEFAULT_CONFIG, RateLimitConfig
from hypervisor_tpu_torch.ops import clock_ops, rate_limit
from hypervisor_tpu_torch.session.vfs import SessionVFS
from hypervisor_tpu_torch.tables.intern import InternTable

# Per-write outcome codes.
WRITE_OK = 0
WRITE_RATE_LIMITED = 1
WRITE_CONFLICT = 2
WRITE_QUARANTINED = 3
WRITE_LOCK_REQUIRED = 4


def _occurrence_order(rows: np.ndarray) -> np.ndarray:
    """occ[i] = how many earlier wave elements share rows[i]."""
    occ = np.zeros(len(rows), np.int64)
    seen: dict[int, int] = {}
    for i, r in enumerate(rows):
        occ[i] = seen.get(int(r), 0)
        seen[int(r)] = int(occ[i]) + 1
    return occ


@dataclass
class WriteReport:
    status: np.ndarray      # int8[W] WRITE_* per submitted write
    applied: int
    rate_limited: int
    conflicts: int
    quarantined: int = 0
    lock_required: int = 0


class WriteWave:
    """Session-scoped batched write path over a SessionVFS."""

    def __init__(
        self,
        vfs: SessionVFS,
        max_paths: int = 256,
        max_writers: int = 64,
        rate_config: RateLimitConfig = DEFAULT_CONFIG.rate_limit,
        strict: bool = True,
        is_quarantined: Optional[Callable[[str], bool]] = None,
        isolation=None,
        lock_manager=None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.vfs = vfs
        self.strict = strict
        # Optional read-only-isolation predicate (did -> bool); quarantined
        # writers are refused before any gate runs.
        self.is_quarantined = is_quarantined
        # The isolation level decides which gates engage
        # (`session/isolation.py` flags):
        #   SNAPSHOT        — no causal prepass (buffered-write semantics),
        #   READ_COMMITTED  — causal prepass (the default `strict` path),
        #   SERIALIZABLE    — causal prepass AND the writer must hold a
        #                     write-capable intent lock on the path
        #                     (supply `lock_manager`).
        self.isolation = isolation
        self.lock_manager = lock_manager
        if isolation is not None:
            self._clock_gate = isolation.requires_vector_clocks
            self._lock_gate = isolation.requires_intent_locks
        else:
            self._clock_gate = True
            self._lock_gate = False
        if self._lock_gate and lock_manager is None:
            raise ValueError("SERIALIZABLE isolation needs a lock_manager to verify write locks")
        self._rate_config = rate_config
        self._paths = InternTable()
        self._writers = InternTable()
        dev = self.device
        self._path_clocks = torch.zeros((max_paths, max_writers), dtype=torch.int32, device=dev)
        self._agent_clocks = torch.zeros((max_writers, max_writers), dtype=torch.int32, device=dev)
        self._rl_tokens = torch.zeros((max_writers,), dtype=torch.float32, device=dev)
        self._rl_stamp = torch.zeros((max_writers,), dtype=torch.float32, device=dev)
        self._rl_ring = np.full(max_writers, 3, np.int8)
        self._rl_primed = np.zeros(max_writers, bool)
        self._staged: list[tuple[str, str, str, int]] = []  # did, path, content, ring

    def submit(self, agent_did: str, path: str, content: str, ring: int = 3) -> int:
        """Stage one write; returns its wave index."""
        self._staged.append((agent_did, path, content, ring))
        return len(self._staged) - 1

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def flush(self, now: float) -> WriteReport:
        """Gate and apply every staged write; returns per-write outcomes.

        On a capacity error the wave stays staged so the caller can
        retry against a larger WriteWave without losing writes.
        """
        staged = self._staged
        if not staged:
            return WriteReport(np.zeros(0, np.int8), 0, 0, 0)

        w = len(staged)
        writer_rows = np.array([self._writers.intern(did) for did, *_ in staged], np.int32)
        path_rows = np.array([self._paths.intern(path) for _, path, *_ in staged], np.int32)
        if len(self._writers) > self._agent_clocks.shape[0]:
            raise RuntimeError("writer capacity exceeded; raise max_writers")
        if len(self._paths) > self._path_clocks.shape[0]:
            raise RuntimeError("path capacity exceeded; raise max_paths")
        self._staged = []
        status = np.zeros(w, np.int8)

        # ── gate 0: read-only isolation ────────────────────────────────
        if self.is_quarantined is not None:
            held = {did: bool(self.is_quarantined(did)) for did in {s[0] for s in staged}}
            for i, (did, *_rest) in enumerate(staged):
                if held[did]:
                    status[i] = WRITE_QUARANTINED

        # ── gate 0b: SERIALIZABLE writers must hold a write lock ───────
        if self._lock_gate:
            from hypervisor_tpu_torch.session.intent_locks import LockIntent

            writable = (LockIntent.WRITE, LockIntent.EXCLUSIVE)
            for i, (did, path, *_rest) in enumerate(staged):
                if status[i] != WRITE_OK:
                    continue
                # Locks are session-scoped: one held in another session
                # must not satisfy this session's serializability gate.
                holds = any(
                    lock.agent_did == did
                    and lock.intent in writable
                    and lock.session_id == self.vfs.session_id
                    for lock in self.lock_manager.get_resource_locks(path)
                )
                if not holds:
                    status[i] = WRITE_LOCK_REQUIRED

        # ── gate 1: token buckets, one consume per writer occurrence ───
        for row, (_, _, _, ring) in zip(writer_rows, staged):
            if not self._rl_primed[row] or self._rl_ring[row] != ring:
                # A fresh bucket, or a ring change, which recreates the
                # bucket at the new ring's full burst.
                self._rl_primed[row] = True
                self._rl_ring[row] = ring
                self._rl_tokens[int(row)] = float(self._rate_config.ring_bursts[ring])
                self._rl_stamp[int(row)] = now
        n_rows = self._rl_tokens.shape[0]
        writer_occ = _occurrence_order(writer_rows)
        for batch_no in range(int(writer_occ.max()) + 1):
            # Quarantined writers never reach the buckets (no token burn).
            sel = np.nonzero((writer_occ == batch_no) & (status == WRITE_OK))[0]
            if not len(sel):
                continue
            cost = np.zeros(n_rows, np.float32)
            cost[writer_rows[sel]] = 1.0
            decision = rate_limit.consume(
                self._rl_tokens, self._rl_stamp, self._put(self._rl_ring), now,
                self._put(cost), config=self._rate_config,
            )
            self._rl_tokens = decision.tokens
            self._rl_stamp = decision.stamp
            denied = ~decision.allowed.cpu().numpy()[writer_rows[sel]]
            status[sel[denied]] = WRITE_RATE_LIMITED

        # ── gate 2: causal prepass, same-path writes in order ──────────
        # A prepass batch needs distinct paths (the op's contract) and
        # distinct writers (duplicate scatter rows would drop clock
        # ticks): greedy per-resource scheduling preserves order.
        # SNAPSHOT isolation skips the gate (and its scheduling) whole.
        if self._clock_gate:
            path_occ = np.zeros(w, np.int64)
            busy_until: dict[tuple[str, int], int] = {}
            for i in range(w):
                b = max(busy_until.get(("p", int(path_rows[i])), 0),
                        busy_until.get(("w", int(writer_rows[i])), 0))
                path_occ[i] = b
                busy_until[("p", int(path_rows[i]))] = b + 1
                busy_until[("w", int(writer_rows[i]))] = b + 1
            for batch_no in range(int(path_occ.max()) + 1):
                sel = np.nonzero((path_occ == batch_no) & (status == WRITE_OK))[0]
                if not len(sel):
                    continue
                out = clock_ops.batched_write_prepass(
                    self._path_clocks, self._agent_clocks,
                    self._put(path_rows[sel]), self._put(writer_rows[sel]), self.strict,
                )
                self._path_clocks = out.path_clocks
                self._agent_clocks = out.agent_clocks
                rejected = ~out.allowed.cpu().numpy()
                status[sel[rejected]] = WRITE_CONFLICT

        # ── apply survivors to the VFS in submission order ─────────────
        applied = 0
        for i, (did, path, content, _) in enumerate(staged):
            if status[i] == WRITE_OK:
                self.vfs.write(path, content, did)
                applied += 1

        return WriteReport(
            status=status,
            applied=applied,
            rate_limited=int((status == WRITE_RATE_LIMITED).sum()),
            conflicts=int((status == WRITE_CONFLICT).sum()),
            quarantined=int((status == WRITE_QUARANTINED).sum()),
            lock_required=int((status == WRITE_LOCK_REQUIRED).sum()),
        )

    def observe(self, agent_did: str, path: str) -> None:
        """The reader merges the path clock into its own clock (the read
        barrier, `vector_clock.py:88-102`) so its next write is fresh."""
        a = self._writers.intern(agent_did)
        if len(self._writers) > self._agent_clocks.shape[0]:
            raise RuntimeError("writer capacity exceeded; raise max_writers")
        p = self._paths.lookup(path)
        if p < 0:
            return
        self._agent_clocks[a] = clock_ops.merge(self._agent_clocks[a], self._path_clocks[p])
