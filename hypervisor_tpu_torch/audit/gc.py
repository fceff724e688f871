"""Ephemeral-data garbage collection after session archival.

Capability parity with reference `audit/gc.py:48-141` (retention policy —
90-day deltas, permanent summary hash; best-effort VFS purge via
duck-typed list/delete; delta expiry via the engine's prune hook; storage
accounting; purged-session tracking) — organized as a plan/execute
pipeline: `collect` builds a `_Sweep` from the three purge phases (VFS
files, caches, aged deltas), each phase reporting its own counts, and the
accounting step folds the phase reports into the `GCResult`. Unlike the
reference (whose per-file delete call signature never matches SessionVFS
and silently no-ops), the VFS phase actually removes files, attributed to
a system DID.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime, timedelta
from typing import Any, Optional

from hypervisor_tpu_torch.utils.clock import Clock, utc_now

GC_AGENT_DID = "did:hypervisor:gc"


@dataclass
class RetentionPolicy:
    """What survives GC (mirrors reference `gc.py:39-45` shape)."""

    delta_retention_days: int = 90
    hash_retention: str = "permanent"
    liability_snapshot: bool = True


@dataclass
class GCResult:
    session_id: str
    retained_deltas: int
    retained_hash: bool
    purged_vfs_files: int
    purged_caches: int
    storage_before_bytes: int
    storage_after_bytes: int
    gc_at: datetime = field(default_factory=utc_now)

    @property
    def storage_saved_bytes(self) -> int:
        return self.storage_before_bytes - self.storage_after_bytes

    @property
    def savings_pct(self) -> float:
        if self.storage_before_bytes == 0:
            return 0.0
        return (self.storage_saved_bytes / self.storage_before_bytes) * 100


@dataclass
class _Sweep:
    """Phase reports folded into the final GCResult."""

    vfs_purged: int = 0
    deltas_retained: int = 0


class EphemeralGC:
    """Post-archive collector: purge VFS + caches, expire deltas, keep the hash."""

    def __init__(
        self, policy: Optional[RetentionPolicy] = None, clock: Clock = utc_now
    ) -> None:
        self.policy = policy or RetentionPolicy()
        self._clock = clock
        self._results_by_session: dict[str, list[GCResult]] = {}

    def collect(
        self,
        session_id: str,
        vfs: Any = None,
        delta_engine: Any = None,
        vfs_file_count: int = 0,
        cache_count: int = 0,
        delta_count: int = 0,
        estimated_vfs_bytes: int = 0,
        estimated_cache_bytes: int = 0,
        estimated_delta_bytes: int = 0,
    ) -> GCResult:
        """Purge a terminated session's ephemeral state (best-effort)."""
        sweep = _Sweep(vfs_purged=vfs_file_count, deltas_retained=delta_count)
        self._sweep_vfs(vfs, sweep)
        self._sweep_deltas(delta_engine, delta_count, sweep)

        ephemeral = estimated_vfs_bytes + estimated_cache_bytes
        surviving = estimated_delta_bytes if delta_count > 0 else 0
        result = GCResult(
            session_id=session_id,
            retained_deltas=max(sweep.deltas_retained, 0),
            retained_hash=True,  # policy.hash_retention is "permanent"
            purged_vfs_files=sweep.vfs_purged,
            purged_caches=cache_count,
            storage_before_bytes=ephemeral + surviving,
            storage_after_bytes=surviving,
            gc_at=self._clock(),
        )
        self._results_by_session.setdefault(session_id, []).append(result)
        return result

    # ── purge phases ────────────────────────────────────────────────────

    @staticmethod
    def _sweep_vfs(vfs: Any, sweep: _Sweep) -> None:
        if vfs is None or not hasattr(vfs, "list_files"):
            return
        try:
            doomed = list(vfs.list_files())
        except Exception:
            return
        sweep.vfs_purged = len(doomed)
        for path in doomed:
            try:
                vfs.delete(path, GC_AGENT_DID)
            except TypeError:
                try:
                    vfs.delete(path)
                except Exception:
                    pass  # best-effort
            except Exception:
                pass  # best-effort

    def _sweep_deltas(self, delta_engine: Any, delta_count: int, sweep: _Sweep) -> None:
        if delta_engine is None or not hasattr(delta_engine, "deltas"):
            return
        aged = sum(
            1
            for d in delta_engine.deltas
            if self.should_expire_deltas(d.timestamp)
        )
        sweep.deltas_retained = delta_count - aged
        if hasattr(delta_engine, "prune_expired"):
            delta_engine.prune_expired(self.policy.delta_retention_days)

    # ── queries ─────────────────────────────────────────────────────────

    def is_purged(self, session_id: str) -> bool:
        return session_id in self._results_by_session

    def should_expire_deltas(self, delta_timestamp: datetime) -> bool:
        cutoff = self._clock() - timedelta(days=self.policy.delta_retention_days)
        return delta_timestamp < cutoff

    @property
    def history(self) -> list[GCResult]:
        return [r for runs in self._results_by_session.values() for r in runs]

    @property
    def purged_session_count(self) -> int:
        return len(self._results_by_session)
