"""Facade-level mixed-consistency tick driver (STRONG vs EVENTUAL).

The reference stores a per-session `ConsistencyMode` flag but never
executes on it (`models.py:12-16`; the only behavior is STRONG-forcing on
non-reversible actions, `core.py:146-147`). Here the flag is OPERATIONAL:
`ConsistencyRuntime` reads the device SessionTable's `mode` column and
runs `parallel.collectives.mode_tick` — STRONG sessions' table deltas
ride an in-tick psum barrier; EVENTUAL sessions' deltas come back as
per-shard partials with zero in-tick communication and fold into the
replicated table only when `reconcile()` runs between batched ticks
(`collectives.reconcile_sessions`).

Built from the facade: `Hypervisor.consistency_runtime(mesh)` binds this
to the live `HypervisorState`, so the mode a session declared in its
`SessionConfig` (or had forced by a non-reversible manifest) is exactly
the mode its lanes execute under.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hypervisor_tpu_torch import u32
from hypervisor_tpu_torch.models import ConsistencyMode
from hypervisor_tpu_torch.parallel.collectives import mode_tick, reconcile_sessions


class ConsistencyRuntime:
    """Mixed-mode distributed governance ticks over a device mesh.

    One instance per (state, mesh): the tick and reconcile closures are
    built once on the instance. Lanes are governance-pipeline lanes; each
    lane names its session slot and the session's `mode` column decides
    the lane's consistency path — the caller never picks a path by hand.
    """

    def __init__(self, state, mesh) -> None:
        self.state = state
        self.mesh = mesh
        self._tick = mode_tick(mesh)
        self._reconcile = reconcile_sessions(mesh)
        s_cap = state.sessions.i32.shape[0]
        # Accumulated EVENTUAL partials: [D, S_cap] per tick, summed.
        self._pending_counts = np.zeros((mesh.devices.size, s_cap), np.int32)
        self._pending_sigma = np.zeros((mesh.devices.size, s_cap), np.float32)

    def _put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.state.device)

    def lane_modes(self, lane_sessions: np.ndarray) -> np.ndarray:
        """bool[S]: True where the lane's session is STRONG (mode column)."""
        modes = self.state.sessions.mode.cpu().numpy()
        return (
            modes[np.clip(np.asarray(lane_sessions), 0, None)]
            == ConsistencyMode.STRONG.code
        )

    def tick(
        self,
        lane_sessions: np.ndarray,   # i32[S] session slot per lane
        sigma_raw: np.ndarray,       # f32[S]
        trustworthy: np.ndarray,     # bool[S]
        delta_bodies: np.ndarray,    # u32[T, S, BODY_WORDS]
        active: Optional[np.ndarray] = None,
        min_sigma_eff: Optional[np.ndarray] = None,
    ):
        """Run one mixed-mode governance tick on the state's tables.

        STRONG lanes' session-count deltas land in the SessionTable
        before this returns (consensus barrier); EVENTUAL lanes' deltas
        accumulate host-side until `reconcile()`.
        """
        s = len(lane_sessions)
        if active is None:
            active = np.ones(s, bool)
        if min_sigma_eff is None:
            min_sigma_eff = self.state.sessions.min_sigma_eff.cpu().numpy()[
                np.clip(np.asarray(lane_sessions), 0, None)
            ]
        strong = self.lane_modes(lane_sessions)
        result, sessions, ev_counts, ev_sigma = self._tick(
            self.state.sessions,
            self._put(np.asarray(lane_sessions, np.int32)),
            self._put(strong),
            self._put(np.asarray(sigma_raw, np.float32)),
            self._put(np.asarray(trustworthy, bool)),
            self._put(np.asarray(min_sigma_eff, np.float32)),
            u32.from_numpy_u32(np.asarray(delta_bodies, np.uint32), self.state.device),
            self._put(np.asarray(active, bool)),
        )
        self.state.sessions = sessions
        self._pending_counts = self._pending_counts + ev_counts.cpu().numpy()
        self._pending_sigma = self._pending_sigma + ev_sigma.cpu().numpy()
        return result

    def reconcile(self) -> tuple[np.ndarray, np.ndarray]:
        """Fold accumulated EVENTUAL partials into the SessionTable.

        The between-tick allreduce (`reconcile_sessions`): after this,
        an EVENTUAL session's table row matches what STRONG mode would
        have produced in-tick. Returns (total_counts, total_sigma).
        """
        sessions, counts, sigma = self._reconcile(
            self.state.sessions,
            self._put(self._pending_counts),
            self._put(self._pending_sigma),
        )
        self.state.sessions = sessions
        self._pending_counts[:] = 0
        self._pending_sigma[:] = 0
        return counts.cpu().numpy(), sigma.cpu().numpy()

    @property
    def has_pending(self) -> bool:
        """True when EVENTUAL deltas await a reconcile."""
        return bool(
            self._pending_counts.any() or self._pending_sigma.any()
        )
