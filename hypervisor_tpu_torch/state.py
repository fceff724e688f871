"""A slim `HypervisorState`: the device tables, session creation, id
interning, and the governance wave staged as bench.py stages it.

The counterpart of the main path of `hypervisor_tpu.state.HypervisorState`
(`__init__`, `create_sessions_batch`, the fused wave dispatch). The
facade's `run_governance_wave` — WAL, trace, DeltaLog, gateway,
epilogue — arrives with the next slice of the port.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from hypervisor_tpu_torch import resolve_device, u32
from hypervisor_tpu_torch.config import DEFAULT_CONFIG, HypervisorConfig
from hypervisor_tpu_torch.models import SessionConfig, SessionState
from hypervisor_tpu_torch.ops import pipeline
from hypervisor_tpu_torch.tables.intern import InternTable
from hypervisor_tpu_torch.tables.metrics import MetricsTable
from hypervisor_tpu_torch.tables.state import (
    SF32_MIN_SIGMA,
    SI32_MAX_PARTICIPANTS,
    SI32_MODE,
    SI32_SID,
    SI32_STATE,
    AgentTable,
    SessionTable,
    VouchTable,
)


class HypervisorState:
    """The batched governance state on one device.

    Tables live on `device` ("cuda" by default; it raises without CUDA)
    and every wave updates them in place.
    """

    def __init__(
        self, config: HypervisorConfig = DEFAULT_CONFIG, device: str | torch.device = "cuda"
    ) -> None:
        self.config = config
        self.device = resolve_device(device)
        cap = config.capacity
        self.agents = AgentTable.create(cap.max_agents, self.device)
        self.sessions = SessionTable.create(cap.max_sessions, self.device)
        self.vouches = VouchTable.create(cap.max_vouch_edges, self.device)
        self.metrics = MetricsTable.create(device=self.device)
        self.agent_ids = InternTable()
        self.session_ids = InternTable()
        self._next_session_slot = 0

    def create_sessions_batch(
        self, session_ids: Sequence[str], config: SessionConfig
    ) -> np.ndarray:
        """Allocate K session rows in HANDSHAKING; returns their slots
        (the contiguous block arange(base, base + K))."""
        k = len(session_ids)
        base = self._next_session_slot
        if base + k > self.sessions.i32.shape[0]:
            raise RuntimeError(
                f"session table full: {base} + {k} > {self.sessions.i32.shape[0]}; "
                "raise config.capacity.max_sessions"
            )
        self._next_session_slot += k
        slots = np.arange(base, base + k, dtype=np.int32)
        sids = np.array([self.session_ids.intern(s) for s in session_ids], np.int32)
        rows = self.sessions.i32[base:base + k]
        rows[:, SI32_SID] = torch.from_numpy(sids).to(self.device)
        rows[:, SI32_STATE] = SessionState.HANDSHAKING.code
        rows[:, SI32_MODE] = config.consistency_mode.code
        rows[:, SI32_MAX_PARTICIPANTS] = config.max_participants
        self.sessions.f32[base:base + k, SF32_MIN_SIGMA] = float(np.float32(config.min_sigma_eff))
        self.sessions.enable_audit[base:base + k] = bool(config.enable_audit)
        return slots

    def stage_wave(
        self,
        agent_slots: np.ndarray,     # i32[B] agent rows the joiners take
        dids: Sequence[str],         # [B] joining agents
        session_slots: np.ndarray,   # i32[B] session each joiner targets
        sigma_raw: np.ndarray,       # f32[B]
        delta_bodies: np.ndarray,    # u32[T, K, 16]
        wave_sessions: np.ndarray | None = None,  # i32[K]; default: session_slots
        *,
        now: float = 0.0,
        omega: float = 0.5,
        trustworthy: np.ndarray | None = None,  # bool[B]; default all True
        duplicate: np.ndarray | None = None,    # bool[B]; default all False
    ) -> dict:
        """Intern the joiners, validate the lanes on the host and copy them
        to the device: the keyword arguments of `ops.pipeline.
        governance_wave` for this state's tables (metrics included).

        The host checks what the kernels take on trust: every slot is in
        range and no two non-duplicate lanes take one agent slot (the
        admission kernel writes each admitted lane's row without a
        check). It also works out the two layout contracts they rely
        on: `wave_range` when the wave's sessions are one contiguous slot
        block, and `unique_sessions` when no two non-duplicate lanes
        target one session.
        """
        b = len(dids)
        agent_slots = np.asarray(agent_slots, np.int32)
        session_slots = np.asarray(session_slots, np.int32)
        wave_sessions = session_slots if wave_sessions is None else np.asarray(wave_sessions, np.int32)
        trustworthy = np.ones(b, bool) if trustworthy is None else np.asarray(trustworthy, bool)
        duplicate = np.zeros(b, bool) if duplicate is None else np.asarray(duplicate, bool)
        n_cap, s_cap = self.agents.i32.shape[0], self.sessions.i32.shape[0]
        if agent_slots.shape != (b,) or session_slots.shape != (b,):
            raise ValueError("agent_slots and session_slots need one entry per did")
        if b and (agent_slots.min() < 0 or agent_slots.max() >= n_cap):
            raise ValueError("agent slot out of range")
        for name, sl in (("session", session_slots), ("wave session", wave_sessions)):
            if sl.size and (sl.min() < 0 or sl.max() >= s_cap):
                raise ValueError(f"{name} slot out of range")
        k = wave_sessions.shape[0]
        lo = int(wave_sessions[0]) if k else 0
        contiguous = bool((wave_sessions == np.arange(lo, lo + k, dtype=np.int32)).all())
        seated = session_slots[~duplicate]
        joiners = agent_slots[~duplicate]
        if np.unique(joiners).size != joiners.size:
            raise ValueError("two non-duplicate lanes take the same agent slot")

        dev = self.device
        handles = np.array([self.agent_ids.intern(d) for d in dids], np.int32)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return dict(
            agents=self.agents, sessions=self.sessions, vouches=self.vouches,
            slot=put(agent_slots), did=put(handles), session_slot=put(session_slots),
            sigma_raw=put(np.asarray(sigma_raw, np.float32)),
            trustworthy=put(trustworthy), duplicate=put(duplicate),
            wave_sessions=put(wave_sessions),
            delta_bodies=u32.from_numpy_u32(delta_bodies, dev),
            now=now, omega=omega,
            trust=self.config.trust,
            ring_bursts=self.config.rate_limit.ring_bursts,
            wave_range=(lo, lo + k) if contiguous else None,
            unique_sessions=bool(np.unique(seated).size == seated.size),
            metrics=self.metrics,
        )

    def governance_wave(self, *args, **kwargs) -> pipeline.WaveResult:
        """Stage one wave (`stage_wave`, same arguments) and run the fused
        wave over the tables and the metrics table, in place."""
        return pipeline.governance_wave(**self.stage_wave(*args, **kwargs))
