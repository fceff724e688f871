"""`HypervisorState`: the host-device bridge of the port.

The counterpart of `hypervisor_tpu.state.HypervisorState` for the
lifecycle wave, the audit plane behind it, the saga plane and the slash
cascade:

  * the device tables (agents, sessions, vouch edges, sagas, ring
    elevations, metrics, the DeltaLog and EventLog rings and the
    tracer's TraceLog ring) and the host
    indices: interning, membership keys, the agent-row and edge-row free
    lists, the fan-out groups, and the audit index (session -> DeltaLog
    rows, turn counters, chain seeds, incremental Merkle frontiers,
    ring-row ownership);
  * `create_session` / `create_sessions_batch` and the session-row
    writes (`set_session_state`, `session_expiry_sweep`,
    `force_session_mode`);
  * the join queue: `enqueue_join` stages joins (thread-safe), and
    `flush_joins` admits them as one wave (kernel B4 on CUDA, in its
    no-contribution form); `leave_agent`, and the membership accessors
    (`is_member`, `participant_count`, `agent_row`, `agent_rows`);
  * `run_governance_wave`, the facade's single-device lifecycle wave:
    row claims, lane staging and bucket padding on the host, ONE fused
    wave (`ops.pipeline.governance_wave`, with the in-wave DeltaLog
    append, the trace stamps, the action gateway when actions ride, and
    the gauge epilogue), then the membership and audit bookkeeping;
  * `stage_delta` / `flush_deltas`, chain verification, the frontier;
  * `terminate_sessions`;
  * vouch edges (`add_vouch`, `release_vouch`, `free_edge_rows`) and the
    slash cascade (`apply_slash`, kernel B8 on CUDA; `blacklist_rows`);
  * the saga plane: `create_saga` / `create_saga_from_dsl`, the fan-out
    groups (`fanout_dispatch`, `fanout_settle`), `saga_work`,
    `saga_round` (kernel B7 on CUDA), `sagas_settled` and the isolation
    gate that `runtime.saga_scheduler.SagaScheduler` drives;
  * the security surface: the breach window (`record_calls`,
    `breach_sweep_tick`), sudo elevations (`grant_elevation`,
    `revoke_elevation`, `elevation_tick`, `effective_rings`),
    quarantine (`quarantine_rows`, `quarantine_tick`,
    `quarantined_mask`), `set_agent_risk` / `set_agent_ring`, the token
    buckets (`consume_rate`) and the action gateway as a wave of its own
    (`check_actions_wave`).

`stage_wave` / `governance_wave` keep the slim bench-shaped op path.
The host keeps mirrors of both ring cursors (`_delta_cursor`,
`tracer.cursor`): it knows every advance, so no wave reads a device
cursor back.

Thread safety, as in the reference: any number of producer threads may
call `enqueue_join` while one thread flushes. The staging lock
(`_enqueue_lock`, reentrant: `leave_agent` resolves its row through
`agent_row`, whose cache fill takes it too) guards the staging queue and
every mutation of the membership keys, `_slot_of_member`, the agent-row
free list and cursor; `flush_joins`, `leave_agent` and `set_agent_ring`
hold it across their whole table read-modify-write. The other methods
belong to the one flushing thread.

The resilience plane, as in the reference: every mutating op journals an
intent/commit bracket into an attached `resilience.WriteAheadLog`
(`_journal`, the same op names and payloads as the reference, so one
call sequence writes the same log bytes on both packages, and
`resilience.recovery` replays either package's log); the dispatch sites
consult a fault injector before any mutation, then the integrity plane's
cadence (`_predispatch`; on the facade wave a cadence hit folds the
sanitizer into the wave); a degraded-mode policy sheds joins
(`_shed_gate`) and pauses the fan-out, and the admission damper watches
the join stream. An attached `resilience.Supervisor` retries injected
faults and restores from its checkpoints.

The observability planes, as in the reference: `metrics` is an
`observability.metrics.Metrics` (the device table the waves add into,
its host plane and the drain, `metrics_snapshot` / `metrics_prometheus`);
the 13 stage timers bracket the dispatch sites and measure the host's
enqueue; `health` is the watchdog over the tracer's bracket, occupancy
and the compile watch around the module-level dispatch entries;
`history` and `incidents` are the hindsight plane fed by the drain;
`session_trace` / `flight_summary` drain the flight recorder; the drain
publishes the roofline observatory's gauges (`roofline_summary`). An
attached serving front door (`serving`) adds its panels
(`serving_summary`, `slo_summary`) and the exemplar lines of
`metrics_prometheus`. The mesh path arrives with a later slice of the
port.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from hypervisor_tpu_torch import resolve_device, u32
from hypervisor_tpu_torch.audit.frontier import MerkleFrontier
from hypervisor_tpu_torch.config import DEFAULT_CONFIG, HypervisorConfig
from hypervisor_tpu_torch.kernels import wave as wave_kernels
from hypervisor_tpu_torch.models import SessionConfig, SessionState
from hypervisor_tpu_torch.observability import health as health_plane
from hypervisor_tpu_torch.observability import history as history_plane
from hypervisor_tpu_torch.observability import incidents as incidents_plane
from hypervisor_tpu_torch.observability import metrics as metrics_plane
from hypervisor_tpu_torch.observability import roofline as roofline_plane
from hypervisor_tpu_torch.observability import tracing
from hypervisor_tpu_torch.observability.tracing import Tracer
from hypervisor_tpu_torch.ops import merkle as merkle_ops
from hypervisor_tpu_torch.ops import liability as liability_ops
from hypervisor_tpu_torch.ops import gateway as gateway_ops
from hypervisor_tpu_torch.ops import pipeline, rate_limit, saga_ops, security_ops
from hypervisor_tpu_torch.ops import terminate as terminate_ops
from hypervisor_tpu_torch.ops.admission import ADMIT_OK, tally_admission
from hypervisor_tpu_torch.ops.rings import compute_rings
from hypervisor_tpu_torch.resilience.policy import DegradedModeRefusal, SybilShedRefusal
from hypervisor_tpu_torch.runtime import StagingQueue
from hypervisor_tpu_torch.tables.intern import InternTable
from hypervisor_tpu_torch.tables.logs import DeltaLog, EventLog
from hypervisor_tpu_torch.tables.state import (
    AF32_BD_BREAKER_UNTIL,
    AF32_QUARANTINE_UNTIL,
    AF32_RISK,
    AF32_RL_STAMP,
    AF32_RL_TOKENS,
    AF32_SIGMA_EFF,
    AI32_DID,
    AI32_FLAGS,
    AI32_SESSION,
    FLAG_ACTIVE,
    FLAG_BLACKLISTED,
    FLAG_BREAKER_TRIPPED,
    FLAG_QUARANTINED,
    SF32_CREATED_AT,
    SF32_MAX_DURATION,
    SF32_MIN_SIGMA,
    SI32_MAX_PARTICIPANTS,
    SI32_MODE,
    SI32_NPART,
    SI32_SID,
    SI32_STATE,
    AgentTable,
    ElevationTable,
    SagaTable,
    SessionTable,
    VouchTable,
)


class _NullTxn:
    """No-journal stand-in for `_journal` (shared, stateless)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def cancel(self) -> None:
        pass


_NULL_TXN = _NullTxn()


def _comp_backlog_warn() -> int:
    """Compensation backlog at/above which `saga_work` emits the
    `comp_backlog` health event (the Supervisor's storm-pressure signal).
    Read per call, so an environment set after import holds."""
    try:
        return int(os.environ.get("HV_COMP_BACKLOG_WARN", "16"))
    except ValueError:
        return 16


# Every module-level dispatch entry is wrapped in compile telemetry
# (`observability.health.instrument`), under the reference's program
# names: the watch keys each call's abstract signature, times the novel
# ones and names the argument that forced a recompile — all on the host.
_ADMIT = health_plane.instrument("admit_batch", wave_kernels.admission_block)
_SAGA_TICK = health_plane.instrument("saga_table_tick", saga_ops.saga_table_tick)
_TERMINATE = health_plane.instrument("terminate_batch", terminate_ops.terminate_batch)
# The fused wave's static surface, as in the reference: a change of any of
# these (the sanitize variant among them) is a new signature.
_WAVE_STATICS = ("unique_sessions", "trust", "breach", "rate_limit", "sanitize", "config")
_WAVE = health_plane.instrument(
    "governance_wave", pipeline.governance_wave, static_argnames=_WAVE_STATICS)
_RECORD_CALLS = health_plane.instrument(
    "record_calls", security_ops.record_calls, static_argnames=("config",))
_SLASH = health_plane.instrument("slash_cascade", liability_ops.slash_cascade)
_BREACH_SWEEP = health_plane.instrument(
    "breach_sweep", security_ops.breach_sweep, static_argnames=("config",))
_ELEV_EXPIRY = health_plane.instrument("elevation_expiry", security_ops.elevation_expiry)
_QUAR_ENTER = health_plane.instrument("quarantine_enter", security_ops.quarantine_enter)
_RATE_CONSUME = health_plane.instrument(
    "rate_consume", rate_limit.consume, static_argnames=("config",))
_QUAR_SWEEP = health_plane.instrument("quarantine_sweep", security_ops.quarantine_sweep)
_FANOUT_ROUND = health_plane.instrument("fanout_round", saga_ops.fanout_round)
_EFF_RINGS = health_plane.instrument("effective_rings", security_ops.effective_rings)
_GATEWAY = health_plane.instrument(
    "gateway_check_actions", gateway_ops.check_actions,
    static_argnames=("breach", "rate_limit", "trust"))
_UPDATE_GAUGES = health_plane.instrument("update_gauges", metrics_plane.update_gauges)


def _config_payload(config: SessionConfig) -> dict:
    """SessionConfig -> its WAL fields (`resilience.recovery.
    _session_config` is the inverse)."""
    return {
        "mode": config.consistency_mode.value,
        "max_participants": int(config.max_participants),
        "max_duration_seconds": int(config.max_duration_seconds or 0),
        "min_sigma_eff": float(config.min_sigma_eff),
        "enable_audit": bool(config.enable_audit),
    }


def _mkey(session: int, did: int) -> int:
    """One (session << 32) | did membership key."""
    return (int(session) << 32) | (int(did) & 0xFFFFFFFF)


def _mkeys(sessions: np.ndarray, dids: np.ndarray) -> np.ndarray:
    """(session << 32) | did membership keys over whole waves -> int64[B]."""
    return (np.asarray(sessions, np.int64) << 32) | (np.asarray(dids, np.int64) & 0xFFFFFFFF)


def _isolation_refusal_from(flags: int, breaker_until: float, now: float) -> Optional[str]:
    """The isolation-gate rule on one row's column values: only LIVE rows
    gate, and the breaker is consulted before the quarantine, so a
    dual-flagged agent refuses with the same reason on every path."""
    if not flags & FLAG_ACTIVE:
        return None
    if flags & FLAG_BREAKER_TRIPPED and now < breaker_until:
        return "circuit breaker tripped (breach cooldown)"
    if flags & FLAG_QUARANTINED:
        return "agent is quarantined (read-only isolation)"
    return None


def _contiguous_range_host(slots: np.ndarray) -> tuple[int, int] | None:
    """(lo, hi) if `slots` is exactly arange(lo, lo + len) with lo >= 0,
    else None (empty, gaps, duplicates or another order)."""
    slots = np.asarray(slots)
    if slots.size == 0 or int(slots[0]) < 0:
        return None
    lo = int(slots[0])
    if not np.array_equal(slots, np.arange(lo, lo + slots.size, dtype=slots.dtype)):
        return None
    return (lo, lo + slots.size)


class HypervisorState:
    """The batched governance state on one device: device tables plus the
    host boundary indices.

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
        self.sagas = SagaTable.create(cap.max_sagas, cap.max_steps_per_saga, self.device)
        self.elevations = ElevationTable.create(cap.max_elevations, self.device)
        self.delta_log = DeltaLog.create(cap.delta_log_capacity, self.device)
        self.event_log = EventLog.create(cap.event_log_capacity, self.device)
        # The metrics plane: the device table the waves add into (in
        # place), its host plane, and the drain (`metrics_snapshot`, the
        # one read, outside every wave).
        self.metrics = self._make_metrics()
        # The flight recorder: the TraceLog ring the waves stamp and the
        # host bracket around every dispatch. HV_TRACE=0 disables it.
        self.tracer = self._make_tracer(cap.trace_log_capacity)
        # The health plane: the wave watchdog (deadlines from the stages'
        # own host-plane latency histograms) on the tracer's bracket, the
        # occupancy high-water and warn accounting, and the event fan-out
        # the facade bridges onto the event bus.
        self.health = health_plane.HealthMonitor(self.metrics)
        self.tracer.health = self.health
        # The roofline observatory's event cursor: the registry is
        # process-global; each state drains its own view of the shift
        # events at its own metrics drain.
        self._roofline_event_seq = 0
        # The hindsight plane: the tiered history fed from the drain's
        # snapshot, and the incident recorder on the health fan-out.
        # `hindsight_clock` (callable -> float) overrides their clock, so
        # a virtual-clock run replays its history and incident digests
        # bit for bit; None = `now()`.
        self.hindsight_clock = None
        self.history = history_plane.HistoryPlane(metrics=self.metrics)
        self.incidents = incidents_plane.IncidentRecorder(
            history=self.history, metrics=self.metrics, clock=self._hindsight_now,
        )
        self.incidents.emit = self.health.emit_event
        self.health.add_listener(self.incidents.observe)
        self.incidents.register_provider("wal", self._incident_wal_block)
        self.incidents.register_provider("slo", lambda trigger: self.slo_summary())
        self.incidents.register_provider("trace", self._incident_trace_block)
        self.agent_ids = InternTable()
        self.session_ids = InternTable()
        self.saga_ids = InternTable()
        self._next_session_slot = 0
        self._next_agent_slot = 0
        self._next_saga_slot = 0
        self._next_edge_slot = 0
        self._next_elev_slot = 0
        # Fan-out groups per saga slot: [(policy_code, [branch idxs])],
        # ordered by first branch index (from create_saga_from_dsl).
        self._fanout_groups: dict[int, list[tuple[int, list[int]]]] = {}
        # Wave rows recycle here after every wave (each is dead once its
        # session terminates in-wave); claims pop from the end.
        self._free_agent_slots: list[int] = []
        self._free_edge_slots: list[int] = []
        # Elevation rows freed by revoke, expiry or a reclaimed holder.
        self._free_elev_slots: list[int] = []
        # Edge rows the terminate GC deactivated for a reclaimed endpoint.
        self._scrubbed_edges: list[int] = []
        # Membership keys (session << 32) | did (`_mkey`).
        self._members: set[int] = set()
        # One device row per membership: (did, session) -> agent slot.
        self._slot_of_member: dict[tuple[int, int], int] = {}
        # The join queue and its host bookkeeping, keyed by agent slot
        # (concurrent producers may claim queue entries in another order
        # than they claim rows): slot -> (did, session, duplicate), and
        # the membership keys staged but not yet flushed.
        self._queue = StagingQueue(capacity=cap.max_agents)
        self._enqueue_lock = threading.RLock()
        self._pending_rows: dict[int, tuple[int, int, bool]] = {}
        self._staged_members: set[int] = set()
        #: The last `flush_joins`' status per membership key (the best of
        #: a same-wave duplicate pair): how a front door resolves tickets.
        self.last_join_results: dict[int, int] = {}
        # Timestamps are stored in f32 columns: keep them small, relative
        # to this epoch.
        self._epoch_base = time.time()
        # The audit plane: pending deltas, session -> DeltaLog rows, chain
        # seeds (u32[8]), turn counters, incremental Merkle frontiers, the
        # packed-body cache per (session, turn range), and ring-row
        # ownership (a wrap evicts the previous owner's rows).
        self._pending_deltas: list[tuple[int, int, np.ndarray, float, np.ndarray | None]] = []
        self._audit_rows: dict[int, list[int]] = {}
        self._chain_seed: dict[int, np.ndarray] = {}
        self._turns: dict[int, int] = {}
        self._frontier: dict[int, MerkleFrontier] = {}
        self._packed_bodies: dict[int, tuple[int, int, np.ndarray]] = {}
        self._row_session = np.full(cap.delta_log_capacity, -1, np.int32)
        #: Host mirror of `delta_log.cursor`.
        self._delta_cursor = 0
        # The resilience plane, all opt-in: the write-ahead log bracketing
        # every mutating op (`_journal`), the seeded dispatch interposer
        # (`testing.chaos.WaveChaosInjector`) consulted before any mutation,
        # the degraded-mode policy (joins shed, fan-out paused), swapped
        # whole under `_policy_lock` by whoever installs it, and the
        # admission-rate sybil damper; the attached supervisor
        # (`resilience.Supervisor`) and integrity plane
        # (`integrity.IntegrityPlane`) publish themselves here.
        self.journal = None
        self.fault_injector = None
        self.degraded_policy = None
        self._policy_lock = threading.Lock()
        self.admission_damper = None
        self.resilience = None
        self.integrity = None
        # The serving front door (opt-in, `serving.FrontDoor` sets it):
        # `health_summary` carries its queue, shed and deadline panel.
        self.serving = None
        #: The WAL watermark a restored checkpoint carries: recovery
        #: replays the committed records past it.
        self._restored_wal_seq: Optional[int] = None
        # Fused-epilogue gauge freshness: True only between a facade
        # wave (its epilogue refreshed every occupancy gauge) and the
        # NEXT mutation; `metrics_snapshot` then skips its refresh.
        # Cleared at `_journal`, `_predispatch`, `sync_events_to_device`
        # and the integrity repair.
        self._gauges_fresh = False

    def _make_metrics(self) -> metrics_plane.Metrics:
        """Metrics-plane factory (the reference's override hook)."""
        return metrics_plane.Metrics(device=self.device)

    def _make_tracer(self, capacity: int) -> Tracer:
        """Trace-plane factory (same hook as `_make_metrics`)."""
        return Tracer(capacity=capacity, device=self.device)

    def now(self) -> float:
        """Seconds since this state's epoch — the f32-safe device time."""
        return time.time() - self._epoch_base

    # ── resilience hooks ─────────────────────────────────────────────

    def _journal(self, op: str, build=None, **payload):
        """WAL intent/commit bracket for one state-mutating op, a no-op
        context when no journal is attached. Re-entrant: an op journaled
        inside another journaled op is suppressed, and the outer record
        replays the composite. Every op name used here has a handler in
        `resilience.recovery.REPLAY`; payloads hold numpy arrays and
        Python scalars only, never a tensor. `build`, where given, makes
        the payload, and runs only when a journal is attached: the sites
        whose payload is a Python pass over a wave's lanes pay nothing
        without one. Any journaled mutation marks the epilogue's gauges
        stale."""
        self._gauges_fresh = False
        if self.journal is None:
            return _NULL_TXN
        return self.journal.txn(op, build() if build is not None else payload)

    def _chaos(self, stage: str) -> None:
        """Fault-injection gate at a dispatch site, consulted before any
        mutation, so an injected raise leaves the tables, the host indices
        and the staging queue as they were (a retry dispatches cleanly)."""
        inj = self.fault_injector
        if inj is not None:
            inj.on_dispatch(stage)

    def _predispatch(self, stage: str, fused_sanitizer: bool = False) -> None:
        """The dispatch-site gate: the injector's raise or stall first
        (pre-mutation, retry-safe), then its scheduled real corruptions
        (`testing.chaos.InjectedCorruption`: silent table damage), then
        the integrity plane's cadence hook (`IntegrityPlane.on_dispatch`:
        a sampled sanitizer pass, a scrub tick, the settling of damage a
        drain flagged). `fused_sanitizer`: the upcoming dispatch folds the
        sanitizer into its own wave, so a cadence hit arms that instead
        of queueing a pass of its own."""
        self._gauges_fresh = False
        self._chaos(stage)
        inj = self.fault_injector
        if inj is not None and getattr(inj, "has_pending_corruptions", False):
            inj.apply_due_corruptions(self)
        plane = self.integrity
        if plane is not None:
            plane.on_dispatch(stage, fused=fused_sanitizer)

    def _shed_gate(self, sigma_raw: Optional[float] = None) -> None:
        """Degraded-mode admission shedding (`resilience.policy`): a
        degraded plane refuses new joins loudly while terminations and
        audit commits keep flowing. `shed_admissions` refuses every join;
        `admission_sigma_floor` > 0 refuses only joins below the floor
        (the sybil damper's targeted shed)."""
        policy = self.degraded_policy
        if policy is None:
            return
        if policy.shed_admissions:
            self.metrics.inc(metrics_plane.ADMISSIONS_SHED)
            raise DegradedModeRefusal(
                f"admission shed: degraded mode active ({policy.reason})"
            )
        if (
            policy.admission_sigma_floor > 0.0
            and sigma_raw is not None
            and sigma_raw < policy.admission_sigma_floor
        ):
            self.metrics.inc(metrics_plane.ADMISSIONS_SHED)
            self.metrics.inc(metrics_plane.ADMISSIONS_DAMPED)
            if self.admission_damper is not None:
                self.admission_damper.note_damped()
            raise SybilShedRefusal(
                f"admission damped: sigma {sigma_raw:.3f} below the "
                f"active floor {policy.admission_sigma_floor:.2f} "
                f"({policy.reason})"
            )

    def resilience_summary(self) -> dict:
        """The supervisor's summary when one is attached; otherwise the
        bare plane state: the mode, the active degraded policy and the
        journal's status."""
        if self.resilience is not None:
            return self.resilience.summary()
        return {
            "enabled": False,
            "mode": "degraded" if self.degraded_policy is not None else "normal",
            "degraded": {
                "active_policy": (
                    self.degraded_policy.to_dict()
                    if self.degraded_policy is not None
                    else None
                ),
            },
            "journal": (
                self.journal.status() if self.journal is not None else None
            ),
        }

    def integrity_summary(self) -> dict:
        """The integrity plane's summary (sanitizer cadence, violation,
        repair and restore accounting, scrub progress, the catalog), or
        the bare plane state when none is attached."""
        if self.integrity is not None:
            return self.integrity.summary()
        return {"enabled": False}

    # ── sessions ─────────────────────────────────────────────────────

    def create_session(
        self, session_id: str, config: SessionConfig, now: Optional[float] = None
    ) -> int:
        """Allocate one session row in HANDSHAKING; returns the slot. `now`
        pins the created_at stamp (epoch-relative); None stamps `now()`."""
        cap = self.sessions.i32.shape[0]
        if self._next_session_slot >= cap:
            raise RuntimeError(
                f"session table full ({cap}); raise config.capacity.max_sessions"
            )
        if now is None:
            now = self.now()
        with self._journal("create_session", sid=session_id, now=float(now),
                           **_config_payload(config)):
            slot = self._next_session_slot
            self._next_session_slot += 1
            sid = self.session_ids.intern(session_id)
            i32, f32 = self.sessions.i32[slot], self.sessions.f32[slot]
            i32[SI32_SID] = sid
            i32[SI32_STATE] = SessionState.HANDSHAKING.code
            i32[SI32_MODE] = config.consistency_mode.code
            i32[SI32_MAX_PARTICIPANTS] = config.max_participants
            f32[SF32_MIN_SIGMA] = float(np.float32(config.min_sigma_eff))
            f32[SF32_CREATED_AT] = float(np.float32(now))
            f32[SF32_MAX_DURATION] = float(np.float32(config.max_duration_seconds or 0))
            self.sessions.enable_audit[slot] = bool(config.enable_audit)
        return slot

    def create_sessions_batch(
        self, session_ids: Sequence[str], config: SessionConfig
    ) -> np.ndarray:
        """Allocate K session rows in HANDSHAKING; returns their slots
        (the contiguous block arange(base, base + K))."""
        k = len(session_ids)
        with self._journal("create_sessions_batch", sids=list(session_ids),
                           **_config_payload(config)):
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
            self.sessions.f32[base:base + k, SF32_MIN_SIGMA] = float(
                np.float32(config.min_sigma_eff))
            self.sessions.enable_audit[base:base + k] = bool(config.enable_audit)
        return slots

    def set_session_state(self, slot: int, state: SessionState) -> None:
        """Write a session row's lifecycle state."""
        with self._journal("set_session_state", slot=int(slot), state=state.value):
            self.sessions.i32[slot, SI32_STATE] = state.code

    def session_expiry_sweep(self, now: float) -> list[int]:
        """Live (HANDSHAKING or ACTIVE) session slots past their max
        duration (0 = unlimited), for the caller to terminate through the
        audit path."""
        state = self.sessions.state.cpu().numpy()
        live = (state == SessionState.HANDSHAKING.code) | (state == SessionState.ACTIVE.code)
        created = self.sessions.created_at.cpu().numpy()
        limit = self.sessions.max_duration.cpu().numpy()
        overdue = live & (limit > 0) & ((now - created) > limit)
        return [int(s) for s in np.nonzero(overdue)[0]]

    def force_session_mode(self, slot: int, mode, has_nonreversible: bool = True) -> None:
        """Rewrite a session row's consistency mode (STRONG forcing when a
        non-reversible action registers) and its non-reversible flag."""
        with self._journal("force_session_mode", slot=int(slot), mode=mode.value,
                           has_nonreversible=bool(has_nonreversible)):
            self.sessions.i32[slot, SI32_MODE] = mode.code
            self.sessions.has_nonreversible[slot] = bool(has_nonreversible)

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
            wave_range=_contiguous_range_host(wave_sessions),
            unique_sessions=bool(np.unique(seated).size == seated.size),
            metrics=self.metrics.table,
        )

    def governance_wave(self, *args, **kwargs) -> pipeline.WaveResult:
        """Stage one wave (`stage_wave`, same arguments) and run the fused
        wave over the tables and the metrics table, in place."""
        return pipeline.governance_wave(**self.stage_wave(*args, **kwargs))

    # ── the facade's lifecycle wave ──────────────────────────────────

    def _claim_wave_rows(self, b_wave: int) -> np.ndarray:
        """Claim `b_wave` agent rows for one wave: from the bump allocator
        while it lasts, then from the END of the free list (wave rows
        recycle there after every wave). Pad lanes claim rows like real
        ones; the claim is transient."""
        with self._enqueue_lock:
            cap = self.agents.i32.shape[0]
            fresh_n = min(b_wave, cap - self._next_agent_slot)
            free = self._free_agent_slots
            need = b_wave - fresh_n
            if need > len(free):
                raise RuntimeError(
                    f"agent table full: {self._next_agent_slot} + {b_wave} > {cap} with "
                    f"{len(free)} free rows; raise config.capacity.max_agents"
                )
            fresh = list(range(self._next_agent_slot, self._next_agent_slot + fresh_n))
            self._next_agent_slot += fresh_n
            recycled = [free.pop() for _ in range(need)]
        return np.array(fresh + recycled, np.int32)

    def _park_sessions(self, n_parked: int, kind: str) -> np.ndarray:
        """Park `n_parked` wave-session lanes on unallocated rows past the
        bump cursor (no allocation: a parked row's memberless walk is a
        no-op)."""
        if n_parked <= 0:
            return np.zeros((0,), np.int32)
        s_cap = self.sessions.i32.shape[0]
        if self._next_session_slot + n_parked > s_cap:
            raise RuntimeError(
                f"no spare session rows to park {n_parked} {kind} lanes "
                f"({self._next_session_slot}+{n_parked} > {s_cap}); "
                "raise config.capacity.max_sessions"
            )
        return np.arange(self._next_session_slot, self._next_session_slot + n_parked,
                         dtype=np.int32)

    def _stage_wave_lanes(
        self, session_slots, dids: Sequence[str], agent_sessions, sigma_raw, trustworthy,
        delta_bodies, b_wave: int, k_wave: int, parked_sessions: np.ndarray,
    ) -> dict:
        """Host-side lane staging for one wave, as plain numpy: interning,
        duplicate detection against the membership keys, bucket padding
        (pad lanes: did -1, session 0, sigma 0, duplicate; pad session
        lanes: the parked rows, zero bodies) and the two layout checks."""
        b, k = len(dids), len(session_slots)
        handles = np.array([self.agent_ids.intern(d) for d in dids], np.int32)
        wave_keys = _mkeys(agent_sessions, handles)
        members = self._members
        duplicate = np.fromiter((key in members for key in wave_keys.tolist()), bool, count=b)
        if trustworthy is None:
            trustworthy = np.ones(b, bool)

        def pad_b(arr, dtype, fill):
            out = np.full((b_wave,), fill, dtype)
            out[:b] = np.asarray(arr, dtype)
            return out

        wave_sessions = np.concatenate([np.asarray(session_slots, np.int32), parked_sessions])
        seat_sessions = np.asarray(agent_sessions, np.int32)[~duplicate]
        bodies = np.asarray(delta_bodies, np.uint32)
        if k_wave != k:
            padded = np.zeros((bodies.shape[0], k_wave) + bodies.shape[2:], np.uint32)
            padded[:, :k] = bodies
            bodies = padded
        return {
            "wave_keys": wave_keys,
            "did": pad_b(handles, np.int32, -1),
            "agent_sessions": pad_b(agent_sessions, np.int32, 0),
            "sigma_raw": pad_b(sigma_raw, np.float32, 0.0),
            "trustworthy": pad_b(trustworthy, bool, True),
            "duplicate": pad_b(duplicate, bool, True),
            "wave_sessions": wave_sessions,
            "range_host": _contiguous_range_host(wave_sessions),
            "unique_sessions": bool(np.unique(seat_sessions).size == seat_sessions.size),
            "bodies": bodies,
        }

    def run_governance_wave(
        self,
        session_slots: np.ndarray,   # i32[K] freshly created sessions
        dids: Sequence[str],         # B joining agents
        agent_sessions: np.ndarray,  # i32[B] target session per agent
        sigma_raw: np.ndarray,       # f32[B]
        delta_bodies: np.ndarray,    # u32[T, K, 16]
        now: float = 0.0,
        omega: float = 0.5,
        trustworthy: Optional[np.ndarray] = None,
        mesh=None,
        actions: Optional[dict] = None,
        pad_to: Optional[tuple[int, int]] = None,
    ):
        """Run the lifecycle wave ON the state tables: claim agent rows,
        stage the lanes on the host, then ONE fused wave admits, walks,
        audits (chain, roots, the DeltaLog append), runs a saga step,
        terminates with bond release, runs the action gateway when
        `actions` ride and refreshes the occupancy gauges, stamping the
        trace ring. Afterwards the wave's admitted memberships are
        published, its rows return to the free list, and its audit chain
        is booked into the host index and the sessions' Merkle frontiers.

        `actions` is a dict with `slots` (standing agent rows, not this
        wave's cohort) and optional `required_rings`, `is_read_only`,
        `has_consensus`, `has_sre_witness` and `host_tripped` columns; the
        gateway runs on the post-terminate table and the call returns
        (WaveResult, GatewayResult) instead.

        `pad_to` = (lanes_bucket, sessions_bucket) pads the wave to a fixed
        bucket shape: pad join lanes ride duplicate=True (refused, no row
        written, out of the tallies), pad session lanes point at unallocated
        rows, only the real sessions' records append, and the result trims
        back to the caller's shape.

        Any session layout runs on either device: the fsm/saga kernel
        tests membership by range when the wave's sessions plus any parked
        rows are one contiguous slot block (`create_sessions_batch`'s
        layout), else by a bitmap of them.

        The fault-injection gate runs before anything mutates; the wave
        journals as "governance_wave" with its resolved action columns
        and `pad_to`, so a replay re-dispatches the identical padded wave.
        """
        if mesh is not None:
            raise NotImplementedError("the mesh wave arrives with the port's multi-device slice")
        if pad_to is not None and (pad_to[0] < len(dids) or pad_to[1] < len(session_slots)):
            raise ValueError(f"pad_to {pad_to} below the wave shape ({len(dids)} lanes, "
                             f"{len(session_slots)} sessions)")
        self._predispatch("governance_wave", fused_sanitizer=True)
        act = None if actions is None else self._normalize_actions(actions)
        with self._journal(
            "governance_wave",
            session_slots=np.asarray(session_slots, np.int32),
            dids=list(dids),
            agent_sessions=np.asarray(agent_sessions, np.int32),
            sigma_raw=np.asarray(sigma_raw, np.float32),
            delta_bodies=np.asarray(delta_bodies, np.uint32),
            now=float(now),
            omega=float(omega),
            trustworthy=None if trustworthy is None else np.asarray(trustworthy, bool),
            use_pallas=None,  # the reference's kernel switch; the port has none
            actions=act,
            pad_to=None if pad_to is None else list(pad_to),
        ):
            return self._governance_wave_impl(session_slots, dids, agent_sessions, sigma_raw,
                                              delta_bodies, now, omega, trustworthy, act, pad_to)

    def _governance_wave_impl(
        self, session_slots, dids, agent_sessions, sigma_raw, delta_bodies, now, omega,
        trustworthy, act, pad_to,
    ):
        """`run_governance_wave`'s body, inside its WAL bracket (`act`: the
        normalized action columns, or None)."""
        b, k = len(dids), len(session_slots)
        b_wave, k_wave = b, k
        if pad_to is not None:
            b_wave, k_wave = int(pad_to[0]), int(pad_to[1])
        gateway_args = None
        if act is not None:
            self._check_action_slots(act["slots"])
            gateway_args = self._pad_gateway_lanes(act)
        agent_slots = self._claim_wave_rows(b_wave)
        parked = self._park_sessions(k_wave - k, "padded bucket")
        staged = self._stage_wave_lanes(
            session_slots, dids, agent_sessions, sigma_raw, trustworthy, delta_bodies,
            b_wave, k_wave, parked,
        )
        wave_sessions = staged["wave_sessions"]
        th = self.tracer.begin_wave("governance_wave", sessions=wave_sessions[:k], lanes=b)
        dev = self.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        # A sampled integrity check folds into this very wave (the plane's
        # cadence armed it at `_predispatch`): the sanitizer runs as the
        # epilogue's tail and its masks come back on the result.
        plane = self.integrity
        sanitize = plane is not None and plane.take_fused_due()
        audit_base_row = self._delta_cursor
        with self.metrics.stage("governance_wave"):
            result = _WAVE(
                self.agents, self.sessions, self.vouches,
                put(agent_slots), put(staged["did"]), put(staged["agent_sessions"]),
                put(staged["sigma_raw"]), put(staged["trustworthy"]), put(staged["duplicate"]),
                put(wave_sessions), u32.from_numpy_u32(staged["bodies"], dev), now, omega,
                trust=self.config.trust, ring_bursts=self.config.rate_limit.ring_bursts,
                wave_range=staged["range_host"], unique_sessions=staged["unique_sessions"],
                metrics=self.metrics.table, trace=self.tracer.table,
                trace_ctx=th.ctx if th is not None else None,
                delta_log=self.delta_log, delta_cursor=audit_base_row,
                lanes_valid=put(np.arange(b_wave) < b) if pad_to is not None else None,
                n_sessions_valid=k if pad_to is not None else None,
                elevations=self.elevations,
                gateway_args=(None if gateway_args is None
                              else tuple(put(c) for c in gateway_args)),
                breach=self.config.breach, rate_limit=self.config.rate_limit,
                epilogue_tables=(self.sagas, self.event_log), sanitize=sanitize,
                config=self.config,
            )
        if sanitize:
            plane.absorb_fused(result.sanitizer)
        t = staged["bodies"].shape[0]
        if t:
            self._delta_cursor += k * t
        self.tracer.end_wave(th, result.trace)
        gw_result = None
        if act is not None:
            gw_result = self._gateway_result_from_lanes(result.gateway, result.agents,
                                                        len(act["slots"]))
        if b_wave != b or k_wave != k:
            result = result._replace(
                status=result.status[:b], ring=result.ring[:b], sigma_eff=result.sigma_eff[:b],
                saga_step_state=result.saga_step_state[:b], merkle_root=result.merkle_root[:k],
                chain=result.chain[:, :k], fsm_error=result.fsm_error[:k],
            )
        ok = result.status.cpu().numpy() == ADMIT_OK
        self._publish_wave_members(staged["wave_keys"][ok].tolist(), agent_slots.tolist())
        if t:
            self._book_wave_audit(session_slots, u32.to_numpy_u32(result.chain), audit_base_row)
        # The epilogue refreshed every occupancy gauge over the post-wave
        # tables, and everything since was host bookkeeping: until the
        # next mutation the drain can skip its refresh.
        self._gauges_fresh = True
        if act is not None:
            return result, gw_result
        return result

    @staticmethod
    def _normalize_actions(actions: dict) -> dict:
        """Fill an `actions` dict's optional columns: required ring 2 (a
        standard write), nothing read-only, no consensus or witness, no
        host-plane breaker trips."""
        slots = np.asarray(actions["slots"], np.int32)
        b = len(slots)

        def col(key, dtype, default):
            if key in actions and actions[key] is not None:
                return np.asarray(actions[key], dtype)
            return np.full((b,), default, dtype)

        return {
            "slots": slots,
            "required_rings": col("required_rings", np.int8, 2),
            "is_read_only": col("is_read_only", bool, False),
            "has_consensus": col("has_consensus", bool, False),
            "has_sre_witness": col("has_sre_witness", bool, False),
            "host_tripped": col("host_tripped", bool, False),
        }

    def _check_action_slots(self, slots) -> None:
        """Refuse out-of-range action slots: the gateway would clamp them
        onto another agent's row (recording its calls, draining its
        bucket, maybe tripping its breaker)."""
        arr = np.asarray(slots, np.int32)
        cap = self.agents.i32.shape[0]
        if len(arr) and (arr.min() < 0 or arr.max() >= cap):
            bad = arr[(arr < 0) | (arr >= cap)]
            raise ValueError(f"action slots out of range [0, {cap}): {bad[:8].tolist()}")

    @staticmethod
    def _pad_gateway_lanes(act: dict) -> tuple:
        """The normalized action columns padded to a power-of-two lane
        block (padding lanes valid=False, touching nothing): the wave's
        `gateway_args`, as host arrays."""
        b = len(act["slots"])
        padded = max(1, 1 << max(0, (b - 1).bit_length()))

        def pad(seq, dtype):
            arr = np.zeros((padded,), dtype)
            arr[:b] = np.asarray(seq, dtype)
            return arr

        return (
            pad(act["slots"], np.int32), pad(act["required_rings"], np.int8),
            pad(act["is_read_only"], bool), pad(act["has_consensus"], bool),
            pad(act["has_sre_witness"], bool), pad(act["host_tripped"], bool),
            np.arange(padded) < b,
        )

    @staticmethod
    def _gateway_result_from_lanes(lanes, agents, b: int) -> gateway_ops.GatewayResult:
        """The wave's padded gateway lanes trimmed to the caller's `b`
        actions (the lanes are already in request order)."""
        return gateway_ops.GatewayResult(
            agents=agents, verdict=lanes.verdict[:b], ring_status=lanes.ring_status[:b],
            eff_ring=lanes.eff_ring[:b], sigma_eff=lanes.sigma_eff[:b],
            severity=lanes.severity[:b], anomaly_rate=lanes.anomaly_rate[:b],
            window_calls=lanes.window_calls[:b], tripped=lanes.tripped[:b],
        )

    def _publish_wave_members(self, admitted_keys: list, recycle_rows: list) -> None:
        """Record the wave's admitted memberships and return every wave
        row to the free list, in order (rejected rows were never admitted,
        admitted rows belong to sessions the wave terminated). Under the
        staging lock: `enqueue_join` reads the keys for its duplicate
        check."""
        with self._enqueue_lock:
            self._members.update(admitted_keys)
            self._free_agent_slots.extend(recycle_rows)

    def _book_wave_audit(self, session_slots, chain: np.ndarray, base_row: int) -> None:
        """Book one wave's audit chain (a host copy, u32[T, K, 8]) into the
        audit index: ring-row claims, per-session rows, turn counters,
        chain seeds and the Merkle frontiers. The ring append itself
        already happened in the wave."""
        t, k = chain.shape[:2]
        if not t:
            return
        sess_rep = np.repeat(np.asarray(session_slots, np.int32), t)
        digests_flat = np.transpose(chain, (1, 0, 2)).reshape(k * t, 8)
        capacity = self.config.capacity.delta_log_capacity
        rows = (base_row + np.arange(k * t)) % capacity
        self._claim_rows(rows, sess_rep)
        for i, s in enumerate(np.asarray(session_slots)):
            s = int(s)
            self._audit_rows.setdefault(s, []).extend(rows[i * t:(i + 1) * t].tolist())
            self._turns[s] = self._turns.get(s, 0) + t
            self._chain_seed[s] = chain[t - 1, i]
            self._frontier.setdefault(s, MerkleFrontier()).extend(digests_flat[i * t:(i + 1) * t])

    # ── join waves ───────────────────────────────────────────────────

    def enqueue_join(
        self, session_slot: int, agent_did: str, sigma_raw: float, trustworthy: bool = True,
        now: Optional[float] = None,
    ) -> int:
        """Stage one join; returns its queue entry, or -1 when the epoch is
        full (then nothing is staged and no row is claimed). Thread-safe.

        The join claims its agent row now (the free list's end first,
        then the cursor) and is a duplicate when its (session, agent)
        membership is already admitted or staged in this epoch; raises
        when the agent table is full.

        A degraded-mode policy sheds here (`DegradedModeRefusal`, or
        `SybilShedRefusal` below a targeted policy's sigma floor). `now`
        feeds only the admission damper's arrival window (default
        `self.now()`); it touches no table, so a replay ignores it. The
        record journals inside the staging lock, so intent seqs allocate
        in the order the host indices change, and a refused push cancels
        it (nothing was staged)."""
        damper = self.admission_damper
        if damper is not None:
            damper.note_join(self, float(sigma_raw), self.now() if now is None else now)
        self._shed_gate(float(sigma_raw))
        with self._enqueue_lock, self._journal(
            "enqueue_join", session_slot=int(session_slot), did=agent_did,
            sigma_raw=float(sigma_raw), trustworthy=bool(trustworthy),
        ) as txn:
            cap = self.agents.i32.shape[0]
            if self._free_agent_slots:
                agent_slot = self._free_agent_slots[-1]
            elif self._next_agent_slot < cap:
                agent_slot = self._next_agent_slot
            else:
                raise RuntimeError(f"agent table full ({cap}); raise config.capacity.max_agents")
            did = self.agent_ids.intern(agent_did)
            key = _mkey(session_slot, did)
            duplicate = key in self._members or key in self._staged_members
            q = self._queue.push(sigma_raw, agent_slot, session_slot, trustworthy)
            if q < 0:
                txn.cancel()
                return -1
            if self._free_agent_slots:
                self._free_agent_slots.pop()
            else:
                self._next_agent_slot += 1
            if not duplicate:
                self._staged_members.add(key)
            self._pending_rows[agent_slot] = (did, session_slot, duplicate)
        return q

    def flush_joins(self, now: float = 0.0, pad_to: Optional[int] = None) -> np.ndarray:
        """Admit every staged join as one wave; returns i8[n] status codes.

        Statuses come in harvest order (the queue's claim order), which
        concurrent producers may make differ from call order: correlate
        by agent slot, by `is_member`, or by `last_join_results`
        (membership key -> the best status of this flush).

        The wave is kernel B4 on CUDA (`kernels.wave.admission_block`,
        two-launch form: join waves share sessions; no contribution, so
        sigma_eff is sigma_raw), its plain version on the CPU, with the
        admitted and refused counters, the wave-size histogram and the
        `admission_wave` trace stamps. `pad_to` pads the wave to a fixed
        bucket: pad lanes ride duplicate=True (refused, no row written),
        and a valid mask keeps them out of the counters and the
        histogram; it raises below the staged count. Rejected rows return
        to the free list. The whole flush holds the staging lock.

        The fault-injection gate runs before the harvest (a raise leaves
        the queue intact, so a retry flushes the same wave); the flush
        journals as "flush_joins" with its `now` and `pad_to`."""
        self._predispatch("admission_wave")
        with self._enqueue_lock, self._journal("flush_joins", now=float(now), pad_to=pad_to):
            n, sigma, agent_slots, session_slots, trustworthy = self._queue.harvest()
            if n == 0:
                return np.zeros(0, np.int8)
            rows = [(int(slot),) + self._pending_rows.pop(int(slot)) for slot in agent_slots]
            dids = np.array([r[1] for r in rows], np.int32)
            duplicate = np.array([r[3] for r in rows], bool)
            valid = None
            if pad_to is not None:
                if pad_to < n:
                    raise ValueError(
                        f"flush_joins pad_to={pad_to} below the staged wave size {n}; "
                        "the serving scheduler must cap staging at the largest bucket"
                    )

                def pad_arr(arr, dtype, fill):
                    out = np.full((pad_to,), fill, dtype)
                    out[:n] = np.asarray(arr, dtype)
                    return out

                sigma = pad_arr(sigma, np.float32, 0.0)
                agent_slots = pad_arr(agent_slots, np.int32, 0)
                session_slots = pad_arr(session_slots, np.int32, 0)
                trustworthy = pad_arr(trustworthy, np.uint8, 0)
                dids = pad_arr(dids, np.int32, -1)
                duplicate = pad_arr(duplicate, bool, True)
                valid = np.arange(pad_to) < n
            dev = self.device

            def put(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            th = self.tracer.begin_wave(
                "admission_wave", sessions=np.unique(session_slots[:n]), lanes=n)
            # The reference's admission wave ranks with the default trust
            # thresholds, whatever the state's config says.
            with self.metrics.stage("admission_wave"):
                status, _, _ = _ADMIT(
                    self.agents, self.sessions, put(agent_slots), put(dids),
                    put(session_slots), put(sigma), None, 0.0, put(trustworthy.astype(bool)),
                    put(duplicate), now, self.config.rate_limit.ring_bursts,
                )
                b = len(agent_slots)
                tally_admission(self.metrics.table, status == ADMIT_OK, b,
                                None if valid is None else put(valid))
                if th is not None:
                    stamps = tracing.WaveStamps(th.ctx, "admission_wave")
                    stamps.begin("admission_wave", lane=b)
                    stamps.end("admission_wave", lane=b)
                    stamps.commit(self.tracer.table)
            self.tracer.end_wave(th, self.tracer.table)
            status = status.cpu().numpy()[:n]
            results: dict[int, int] = {}
            for (slot, did, sess, dup), st in zip(rows, status.tolist()):
                key = _mkey(sess, did)
                if not dup:
                    self._staged_members.discard(key)
                if st == ADMIT_OK:
                    self._members.add(key)
                    self._slot_of_member[(did, sess)] = slot
                else:
                    self._free_agent_slots.append(slot)
                prev = results.get(key)
                if prev is None or st < prev:
                    results[key] = st
            self.last_join_results = results
        return status

    def leave_agent(self, session_slot: int, agent_did: str) -> None:
        """Remove one member from its session: its row loses FLAG_ACTIVE,
        the session's count drops, the row returns to the free list, and
        the vouch edges and elevation grants that name the row are
        deactivated (the edges recorded for `pop_scrubbed_edges`). The
        membership key stays, so a rejoin is a duplicate; the agent's
        rows in other sessions are untouched. Holds the staging lock."""
        with self._enqueue_lock, self._journal(
            "leave_agent", session_slot=int(session_slot), did=agent_did
        ):
            row = self.agent_row(agent_did, session_slot)
            if row is None:
                raise ValueError(
                    f"{agent_did} holds no active device row in session slot {session_slot}")
            slot = row["slot"]
            flags = self.agents.i32[:, AI32_FLAGS]
            flags[slot] = flags[slot] & ~FLAG_ACTIVE
            self.sessions.i32[session_slot, SI32_NPART] -= 1
            did = int(self.agents.did[slot])
            if self._slot_of_member.get((did, session_slot)) == slot:
                del self._slot_of_member[(did, session_slot)]
            self._free_agent_slots.append(slot)
            voucher = self.vouches.voucher.cpu().numpy()
            vouchee = self.vouches.vouchee.cpu().numpy()
            dangling = self.vouches.active.cpu().numpy() & ((voucher == slot) | (vouchee == slot))
            rows = np.nonzero(dangling)[0]
            if len(rows):
                self.vouches.active[torch.from_numpy(rows).to(self.device)] = False
                self._free_edge_slots.extend(int(r) for r in rows)
                self._scrubbed_edges.extend(int(r) for r in rows)
            self._scrub_elevations_for_rows([slot])

    def _scrub_elevations_for_rows(self, agent_rows) -> None:
        """Deactivate the grants held by freed agent rows (`agent` -> -1,
        the row back on the elevation free list): left active, a grant
        would elevate whichever agent the recycled row serves next."""
        if not len(agent_rows):
            return
        e = self.elevations
        hit = e.active.cpu().numpy() & np.isin(e.agent.cpu().numpy(), np.asarray(agent_rows))
        rows = np.nonzero(hit)[0]
        if len(rows):
            idx = torch.from_numpy(rows).to(self.device)
            e.active[idx] = False
            e.agent[idx] = -1
            self._free_elev_slots.extend(int(r) for r in rows)

    def pop_scrubbed_edges(self) -> list[int]:
        """Drain the edge rows the GC scrubbed for lost endpoints."""
        out, self._scrubbed_edges = self._scrubbed_edges, []
        return out

    def to_device_time(self, absolute_ts: float) -> float:
        """Absolute unix seconds -> this state's epoch-relative time."""
        return absolute_ts - self._epoch_base

    # ── audit deltas ─────────────────────────────────────────────────

    def stage_delta(
        self,
        session_slot: int,
        agent_slot: int,
        ts: float = 0.0,
        change_words: Optional[np.ndarray] = None,
        digest_words: Optional[np.ndarray] = None,
    ) -> int:
        """Stage one audit delta; returns its turn number in the session.
        `change_words` (u32[<= 8]) go into the packed body; the recorded
        leaf is the chain digest computed at flush unless `digest_words`
        (u32[8]) pins an explicit leaf."""
        with self._journal(
            "stage_delta", session_slot=int(session_slot), agent_slot=int(agent_slot),
            ts=float(ts),
            change_words=None if change_words is None else np.asarray(change_words, np.uint32),
            digest_words=None if digest_words is None else np.asarray(digest_words, np.uint32),
        ):
            turn = self._turns.get(session_slot, 0)
            self._turns[session_slot] = turn + 1
            change = np.zeros(8, np.uint32)
            if change_words is not None:
                w = np.asarray(change_words, np.uint32).ravel()[:8]
                change[:len(w)] = w
            self._pending_deltas.append((
                session_slot, agent_slot, change, float(ts),
                None if digest_words is None else np.asarray(digest_words, np.uint32),
            ))
        return turn

    def flush_deltas(self) -> int:
        """Chain-hash every staged delta (B2 on CUDA), each session's lane
        chained from its running seed, and append them to the DeltaLog
        lane-major. Returns the record count."""
        if not self._pending_deltas:
            return 0
        with self._journal("flush_deltas", use_pallas=None):
            return self._flush_deltas_impl()

    def _flush_deltas_impl(self) -> int:
        staged = self._pending_deltas
        self._pending_deltas = []
        b = len(staged)
        sess_arr = np.array([r[0] for r in staged], np.int32)
        agent_arr = np.array([r[1] for r in staged], np.int32)
        change_arr = np.stack([r[2] for r in staged])
        ts_arr = np.array([r[3] for r in staged], np.float32)

        # Lane assignment (first-appearance order) and within-lane position.
        lane_of: dict[int, int] = {}
        lane_idx = np.zeros(b, np.int32)
        for i, sess in enumerate(sess_arr):
            lane_idx[i] = lane_of.setdefault(int(sess), len(lane_of))
        lanes = len(lane_of)
        n_per_lane = np.bincount(lane_idx, minlength=lanes)
        t_max = int(n_per_lane.max())
        order = np.argsort(lane_idx, kind="stable")
        rank_sorted = np.arange(b) - np.repeat(
            np.concatenate([[0], np.cumsum(n_per_lane)[:-1]]), n_per_lane
        )
        t_pos = np.zeros(b, np.int32)
        t_pos[order] = rank_sorted.astype(np.int32)

        base_turn_of_lane = np.zeros(lanes, np.int64)
        seeds = np.zeros((lanes, 8), np.uint32)
        sess_of_lane = np.zeros(lanes, np.int32)
        for sess, lane in lane_of.items():
            sess_of_lane[lane] = sess
            base_turn_of_lane[lane] = self._turns[sess] - int(n_per_lane[lane])
            seeds[lane] = self._chain_seed.get(sess, np.zeros(8, np.uint32))
        turn_arr = (base_turn_of_lane[lane_idx] + t_pos).astype(np.int32)

        packed = merkle_ops.pack_delta_bodies(sess_arr, turn_arr, agent_arr, change_arr, ts_arr)
        bodies = np.zeros((t_max, lanes, merkle_ops.BODY_WORDS), np.uint32)
        bodies[t_pos, lane_idx] = packed

        th = self.tracer.begin_wave("delta_chain", sessions=np.unique(sess_arr), lanes=b,
                                    device=False)
        dev = self.device
        with self.metrics.stage("delta_chain"):
            digests = u32.to_numpy_u32(merkle_ops.chain_digests(
                u32.from_numpy_u32(bodies, dev), u32.from_numpy_u32(seeds, dev)
            ))
        self.tracer.stamp_wave_host(th)
        self.tracer.end_wave(th)

        # Explicit leaf digests override the chain digest.
        for i, (_s, _a, _c, _t, digest) in enumerate(staged):
            if digest is not None:
                digests[t_pos[i], lane_idx[i]] = digest

        # Flatten lane-major and append in one op.
        flat = np.argsort(lane_idx * (t_max + 1) + t_pos, kind="stable")
        flat_digests = digests[t_pos[flat], lane_idx[flat]]
        packed_flat = packed[flat]
        base_row = self._delta_cursor
        capacity = self.delta_log.body.shape[0]
        rows = ((base_row + np.arange(b)) % capacity).astype(np.int64)
        self._claim_rows(rows, sess_arr[flat])
        offset = 0
        for lane in range(lanes):
            sess = int(sess_of_lane[lane])
            n_rows = int(n_per_lane[lane])
            self._audit_rows.setdefault(sess, []).extend(rows[offset:offset + n_rows].tolist())
            self._frontier.setdefault(sess, MerkleFrontier()).extend(
                flat_digests[offset:offset + n_rows]
            )
            offset += n_rows
            self._chain_seed[sess] = digests[n_rows - 1, lane]

        self.delta_log.append_batch(
            u32.from_numpy_u32(packed_flat, dev), u32.from_numpy_u32(flat_digests, dev),
            torch.from_numpy(sess_arr[flat]).to(dev), torch.from_numpy(turn_arr[flat]).to(dev),
        )
        self._delta_cursor += b
        return b

    def _claim_rows(self, rows: np.ndarray, owners: np.ndarray) -> None:
        """Transfer DeltaLog row ownership; evict recycled rows from the
        audit index of the sessions that owned them. Recycling a LIVE
        (not yet archived) session's rows is refused: its Merkle tree
        would silently lose leaves. Session states are read from the
        device only when a wrap recycles rows."""
        prior = self._row_session[rows]
        recycled = np.unique(prior[prior >= 0])
        if len(recycled):
            sess_state = self.sessions.i32[:, SI32_STATE].cpu().numpy()
            archived = SessionState.ARCHIVED.code
            live = [int(s) for s in recycled
                    if self._audit_rows.get(int(s)) and sess_state[int(s)] != archived]
            if live:
                raise RuntimeError(
                    f"delta log wrapped into live session slot(s) {live}; their audit "
                    "trails would lose leaves. Raise config.capacity.delta_log_capacity "
                    "or terminate sessions before their logs are overwritten."
                )
            doomed = set(rows.tolist())
            for sess in recycled:
                kept = self._audit_rows.get(int(sess))
                if kept:
                    self._audit_rows[int(sess)] = [r for r in kept if r not in doomed]
                # The wrap truncates the session's leaf set: its frontier and
                # packed-body cache no longer describe the surviving history.
                self._frontier.pop(int(sess), None)
                self._packed_bodies.pop(int(sess), None)
        self._row_session[rows] = owners

    def session_leaf_digests(self, session_slot: int) -> np.ndarray:
        """u32[T, 8] recorded leaf digests of a session, in turn order."""
        rows = self._audit_rows.get(session_slot, [])
        if not rows:
            return np.zeros((0, 8), np.uint32)
        idx = torch.tensor(rows, dtype=torch.int64, device=self.device)
        return u32.to_numpy_u32(self.delta_log.digest[idx])

    def session_packed_bodies(self, session_slot: int) -> np.ndarray:
        """u32[T, 16] packed bodies of the session's live history (turn
        order), through the per-(session, turn range) cache, which fills
        on first read and drops when the ring wraps over the session."""
        rows = self._audit_rows.get(session_slot, [])
        if not rows:
            return np.zeros((0, merkle_ops.BODY_WORDS), np.uint32)
        turns = self._turns.get(session_slot, 0)
        lo = turns - len(rows)
        entry = self._packed_bodies.get(session_slot)
        if entry is not None and entry[0] == lo and entry[1] == turns and entry[2].shape[0] == len(rows):
            return entry[2]
        idx = torch.tensor(rows, dtype=torch.int64, device=self.device)
        bodies = u32.to_numpy_u32(self.delta_log.body[idx])
        self._packed_bodies[session_slot] = (lo, turns, bodies)
        return bodies

    def verify_session_chain(self, session_slot: int) -> bool:
        """Re-hash one session's surviving chain against its recorded
        digests on the state's device. A full history verifies from the
        zero seed in one sweep (B2 on CUDA); a wrap-evicted prefix leaves
        the first surviving link unverifiable and the rest verify as
        links (B1 on CUDA)."""
        rows = self._audit_rows.get(session_slot, [])
        if not rows:
            return True
        if self._turns.get(session_slot, 0) == len(rows):
            ok = merkle_ops.verify_chain_digests_host(
                self.session_packed_bodies(session_slot)[:, None, :],
                self.session_leaf_digests(session_slot)[:, None, :],
                np.array([len(rows)], np.int32), self.device,
            )
            return bool(ok[0])
        rows_arr = np.asarray(rows, np.int64)
        prev = np.concatenate([rows_arr[:1], rows_arr[:-1]])
        use_seed = np.zeros(len(rows), bool)
        valid = np.ones(len(rows), bool)
        valid[0] = False  # evicted parent: the first surviving link is unverifiable
        ok = merkle_ops.verify_chain_links_host(
            self.delta_log.body, self.delta_log.digest, rows_arr, prev, use_seed, valid
        )
        return bool(ok.all())

    def session_frontier(self, session_slot: int) -> MerkleFrontier | None:
        """The session's live Merkle frontier (None when it recorded no
        deltas or a ring wrap recycled its history)."""
        return self._frontier.get(session_slot)

    # ── termination wave ─────────────────────────────────────────────

    def terminate_sessions(
        self,
        session_slots: Sequence[int],
        now: float = 0.0,
        pad_to: Optional[int] = None,
        pad_slot: Optional[int] = None,
    ) -> np.ndarray:
        """Terminate a wave of sessions; returns their u32[K, 8] Merkle roots.

        Roots fold from each session's frontier (O(log n) hashes); a
        session without a live frontier is recomputed from its recorded
        leaves through `ops.merkle.tree_roots_host` on the state's device,
        which also re-primes its frontier. Then one terminate wave
        (`ops.terminate.terminate_batch`) releases bonds, deactivates
        participants and archives the sessions. The deactivated rows
        return to the free list, and vouch edges that still name them
        are deactivated and their rows recycled. `pad_to` pads the wave
        with `pad_slot`, a memberless park session.

        Terminations are never shed: a degraded plane keeps draining live
        work. The fault-injection gate runs before any mutation; the wave
        journals as "terminate_sessions" with the padded slot list.
        """
        slots = [int(s) for s in session_slots]
        k = len(slots)
        if k == 0:
            return np.zeros((0, 8), np.uint32)
        if pad_to is not None and pad_to != k:
            if pad_to < k:
                raise ValueError(f"terminate pad_to={pad_to} below the wave size {k}")
            if pad_slot is None:
                raise ValueError(
                    "terminate pad_to requires pad_slot (the serving front door's park session)")
            slots = slots + [int(pad_slot)] * (pad_to - k)
        self._predispatch("terminate_wave")
        with self._journal("terminate_sessions", session_slots=slots, now=float(now),
                           use_pallas=None):
            return self._terminate_sessions_impl(slots, now)[:k]

    def _terminate_sessions_impl(self, slots: list, now: float) -> np.ndarray:
        k = len(slots)
        # Participants to reclaim, captured before the wave deactivates
        # them; the active-flag guard skips rows already reclaimed.
        did_col, sess_col, flags = (
            self.agents.i32[:, [AI32_DID, AI32_SESSION, AI32_FLAGS]].cpu().numpy().T)
        in_wave = np.isin(sess_col, np.array(slots))
        live = (flags & FLAG_ACTIVE) != 0
        reclaim = np.nonzero(in_wave & live)[0]
        roots_host = np.zeros((k, 8), np.uint32)
        missing: list[int] = []
        for i, s in enumerate(slots):
            rows = self._audit_rows.get(s, [])
            if not rows:
                continue
            fr = self._frontier.get(s)
            if fr is not None and fr.count == len(rows):
                roots_host[i] = fr.root_words()
            else:
                missing.append(i)
        if missing:
            counts = np.array([len(self._audit_rows[slots[i]]) for i in missing], np.int32)
            p = 1 << max(0, int(counts.max()) - 1).bit_length()
            leaves = np.zeros((len(missing), max(p, 1), 8), np.uint32)
            for j, i in enumerate(missing):
                recorded = self.session_leaf_digests(slots[i])
                leaves[j, :len(recorded)] = recorded
                self._frontier[slots[i]] = MerkleFrontier.from_leaf_digests(recorded)
            recomputed = merkle_ops.tree_roots_host(leaves, counts, self.device)
            for j, i in enumerate(missing):
                roots_host[i] = recomputed[j]

        slot_arr = np.array(slots, np.int32)
        th = self.tracer.begin_wave("terminate_wave", sessions=slots, lanes=k, device=False)
        with self.metrics.stage("terminate_wave"):
            _TERMINATE(
                self.agents, self.sessions, self.vouches,
                torch.from_numpy(slot_arr).to(self.device),
                u32.from_numpy_u32(roots_host, self.device),
                now, wave_range=_contiguous_range_host(slot_arr),
            )
        self.tracer.stamp_wave_host(th)
        self.tracer.end_wave(th)

        if len(reclaim):
            with self._enqueue_lock:
                for row in reclaim.tolist():
                    key = (int(did_col[row]), int(sess_col[row]))
                    if self._slot_of_member.get(key) == row:
                        del self._slot_of_member[key]
                    self._free_agent_slots.append(row)
            # Scrub dangling liability edges: a reclaimed row may still be
            # named by edges in other sessions; left active, the bond would
            # pass to whatever agent later reuses the row.
            gone = np.zeros((self.agents.i32.shape[0],), bool)
            gone[reclaim] = True
            voucher = self.vouches.voucher.cpu().numpy()
            vouchee = self.vouches.vouchee.cpu().numpy()
            dangling = self.vouches.active.cpu().numpy() & (
                ((voucher >= 0) & gone[np.clip(voucher, 0, None)])
                | ((vouchee >= 0) & gone[np.clip(vouchee, 0, None)])
            )
            rows = np.nonzero(dangling)[0]
            if len(rows):
                self.vouches.active[torch.from_numpy(rows).to(self.device)] = False
                self._free_edge_slots.extend(int(r) for r in rows)
                self._scrubbed_edges.extend(int(r) for r in rows)
            self._scrub_elevations_for_rows(reclaim)
        return roots_host

    # ── vouch edges ──────────────────────────────────────────────────

    def add_vouch(
        self,
        voucher_slot: int,
        vouchee_slot: int,
        session_slot: int,
        bond: float,
        bond_pct: float = 0.20,
        expiry: float = np.inf,
    ) -> int:
        """Insert one liability edge; returns the edge row (rows released
        by release_vouch / free_edge_rows are recycled, last in first)."""
        with self._journal(
            "add_vouch", voucher_slot=int(voucher_slot), vouchee_slot=int(vouchee_slot),
            session_slot=int(session_slot), bond=float(bond), bond_pct=float(bond_pct),
            expiry=float(expiry),
        ):
            if self._free_edge_slots:
                row = self._free_edge_slots.pop()
            elif self._next_edge_slot < self.vouches.voucher.shape[0]:
                row = self._next_edge_slot
                self._next_edge_slot += 1
            else:
                raise RuntimeError(
                    f"vouch table full ({self.vouches.voucher.shape[0]}); "
                    "raise config.capacity.max_vouch_edges"
                )
            v = self.vouches
            v.voucher[row] = int(voucher_slot)
            v.vouchee[row] = int(vouchee_slot)
            v.session[row] = int(session_slot)
            v.bond[row] = float(np.float32(bond))
            v.bond_pct[row] = float(np.float32(bond_pct))
            v.active[row] = True
            v.expiry[row] = float(np.float32(expiry))
        return row

    def release_vouch(self, edge_row: int) -> None:
        """Deactivate one liability edge and recycle its row."""
        with self._journal("release_vouch", edge_row=int(edge_row)):
            self.vouches.active[edge_row] = False
            self._free_edge_slots.append(edge_row)

    def free_edge_rows(self, edge_rows) -> None:
        """Recycle rows a device wave already deactivated (host-only
        bookkeeping, no device write; journaled so a replay recycles the
        same rows in the same order)."""
        rows = [int(r) for r in edge_rows]
        with self._journal("free_edge_rows", rows=rows):
            self._free_edge_slots.extend(rows)

    # ── the slash cascade ────────────────────────────────────────────

    def apply_slash(
        self,
        session_slot: int,
        vouchee_slot: int,
        risk_weight: float,
        now: float = 0.0,
    ) -> dict:
        """Run the slash cascade ON the device tables: blacklist the
        vouchee (sigma_eff -> 0, FLAG_BLACKLISTED), clip its vouchers with
        the joint-liability formula through the session's vouch graph
        (`ops.liability.slash_cascade`, kernel B8 on CUDA), release the
        consumed bonds and recompute the touched agents' rings from the
        new sigma. Returns {"slashed": [...], "clipped": [...]}, agent
        slots in ascending order."""
        self._predispatch("slash_cascade")
        with self._journal("apply_slash", session_slot=int(session_slot),
                           vouchee_slot=int(vouchee_slot), risk_weight=float(risk_weight),
                           now=float(now)):
            return self._apply_slash_impl(session_slot, vouchee_slot, risk_weight, now)

    def _apply_slash_impl(
        self, session_slot: int, vouchee_slot: int, risk_weight: float, now: float
    ) -> dict:
        n = self.agents.ring.shape[0]
        seeds = np.zeros(n, bool)
        seeds[vouchee_slot] = True
        th = self.tracer.begin_wave("slash_cascade", sessions=(session_slot,), lanes=n)
        with self.metrics.stage("slash_cascade"):
            result = _SLASH(
                self.vouches, self.agents.sigma_eff, torch.from_numpy(seeds).to(self.device),
                session_slot, risk_weight, now,
                metrics=self.metrics.table, trace=self.tracer.table,
                trace_ctx=th.ctx if th is not None else None,
            )
        self.tracer.end_wave(th, result.trace)
        touched = result.slashed | result.clipped
        self.agents.f32[:, AF32_SIGMA_EFF] = result.sigma
        self.agents.ring.copy_(torch.where(touched, compute_rings(result.sigma, False),
                                           self.agents.ring))
        flags = self.agents.i32[:, AI32_FLAGS]
        flags.copy_(torch.where(result.slashed, flags | FLAG_BLACKLISTED, flags))
        self.vouches.active.copy_(result.vouch.active)
        return {
            "slashed": torch.nonzero(result.slashed).flatten().tolist(),
            "clipped": torch.nonzero(result.clipped).flatten().tolist(),
        }

    def blacklist_rows(self, rows: Sequence[int]) -> None:
        """Agent-global blacklist: sigma_eff -> 0, FLAG_BLACKLISTED and the
        ring recomputed on the given rows (the rogue agent's rows in the
        sessions `apply_slash` did not cascade through)."""
        if not len(rows):
            return
        with self._journal("blacklist_rows", rows=[int(r) for r in rows]):
            idx = torch.from_numpy(np.asarray(rows, np.int64)).to(self.device)
            self.agents.f32[idx, AF32_SIGMA_EFF] = 0.0
            rings = compute_rings(self.agents.sigma_eff, False)
            self.agents.ring[idx] = rings[idx]
            flags = self.agents.i32[:, AI32_FLAGS]
            flags[idx] = flags[idx] | FLAG_BLACKLISTED

    # ── sagas ────────────────────────────────────────────────────────

    def create_saga(self, saga_id: str, session_slot: int, steps: Sequence[dict]) -> int:
        """Allocate a saga row; steps = [{has_undo, retries, timeout}, ...]."""
        max_steps = self.sagas.step_state.shape[1]
        if not steps:
            raise ValueError("saga needs at least one step")
        if len(steps) > max_steps:
            raise ValueError(f"saga has {len(steps)} steps; table holds {max_steps}")
        if self._next_saga_slot >= self.sagas.saga_state.shape[0]:
            raise RuntimeError(
                f"saga table full ({self.sagas.saga_state.shape[0]}); "
                "raise config.capacity.max_sagas"
            )
        with self._journal(
            "create_saga", saga_id=saga_id, session_slot=int(session_slot),
            steps=[{"retries": int(st.get("retries", 0)),
                    "has_undo": bool(st.get("has_undo", False)),
                    "timeout": float(st.get("timeout", 300.0))} for st in steps],
        ):
            slot = self._next_saga_slot
            self._next_saga_slot += 1
            self.saga_ids.intern(saga_id)
            retries = np.zeros(max_steps, np.int8)
            has_undo = np.zeros(max_steps, bool)
            timeout = np.full(max_steps, 300.0, np.float32)
            for i, st in enumerate(steps):
                retries[i] = st.get("retries", 0)
                has_undo[i] = st.get("has_undo", False)
                timeout[i] = st.get("timeout", 300.0)
            g, dev = self.sagas, self.device
            g.step_state[slot] = saga_ops.STEP_PENDING
            g.retries_left[slot] = torch.from_numpy(retries).to(dev)
            g.has_undo[slot] = torch.from_numpy(has_undo).to(dev)
            g.timeout[slot] = torch.from_numpy(timeout).to(dev)
            g.saga_state[slot] = saga_ops.SAGA_RUNNING
            g.session[slot] = int(session_slot)
            g.n_steps[slot] = len(steps)
            g.cursor[slot] = 0
        return slot

    def create_saga_from_dsl(self, definition, session_slot: int) -> int:
        """Materialize a parsed `saga.dsl.SagaDefinition` as a SagaTable
        row: step order, retry budgets, undo availability and timeouts
        come from the definition. Fan-out groups register their branch
        indices and policy, so the scheduler dispatches a whole group at
        once and settles it with one `ops.saga_ops.fanout_round` (branches
        do not retry)."""
        slot = self.create_saga(
            definition.saga_id,
            session_slot,
            [
                {"retries": step.retries, "has_undo": step.undo_api is not None,
                 "timeout": float(step.timeout)}
                for step in definition.steps
            ],
        )
        idx_of = {step.id: i for i, step in enumerate(definition.steps)}
        groups = [
            (fo.policy.code, sorted(idx_of[sid] for sid in fo.branch_step_ids))
            for fo in getattr(definition, "fan_outs", ())
        ]
        for _, idxs in groups:
            # The device schedule is cursor-ordered: a group's branches
            # must be consecutive, or the cursor's jump past the group
            # would skip interleaved sequential steps.
            if idxs != list(range(idxs[0], idxs[0] + len(idxs))):
                raise ValueError(
                    "fan-out branches must be consecutive steps in the "
                    f"definition for device scheduling; got indices {idxs}. "
                    "Reorder the steps so each group's branches are adjacent."
                )
        if groups:
            ordered = sorted(groups, key=lambda grp: grp[1][0])
            # Its own record: `create_saga` replays the table row, and the
            # group index is host state a replay must rebuild too.
            with self._journal("register_fanout_groups", slot=int(slot),
                               groups=[[policy, list(idxs)] for policy, idxs in ordered]):
                self._fanout_groups[slot] = ordered
        return slot

    # ── fan-out groups (device-scheduled) ────────────────────────────

    def _active_group(
        self, slot: int, cursor_host: np.ndarray, state_host: np.ndarray
    ) -> Optional[tuple[int, list[int]]]:
        """The fan-out group whose first branch is this saga's cursor, if
        the saga is RUNNING, from host copies of the cursor and state
        columns (one read per round)."""
        groups = self._fanout_groups.get(slot)
        if not groups:
            return None
        if int(state_host[slot]) != saga_ops.SAGA_RUNNING:
            return None
        cursor = int(cursor_host[slot])
        for policy, idxs in groups:
            if idxs[0] == cursor:
                return policy, idxs
        return None

    def fanout_dispatch(self) -> list[tuple[int, int]]:
        """(saga_slot, step_idx) pairs for every group front: the whole
        group's PENDING branches dispatch concurrently.

        A degraded-mode policy pauses the fan-out (an empty list): the
        branches stay PENDING until the mode exits, while cursor steps
        and compensations keep settling through `saga_round`."""
        policy = self.degraded_policy
        if policy is not None and policy.pause_saga_fanout:
            return []
        if not self._fanout_groups:
            return []
        step_state = self.sagas.step_state.cpu().numpy()
        cursor_host = self.sagas.cursor.cpu().numpy()
        state_host = self.sagas.saga_state.cpu().numpy()
        out = []
        for slot in self._fanout_groups:
            front = self._active_group(slot, cursor_host, state_host)
            if front is None:
                continue
            out.extend((slot, i) for i in front[1] if step_state[slot, i] == saga_ops.STEP_PENDING)
        return out

    def fanout_settle(self, outcomes: dict[tuple[int, int], bool]) -> None:
        """Book a round of fan-out branch outcomes in one device round
        (`ops.saga_ops.fanout_round`), the saga table updated in place."""
        if not outcomes:
            return
        with self._journal("fanout_settle", build=lambda: {
            "outcomes": [[int(s), int(i), bool(ok)] for (s, i), ok in outcomes.items()]}):
            self._fanout_settle_impl(outcomes)

    def _fanout_settle_impl(self, outcomes: dict[tuple[int, int], bool]) -> None:
        g_cap, m = self.sagas.step_state.shape
        group = np.zeros((g_cap, m), bool)
        active = np.zeros(g_cap, bool)
        success = np.zeros((g_cap, m), bool)
        policy = np.zeros(g_cap, np.int8)
        cursor_host = self.sagas.cursor.cpu().numpy()
        state_host = self.sagas.saga_state.cpu().numpy()
        for slot in {s for s, _ in outcomes}:
            front = self._active_group(slot, cursor_host, state_host)
            if front is None:
                continue
            pol, idxs = front
            active[slot] = True
            policy[slot] = pol
            group[slot, idxs] = True
        for (slot, idx), ok in outcomes.items():
            success[slot, idx] = ok

        def put(a):
            return torch.from_numpy(a).to(self.device)

        g = self.sagas
        step_state, saga_state, cursor = _FANOUT_ROUND(
            g.step_state, g.saga_state, g.cursor, put(group), put(active), put(success),
            put(policy))
        g.step_state.copy_(step_state)
        g.saga_state.copy_(saga_state)
        g.cursor.copy_(cursor)

    def saga_work(
        self, comp_budget: Optional[int] = None
    ) -> tuple[list[tuple[int, int]], list[tuple[int, int]]]:
        """(execute, compensate) work lists for the host executor shim.

        execute: (saga_slot, step_idx) cursor steps of RUNNING sagas
        (group fronts dispatch through `fanout_dispatch` instead).
        compensate: (saga_slot, step_idx) reverse-order targets of
        COMPENSATING sagas. `comp_budget` bounds the compensation list
        per round, a deterministic prefix: slots in ascending order, each
        saga's reverse step order kept. A backlog at or above
        `HV_COMP_BACKLOG_WARN` (16) emits the `comp_backlog` health event.
        """
        g = self._next_saga_slot
        if g == 0:
            return [], []
        saga_state = self.sagas.saga_state.cpu().numpy()[:g]
        step_state = self.sagas.step_state.cpu().numpy()[:g]
        cursor = self.sagas.cursor.cpu().numpy()[:g]
        n_steps = self.sagas.n_steps.cpu().numpy()[:g]

        execute = [
            (int(s), int(cursor[s]))
            for s in np.nonzero((saga_state == saga_ops.SAGA_RUNNING) & (cursor < n_steps))[0]
            if step_state[s, cursor[s]] == saga_ops.STEP_PENDING
            and self._active_group(int(s), cursor, saga_state) is None
        ]
        compensate = []
        for s in np.nonzero(saga_state == saga_ops.SAGA_COMPENSATING)[0]:
            committed = np.nonzero(step_state[s] == saga_ops.STEP_COMMITTED)[0]
            if len(committed):
                compensate.append((int(s), int(committed[-1])))
        backlog = len(compensate)
        if backlog >= _comp_backlog_warn():
            # The storm signal: a subscribed supervisor flips degraded
            # mode (the fan-out pauses, admissions shed) so the backlog
            # drains before new load piles on.
            self.health.emit_event("comp_backlog", {"backlog": backlog, "budget": comp_budget})
        if comp_budget is not None and backlog > comp_budget:
            compensate = compensate[: max(int(comp_budget), 0)]
        return execute, compensate

    def saga_round(
        self,
        exec_outcomes: Optional[dict[int, bool]] = None,
        undo_outcomes: Optional[dict[int, bool]] = None,
    ) -> None:
        """One scheduling round over the whole saga table
        (`ops.saga_ops.saga_table_tick`, kernel B7 on CUDA), in place.
        Only sagas present in the outcome dicts are booked; the others
        (e.g. fan-out group fronts settled by `fanout_settle` in the same
        round) are left untouched. The four outcome masks travel to the
        device as one packed byte per saga."""
        self._predispatch("saga_round")
        with self._journal("saga_round", build=lambda: {
            "exec": {int(k): bool(v) for k, v in (exec_outcomes or {}).items()},
            "undo": {int(k): bool(v) for k, v in (undo_outcomes or {}).items()},
        }):
            self._saga_round_impl(exec_outcomes, undo_outcomes)

    def _saga_round_impl(
        self,
        exec_outcomes: Optional[dict[int, bool]] = None,
        undo_outcomes: Optional[dict[int, bool]] = None,
    ) -> None:
        g_cap = self.sagas.saga_state.shape[0]
        exec_success = np.zeros(g_cap, bool)
        undo_success = np.zeros(g_cap, bool)
        exec_attempted = np.zeros(g_cap, bool)
        undo_attempted = np.zeros(g_cap, bool)
        for slot, ok in (exec_outcomes or {}).items():
            exec_success[slot] = ok
            exec_attempted[slot] = True
        for slot, ok in (undo_outcomes or {}).items():
            undo_success[slot] = ok
            undo_attempted[slot] = True
        outcomes = saga_ops.pack_outcomes(exec_success, undo_success, exec_attempted, undo_attempted)
        th = self.tracer.begin_wave("saga_round", lanes=g_cap)
        g = self.sagas
        with self.metrics.stage("saga_round"):
            *_, t_table = _SAGA_TICK(
                g.step_state, g.retries_left, g.has_undo, g.saga_state, g.n_steps, g.cursor,
                torch.from_numpy(outcomes).to(self.device),
                metrics=self.metrics.table, trace=self.tracer.table,
                trace_ctx=th.ctx if th is not None else None,
            )
        self.tracer.end_wave(th, t_table)

    def sagas_settled(self) -> bool:
        g = self._next_saga_slot
        if g == 0:
            return True
        return bool(saga_ops.saga_table_done(self.sagas.saga_state[:g], self.sagas.session[:g]).all())

    # ── isolation gates ──────────────────────────────────────────────

    def isolation_refusal(self, agent_slot: int, now: Optional[float] = None) -> Optional[str]:
        """Device-plane isolation gates for one agent row: a refusal reason
        when the LIVE row is quarantined or its circuit breaker is
        holding, else None. A retired row (FLAG_ACTIVE clear) gates
        nothing."""
        return _isolation_refusal_from(
            int(self.agents.flags[agent_slot]),
            float(self.agents.bd_breaker_until[agent_slot]),
            self.now() if now is None else now,
        )

    def isolation_gate(self):
        """The bulk form of `isolation_refusal`: reads the flag and
        breaker columns ONCE and returns a per-slot callable, valid for
        one scheduling round."""
        flags = self.agents.flags.cpu().numpy().copy()
        until = self.agents.bd_breaker_until.cpu().numpy().copy()
        now = self.now()

        def refusal(agent_slot: int) -> Optional[str]:
            return _isolation_refusal_from(int(flags[agent_slot]), float(until[agent_slot]), now)

        return refusal

    # ── security sweeps ──────────────────────────────────────────────

    def record_calls(
        self, agent_slots: Sequence[int], called_rings: Sequence[int],
        now: Optional[float] = None,
    ) -> None:
        """Record one action wave into the breach sliding window."""
        now = self.now() if now is None else now
        slots = np.asarray(agent_slots, np.int32)
        rings = np.asarray(called_rings, np.int8)
        with self._journal("record_calls", agent_slots=slots, called_rings=rings,
                           now=float(now)):
            dev = self.device
            new = _RECORD_CALLS(
                self.agents, torch.from_numpy(slots).to(dev), torch.from_numpy(rings).to(dev),
                now, self.config.breach)
            self.agents.bd_window.copy_(new.bd_window)

    def breach_sweep_tick(self, now: float) -> tuple[np.ndarray, np.ndarray]:
        """Run the breach analysis over every row; returns (severity i8[N],
        tripped bool[N])."""
        with self._journal("breach_sweep_tick", now=float(now)):
            with self.metrics.stage("breach_sweep"):
                result = _BREACH_SWEEP(self.agents, now, self.config.breach)
            self.agents.i32[:, AI32_FLAGS] = result.agents.flags
            self.agents.f32[:, AF32_BD_BREAKER_UNTIL] = result.agents.bd_breaker_until
        return result.severity.cpu().numpy(), result.tripped.cpu().numpy()

    def consume_rate(
        self, slots: Sequence[int], now: float, rings: Optional[Sequence[int]] = None,
    ) -> np.ndarray:
        """Refill every bucket to `now` and take one token per element of
        `slots`; returns bool[len(slots)] decisions. Duplicate slots
        settle in call order: the k-th call on one bucket passes iff the
        refilled level covers k tokens, then each bucket pays exactly
        its granted tokens. `rings` overrides the rows' rings (e.g. a
        live sudo grant rates the call at the elevated ring's budget; a
        slot given twice takes its last ring)."""
        with self._journal(
            "consume_rate", slots=np.asarray(slots, np.int32), now=float(now),
            rings=None if rings is None else np.asarray(rings, np.int8),
        ):
            return self._consume_rate_impl(slots, now, rings)

    def _consume_rate_impl(
        self, slots: Sequence[int], now: float, rings: Optional[Sequence[int]],
    ) -> np.ndarray:
        slots_arr = np.asarray(slots, np.int32)
        cfg, dev = self.config.rate_limit, self.device
        n = self.agents.ring.shape[0]

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        ring_vec = self.agents.ring
        if rings is not None:
            # The last ring given for a slot wins, in any order the device
            # would apply repeated writes.
            rev = slots_arr[::-1]
            uniq, first_rev = np.unique(rev, return_index=True)
            last = np.asarray(rings, np.int8)[len(slots_arr) - 1 - first_rev]
            ring_vec = ring_vec.clone()
            ring_vec[put(uniq.astype(np.int64))] = put(last)
        tokens, stamp = self.agents.rl_tokens, self.agents.rl_stamp
        idx = put(slots_arr.astype(np.int64))
        if np.unique(slots_arr).size == slots_arr.size:
            cost = torch.zeros((n,), dtype=torch.float32, device=dev)
            cost[idx] = 1.0
            decision = _RATE_CONSUME(tokens, stamp, ring_vec, now, cost, cfg)
            allowed = decision.allowed[idx].cpu().numpy()
        else:
            refilled = _RATE_CONSUME(tokens, stamp, ring_vec, now, 0.0,
                                          cfg).tokens.cpu().numpy()
            ordinal = np.zeros(len(slots_arr), np.int64)
            seen: dict[int, int] = {}
            for i, s in enumerate(slots_arr.tolist()):
                seen[s] = seen.get(s, 0) + 1
                ordinal[i] = seen[s]
            # int64 against f32: numpy compares both as float64.
            allowed = ordinal <= refilled[slots_arr]
            grants = np.zeros(n, np.float32)
            np.add.at(grants, slots_arr, allowed.astype(np.float32))
            decision = _RATE_CONSUME(tokens, stamp, ring_vec, now, put(grants), cfg)
        self.agents.f32[:, AF32_RL_TOKENS] = decision.tokens
        self.agents.f32[:, AF32_RL_STAMP] = decision.stamp
        return allowed

    def check_actions_wave(
        self, slots, required_rings, is_read_only, has_consensus, has_sre_witness,
        host_tripped, now: float, mesh=None,
    ) -> gateway_ops.GatewayResult:
        """Run B actions through the action gateway (`ops.gateway.
        check_actions`: breaker, quarantine, elevation-aware ring check,
        the rate settle, breach recording) as one wave on the state's
        tables, updated in place, with its counters and trace stamps. The
        lanes are padded to the next power of two with valid=False lanes,
        which touch nothing; out-of-range slots are refused first. The
        fault-injection gate runs before any mutation; the wave journals
        as "gateway_wave"."""
        self._predispatch("gateway_wave")
        self._check_action_slots(slots)
        if mesh is not None:
            raise NotImplementedError(
                "check_actions_wave(mesh=...): the sharded gateway arrives with the port's "
                "multi-device slice (ROADMAP A8)")
        with self._journal(
            "gateway_wave", slots=np.asarray(slots, np.int32),
            required_rings=np.asarray(required_rings, np.int8),
            is_read_only=np.asarray(is_read_only, bool),
            has_consensus=np.asarray(has_consensus, bool),
            has_sre_witness=np.asarray(has_sre_witness, bool),
            host_tripped=np.asarray(host_tripped, bool), now=float(now),
        ):
            return self._check_actions_wave_local(slots, required_rings, is_read_only,
                                                  has_consensus, has_sre_witness,
                                                  host_tripped, now)

    def _check_actions_wave_local(
        self, slots, required_rings, is_read_only, has_consensus, has_sre_witness,
        host_tripped, now: float,
    ) -> gateway_ops.GatewayResult:
        act = self._normalize_actions({
            "slots": slots, "required_rings": required_rings, "is_read_only": is_read_only,
            "has_consensus": has_consensus, "has_sre_witness": has_sre_witness,
            "host_tripped": host_tripped})
        lanes = tuple(torch.from_numpy(np.ascontiguousarray(c)).to(self.device)
                      for c in self._pad_gateway_lanes(act))
        b = len(act["slots"])
        th = self.tracer.begin_wave("gateway_wave", lanes=b)
        with self.metrics.stage("gateway_wave"):
            result = _GATEWAY(
                self.agents, self.elevations, *lanes[:6], now, valid=lanes[6],
                breach=self.config.breach, rate_limit=self.config.rate_limit,
                trust=self.config.trust, metrics=self.metrics.table, trace=self.tracer.table,
                trace_ctx=th.ctx if th is not None else None,
            )
        self.tracer.end_wave(th, result.trace)
        return self._gateway_result_from_lanes(result, result.agents, b)

    # ── elevations ───────────────────────────────────────────────────

    def grant_elevation(
        self, agent_slot: int, granted_ring: int, now: float,
        ttl_seconds: Optional[float] = None,
    ) -> int:
        """Grant a sudo-with-TTL elevation; returns its elevation row. The
        grant must be more privileged than the agent's ring, ring 0 is
        never granted, and the TTL is capped at `max_ttl_seconds`. The
        deadline is now + ttl in double precision, stored as f32."""
        cfg = self.config.elevation
        if granted_ring == 0:
            raise ValueError("Ring 0 cannot be granted by elevation")
        current = int(self.agents.ring[agent_slot])
        if granted_ring >= current:
            raise ValueError(
                f"elevation must be more privileged: agent holds ring {current}, "
                f"requested {granted_ring}")
        ttl = min(ttl_seconds if ttl_seconds is not None else cfg.default_ttl_seconds,
                  cfg.max_ttl_seconds)
        with self._journal(
            "grant_elevation", agent_slot=int(agent_slot), granted_ring=int(granted_ring),
            now=float(now), ttl_seconds=None if ttl_seconds is None else float(ttl_seconds),
        ):
            if self._free_elev_slots:
                row = self._free_elev_slots.pop()
            elif self._next_elev_slot < self.elevations.agent.shape[0]:
                row = self._next_elev_slot
                self._next_elev_slot += 1
            else:
                raise RuntimeError("elevation table full")
            e = self.elevations
            e.agent[row] = int(agent_slot)
            e.granted_ring[row] = int(granted_ring)
            e.expires_at[row] = float(np.float32(now + ttl))
            e.active[row] = True
        return row

    def revoke_elevation(self, row: int, expected_agent: Optional[int] = None) -> None:
        """Revoke a grant before its expiry; the row recycles. A row whose
        grant already lapsed is a no-op; `expected_agent` refuses a stale
        handle whose row a later grant now holds."""
        holder = int(self.elevations.agent[row])
        if expected_agent is not None and holder != expected_agent:
            raise ValueError(
                f"elevation row {row} now belongs to agent {holder}, not {expected_agent}: "
                "the grant already expired and the row was recycled")
        if not bool(self.elevations.active[row]):
            return
        with self._journal("revoke_elevation", row=int(row),
                           expected_agent=None if expected_agent is None else int(expected_agent)):
            self.elevations.active[row] = False
            self.elevations.agent[row] = -1
            self._free_elev_slots.append(int(row))

    def elevation_tick(self, now: float) -> int:
        """Expire every lapsed grant (its row freed, `agent` -1); returns
        how many expired."""
        with self._journal("elevation_tick", now=float(now)):
            table, expired = _ELEV_EXPIRY(self.elevations, now)
            self.elevations.active.copy_(table.active)
            rows = np.nonzero(expired.cpu().numpy())[0]
            if len(rows):
                self.elevations.agent[torch.from_numpy(rows).to(self.device)] = -1
                self._free_elev_slots.extend(int(r) for r in rows)
        return len(rows)

    def effective_rings(self, now: float) -> np.ndarray:
        """i8[N] assigned rings with the active grants applied."""
        return _EFF_RINGS(self.agents.ring, self.elevations, now).cpu().numpy()

    # ── quarantine and row writes ────────────────────────────────────

    def quarantine_rows(self, rows, now: float, duration: Optional[float] = None) -> None:
        """Put agent rows into read-only isolation until now + duration
        (default `config.quarantine`); a row already held keeps its
        deadline."""
        if duration is None:
            duration = self.config.quarantine.default_duration_seconds
        with self._journal("quarantine_rows", build=lambda: {
            "rows": [int(r) for r in np.asarray(rows, np.int32)], "now": float(now),
            "duration": float(duration)}):
            enter = torch.zeros(self.agents.flags.shape, dtype=torch.bool, device=self.device)
            enter[torch.from_numpy(np.asarray(rows, np.int64)).to(self.device)] = True
            new = _QUAR_ENTER(self.agents, enter, now, float(duration))
            self.agents.i32[:, AI32_FLAGS] = new.flags
            self.agents.f32[:, AF32_QUARANTINE_UNTIL] = new.quarantine_until

    def quarantine_tick(self, now: float) -> list[int]:
        """Release every quarantine strictly past its deadline; returns the
        released rows."""
        with self._journal("quarantine_tick", now=float(now)):
            sweep = _QUAR_SWEEP(self.agents, now)
            self.agents.i32[:, AI32_FLAGS] = sweep.agents.flags
        return [int(r) for r in np.nonzero(sweep.released.cpu().numpy())[0]]

    def quarantined_mask(self) -> np.ndarray:
        """bool[N]: rows in read-only isolation."""
        return (self.agents.flags.cpu().numpy() & FLAG_QUARANTINED) != 0

    def set_agent_risk(self, slot: int, risk: float) -> None:
        """Write a membership row's liability risk score."""
        with self._journal("set_agent_risk", slot=int(slot), risk=float(risk)):
            self.agents.f32[slot, AF32_RISK] = float(np.float32(risk))

    def set_agent_ring(self, slot: int, ring: int, now: float) -> None:
        """Reassign a row's ring; its token bucket is recreated full at the
        new ring's burst, stamped `now`. Holds the staging lock."""
        burst = float(np.float32(self.config.rate_limit.ring_bursts[int(ring)]))
        with self._enqueue_lock, self._journal("set_agent_ring", slot=int(slot), ring=int(ring),
                                               now=float(now)):
            self.agents.ring[slot] = int(ring)
            self.agents.f32[slot, AF32_RL_TOKENS] = burst
            self.agents.f32[slot, AF32_RL_STAMP] = float(np.float32(now))

    # ── metrics drain ────────────────────────────────────────────────

    def metrics_snapshot(self) -> metrics_plane.MetricsSnapshot:
        """Refresh the occupancy gauges on the device, then drain the
        plane: between waves, never inside one.

        The fault injector's drain gate comes first (a corrupt drain is
        device loss from the host's point of view). The compile totals and
        the tables' static bytes and capacities publish on the host plane
        (tensor metadata, no transfer). Unless the last dispatch was a
        facade wave and nothing mutated since (`_gauges_fresh`), the
        gauges are recomputed over every table into a copy of the gauge
        column, which is drained without being written back. The drain
        itself waits on the device once (`Metrics.snapshot`); then the
        high-water marks and capacity warnings, the integrity plane's
        detection and the history's sample read the snapshot it
        returned."""
        inj = self.fault_injector
        if inj is not None:
            inj.on_drain("metrics_drain")
        health_plane.publish_compile_counters(self.metrics)
        # The roofline observatory: resolve a bounded batch of pending
        # counts and join the models with the host-plane stage walls into
        # the hv_roofline_* gauges (host only). Shift events (a recount
        # whose modeled bytes moved past the tolerance) fan through the
        # health plane onto the bus.
        roofline_plane.publish(self.metrics)
        self._roofline_event_seq, shifts = roofline_plane.registry().events_since(
            self._roofline_event_seq)
        for shift in shifts:
            self.health.emit_event("roofline_shift", shift)
        self.health.publish_footprints(self.health_tables())
        refresh = None
        if not self._gauges_fresh:
            def refresh(table):
                view = dataclasses.replace(table, gauges=table.gauges.clone())
                _UPDATE_GAUGES(
                    view, self.agents, self.sessions, self.vouches, self.sagas,
                    self.elevations, self.delta_log, self.event_log, self.tracer.table,
                )
                return view
        snap = self.metrics.snapshot(refresh=refresh)
        self.health.update_occupancy(snap)
        if self.integrity is not None:
            self.integrity.observe_snapshot(snap)
        self.history.sample_snapshot(snap, now=self._hindsight_now())
        return snap

    def metrics_prometheus(self) -> str:
        """Prometheus text exposition of the merged metrics plane. With a
        serving front door attached, the attribution plane's exemplar
        COMMENT lines ride along (`# EXEMPLAR ...`: each populated latency
        bucket names its latest ticket's CausalTraceId and its wave's
        trace id)."""
        text = self.metrics_snapshot().to_prometheus()
        serving = self.serving
        if serving is not None and getattr(serving, "attribution", None):
            lines = serving.attribution.exemplar_lines()
            if lines:
                text += "\n".join(lines) + "\n"
        return text

    # ── health plane ─────────────────────────────────────────────────

    def health_tables(self) -> dict:
        """Named tables for the footprint protocol (the occupancy set plus
        the static metrics and trace rings)."""
        tables = {
            "agents": self.agents,
            "sessions": self.sessions,
            "vouches": self.vouches,
            "sagas": self.sagas,
            "elevations": self.elevations,
            "delta_log": self.delta_log,
            "event_log": self.event_log,
            "metrics": self.metrics.table,
        }
        if self.tracer.table is not None:
            tables["trace_log"] = self.tracer.table
        return tables

    def health_summary(self) -> dict:
        """One drain's worth of watchdog state, occupancy, compile totals
        and per-stage latency quantiles, with the integrity, serving, SLO
        and hindsight panels. `backend` is the torch device type of the
        tables."""
        snap = self.metrics_snapshot()
        stages = {
            stage: {"n": n, "p50_us": round(p50, 1), "p99_us": round(p99, 1)}
            for stage, n, (p50, p99) in metrics_plane.iter_stage_quantiles(snap, (0.5, 0.99))
        }
        monitor = self.health.summary(snap)
        return {
            "status": "ok",
            "backend": self.device.type,
            "uptime_s": monitor["uptime_s"],
            "watchdog": monitor["watchdog"],
            "occupancy": monitor["occupancy"],
            "compiles": health_plane.compile_summary(last=8),
            "stages": stages,
            "integrity": self.integrity_summary(),
            "serving": self.serving_summary(),
            "slo": self.slo_summary(),
            "incidents": self.incidents.summary(),
            "history": {
                "samples": self.history.samples_total,
                "evictions": self.history.evictions_total,
                "points_retained": self.history.points_retained(),
            },
        }

    def memory_summary(self) -> dict:
        """Per-table device bytes, capacities, live rows, high-water marks
        and occupancy."""
        snap = self.metrics_snapshot()
        occupancy = self.health.occupancy_summary(snap)
        return {
            "hbm_total_bytes": health_plane.hbm_total_bytes(
                {name: t.footprint() for name, t in self.health_tables().items()}
            ),
            "warn_threshold": occupancy["warn_threshold"],
            "warnings_fired": occupancy["warnings_fired"],
            "recent_warnings": occupancy["recent_warnings"],
            "tables": occupancy["tables"],
        }

    def compile_summary(self) -> dict:
        """The process-global compile watch's payload."""
        return health_plane.compile_summary()

    def roofline_summary(self, join_phases: bool = True) -> dict:
        """The roofline observatory in one poll: each program's modeled
        bytes and operations (every counted bucket), the modeled-vs-
        measured table, the per-phase byte model joined with the measured
        wave-phase shares, the live-buffer peak against the tables'
        footprints, the headroom ranking and the floor block.

        Resolves every pending count and, with `join_phases`, refreshes the
        phase shares from the trace ring (one drain of it, the cost
        `slo_summary`'s callers pay); the clean-path drain never does."""
        tracer = self.tracer if join_phases and self.tracer.enabled else None
        out = roofline_plane.summary(self.metrics, tracer=tracer)
        if not out.get("enabled"):
            return out
        out["backend"] = self.device.type
        footprints = {name: t.footprint() for name, t in self.health_tables().items()}
        out["hbm"]["tables_total_bytes"] = health_plane.hbm_total_bytes(footprints)
        return out

    def serving_summary(self) -> dict:
        """Queue depths and backpressure, shed accounting by reason,
        deadline misses, wave cadence and the bucket set; the bare plane
        state when no `serving.FrontDoor` is attached."""
        if self.serving is not None:
            return self.serving.summary()
        return {"enabled": False}

    def slo_summary(self) -> dict:
        """Per-class burn-rate states, objectives, the alert log, the
        critical-path decomposition quantiles and the live Retry-After
        hints, all host-plane (no device read)."""
        serving = self.serving
        if serving is None or getattr(serving, "slo", None) is None:
            return {"enabled": False}
        return {
            "enabled": True,
            **serving.slo.summary(),
            "attribution": serving.attribution.summary(),
            "retry_after_live_s": {
                q: serving.retry_after_for(q) for q in serving._queues
            },
        }

    # ── hindsight plane (retained history + incidents) ───────────────

    def _hindsight_now(self) -> float:
        """History and incident timestamps: the virtual-clock override
        when one is set, `now()` otherwise."""
        if self.hindsight_clock is not None:
            return float(self.hindsight_clock())
        return self.now()

    def _incident_wal_block(self, trigger: dict) -> dict:
        """The bundle's recovery pointer: the WAL watermark and the last
        checkpoint — what a postmortem replays from."""
        journal = self.journal
        sup = self.resilience
        ckpt = getattr(sup, "last_checkpoint", None) if sup is not None else None
        return {
            "wal_seq": getattr(journal, "last_seq", None) if journal is not None else None,
            "restored_wal_seq": self._restored_wal_seq,
            "checkpoint": (
                {"path": ckpt.get("path"), "step": ckpt.get("step"),
                 "wal_seq": ckpt.get("wal_seq")}
                if ckpt else None
            ),
        }

    def _incident_trace_block(self, trigger: dict) -> dict:
        """The bundle's trace fragment: the trigger's causal trace id and
        the flight recorder's recent waves."""
        return {"trace_id": trigger.get("trace_id"), "flight": self.flight_summary()}

    def incidents_summary(self) -> dict:
        return self.incidents.summary()

    def incident_bundle(self, incident_id: str) -> Optional[dict]:
        """One captured bundle by content address (None = unknown)."""
        return self.incidents.get(incident_id)

    def history_query(
        self, series: Optional[str] = None, start: Optional[float] = None,
        end: Optional[float] = None, tier: int = 0,
    ) -> dict:
        """Without `series`, the history plane's summary and its
        conservation witness; with one, the retained points of that
        series and tier clipped to [start, end] on the caller's clock."""
        if series is None:
            out = self.history.summary()
            out["conservation"] = self.history.verify_conservation()["ok"]
            return out
        return {
            "series": series,
            "tier": int(tier),
            "points": self.history.query(series, start, end, int(tier)),
        }

    # ── trace drain ──────────────────────────────────────────────────

    def session_trace(self, session_slot: int) -> list:
        """The flight recorder's spans of every wave that touched this
        session slot (one read of the ring, outside every wave). The
        newest wave's `delta_chain` span (else its root) carries the
        session's newest DeltaLog records: turn and digest head, from one
        read of the touched rows of `delta_log.turn` and `.digest`."""
        spans = self.tracer.session_spans(session_slot)
        rows = self._audit_rows.get(session_slot, [])
        if spans and rows:
            newest = rows[-16:]  # the newest records; keep payloads small
            idx = torch.tensor(newest, dtype=torch.int64, device=self.device)
            turn_host, head_host = torch.stack(
                [self.delta_log.turn[idx], self.delta_log.digest[idx, 0]]).cpu().numpy()
            head_host = head_host.view(np.uint32)
            root = spans[-1]
            target = next((sp for sp in root.walk() if sp.stage == "delta_chain"), root)
            target.events.extend(
                {
                    "name": "audit.delta_recorded",
                    "session_slot": session_slot,
                    "log_row": int(r),
                    "turn": int(turn_host[i]),
                    "digest_head": f"{int(head_host[i]):08x}",
                }
                for i, r in enumerate(newest)
            )
        return spans

    def flight_summary(self) -> dict:
        """The flight recorder's state and its recent waves."""
        return self.tracer.flight_summary()

    # ── views ────────────────────────────────────────────────────────

    def session_slot_of(self, session_id: str) -> Optional[int]:
        """The table slot of a session id (None if unknown): the last row
        whose sid column holds its handle."""
        sid = self.session_ids.lookup(session_id)
        if sid < 0:
            return None
        hits = np.nonzero(self.sessions.sid.cpu().numpy() == sid)[0]
        return int(hits[-1]) if len(hits) else None

    def is_member(self, session_slot: int, agent_did: str) -> bool:
        """Was this agent admitted into the session (by any flush or wave)?"""
        did = self.agent_ids.lookup(agent_did)
        return did >= 0 and _mkey(session_slot, did) in self._members

    def participant_count(self, session_slot: int) -> int:
        return int(self.sessions.n_participants[session_slot])

    def _live_rows_of(self, did: int) -> np.ndarray:
        """The live agent rows holding `did`, by a scan of the table."""
        did_col, flags = self.agents.i32[:, [AI32_DID, AI32_FLAGS]].cpu().numpy().T
        return np.nonzero((did_col == did) & ((flags & FLAG_ACTIVE) != 0))[0]

    def _row_view(self, i: int) -> dict:
        return {"slot": int(i), "session": int(self.agents.session[i]),
                "sigma_eff": float(self.agents.sigma_eff[i]), "ring": int(self.agents.ring[i])}

    def agent_row(self, agent_did: str, session_slot: Optional[int] = None) -> Optional[dict]:
        """The agent's live device row, one per (agent, session).

        With `session_slot`, that membership's row (None if the agent is
        not live there), from the `_slot_of_member` cache, else a scan
        whose hit fills the cache (only live rows match: a reclaimed row
        keeps its last did and session until reuse). Without, the agent's
        most recently joined live row across sessions."""
        did = self.agent_ids.lookup(agent_did)
        if did < 0:
            return None
        if session_slot is not None:
            i = self._slot_of_member.get((did, session_slot))
            if i is None:
                hits = self._live_rows_of(did)
                hits = hits[self.agents.session.cpu().numpy()[hits] == session_slot]
                if len(hits) == 0:
                    return None
                i = int(hits[-1])
                with self._enqueue_lock:
                    self._slot_of_member[(did, session_slot)] = i
        else:
            hits = self._live_rows_of(did)
            if len(hits) == 0:
                return None
            i = int(hits[np.argmax(self.agents.joined_at.cpu().numpy()[hits])])
        return self._row_view(i)

    def agent_rows(self, agent_did: str) -> list[dict]:
        """All live device rows of an agent, one per session membership, in
        join order (by joined_at: slot order lies once rows recycle)."""
        did = self.agent_ids.lookup(agent_did)
        if did < 0:
            return []
        hits = self._live_rows_of(did)
        hits = hits[np.argsort(self.agents.joined_at.cpu().numpy()[hits], kind="stable")]
        return [self._row_view(i) for i in hits]
