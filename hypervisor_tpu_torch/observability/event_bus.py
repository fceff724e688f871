"""Structured event plane: columnar host store + typed pub/sub taps.

Capability parity with reference `observability/event_bus.py:108-219`
(40 typed events across 8 categories, frozen records carrying causal
trace + parent ids, indexed queries, wildcard subscription, per-type
counts) — but the store is *columnar*, matching the device `EventLog`
ring buffer (`tables/logs.py`) it feeds: every emit interns the session
and agent strings to dense handles and appends one row of int codes to
parallel arrays. Indices are posting lists of row numbers per (axis,
handle) key; queries intersect row sets with integer compares and only
materialize `HypervisorEvent` values for surviving rows. `device_rows()`
hands the int columns straight to `EventLog.append_batch`, so a host bus
and a device log fed from the same traffic agree row-for-row.
"""

from __future__ import annotations

import enum
import uuid
from array import array
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Callable, Optional

from hypervisor_tpu_torch.observability.causal_trace import device_key_of
from hypervisor_tpu_torch.tables.intern import InternTable
from hypervisor_tpu_torch.utils.clock import utc_now


class EventType(str, enum.Enum):
    # Session lifecycle
    SESSION_CREATED = "session.created"
    SESSION_JOINED = "session.joined"
    SESSION_ACTIVATED = "session.activated"
    SESSION_TERMINATED = "session.terminated"
    SESSION_ARCHIVED = "session.archived"
    # Ring transitions
    RING_ASSIGNED = "ring.assigned"
    RING_ELEVATED = "ring.elevated"
    RING_DEMOTED = "ring.demoted"
    RING_ELEVATION_EXPIRED = "ring.elevation_expired"
    RING_BREACH_DETECTED = "ring.breach_detected"
    # Liability
    VOUCH_CREATED = "liability.vouch_created"
    VOUCH_RELEASED = "liability.vouch_released"
    SLASH_EXECUTED = "liability.slash_executed"
    FAULT_ATTRIBUTED = "liability.fault_attributed"
    QUARANTINE_ENTERED = "liability.quarantine_entered"
    QUARANTINE_RELEASED = "liability.quarantine_released"
    # Saga
    SAGA_CREATED = "saga.created"
    SAGA_STEP_STARTED = "saga.step_started"
    SAGA_STEP_COMMITTED = "saga.step_committed"
    SAGA_STEP_FAILED = "saga.step_failed"
    SAGA_COMPENSATING = "saga.compensating"
    SAGA_COMPLETED = "saga.completed"
    SAGA_ESCALATED = "saga.escalated"
    SAGA_FANOUT_STARTED = "saga.fanout_started"
    SAGA_FANOUT_RESOLVED = "saga.fanout_resolved"
    SAGA_CHECKPOINT_SAVED = "saga.checkpoint_saved"
    # VFS / session writes
    VFS_WRITE = "vfs.write"
    VFS_DELETE = "vfs.delete"
    VFS_SNAPSHOT = "vfs.snapshot"
    VFS_RESTORE = "vfs.restore"
    VFS_CONFLICT = "vfs.conflict"
    # Security
    RATE_LIMITED = "security.rate_limited"
    AGENT_KILLED = "security.agent_killed"
    SAGA_HANDOFF = "security.saga_handoff"
    IDENTITY_VERIFIED = "security.identity_verified"
    # Audit
    AUDIT_DELTA_CAPTURED = "audit.delta_captured"
    AUDIT_COMMITTED = "audit.committed"
    AUDIT_GC_COLLECTED = "audit.gc_collected"
    # Verification
    BEHAVIOR_DRIFT = "verification.behavior_drift"
    HISTORY_VERIFIED = "verification.history_verified"
    # Health plane (APPEND ONLY: codes are the device-log wire format)
    WAVE_STRAGGLER = "health.wave_straggler"
    CAPACITY_WARNING = "health.capacity_warning"
    RECOMPILE = "health.recompile"
    # Resilience plane (APPEND ONLY, same wire-format rule)
    DEGRADED_ENTERED = "resilience.degraded_entered"
    DEGRADED_EXITED = "resilience.degraded_exited"
    DISPATCH_RETRY = "resilience.dispatch_retry"
    WAL_REPLAYED = "resilience.wal_replayed"
    # Integrity plane (APPEND ONLY, same wire-format rule)
    INTEGRITY_VIOLATION = "integrity.violation"
    SCRUB_MISMATCH = "integrity.scrub_mismatch"
    ROW_QUARANTINED = "integrity.row_quarantined"
    STATE_RESTORED = "integrity.state_restored"

    # Adversarial governance plane (append-only, like every block above):
    # seeded scenario lifecycle + the hardening detections it drives.
    SCENARIO_STARTED = "adversarial.scenario_started"
    SCENARIO_SCORED = "adversarial.scenario_scored"
    SYBIL_DAMPED = "adversarial.sybil_damped"
    COLLUSION_DETECTED = "adversarial.collusion_detected"

    # SLO burn-rate plane (append-only, like every block above): the
    # latency observatory's multi-window alerts (`observability.slo`),
    # facade-bridged from the health fan-out like the resilience plane.
    SLO_BURN_RATE_WARNING = "slo.burn_rate_warning"
    SLO_BURN_RATE_CRITICAL = "slo.burn_rate_critical"
    SLO_RECOVERED = "slo.recovered"

    # Roofline observatory (append-only, like every block above): a
    # recapture of the SAME (program, signature) whose modeled HBM
    # bytes moved past HV_ROOFLINE_SHIFT_TOL — the live fusion-
    # regression / donation-miss canary (`observability.roofline`),
    # facade-bridged from the health fan-out like the planes above.
    ROOFLINE_BYTES_SHIFT = "roofline.bytes_shift"

    # Autopilot decision plane (append-only, like every block above):
    # each applied knob delta and its post-hoc outcome attribution
    # (`autopilot.DecisionLedger`), facade-bridged from the health
    # fan-out like the planes above. Payloads carry the input-signal
    # digest, the rule that fired, the before->after knob values, and
    # the decision's deterministic CausalTraceId (the trace-plane join).
    AUTOPILOT_DECISION = "autopilot.decision"
    AUTOPILOT_OUTCOME = "autopilot.outcome"

    # Fleet observatory (append-only, like every block above): the
    # heartbeat/lease plane's liveness transitions (`fleet.registry.
    # FleetRegistry`), facade-bridged from the health fan-out like the
    # planes above. alive -> suspected -> dead with hysteresis; the
    # payloads carry the lease seq + caller-clock timestamp so the
    # transition log replays to a bit-identical digest — push0's
    # detect half of detect-and-reassign.
    FLEET_WORKER_JOINED = "fleet.worker_joined"
    FLEET_WORKER_SUSPECTED = "fleet.worker_suspected"
    FLEET_WORKER_DEAD = "fleet.worker_dead"
    FLEET_WORKER_RECOVERED = "fleet.worker_recovered"

    # Hindsight plane (append-only, like every block above): the
    # black-box recorder's lifecycle (`observability.incidents.
    # IncidentRecorder`), facade-bridged from the health fan-out like
    # the planes above. CAPTURED carries the content-addressed incident
    # id (sha256 over rule-input fields only) + class + trigger kind;
    # EVICTED is the bounded retention ring counting its losses loudly.
    INCIDENT_CAPTURED = "incident.captured"
    INCIDENT_EVICTED = "incident.evicted"

    # Failover plane (append-only, like every block above): the
    # reassignment half of detect-and-reassign (`fleet.failover`),
    # facade-bridged from the health fan-out like the planes above.
    # OWNERSHIP_CHANGED carries the worker's new tenant set + fencing
    # epoch (the OwnershipMap's replayable assign); WORKER_FENCED is
    # the zombie hazard closing — a stale-epoch worker's WAL appends
    # and checkpoint publications now refuse loudly; TENANTS_REASSIGNED
    # is one record per completed reassignment state machine, carrying
    # the dead worker, the tenant -> survivor map, and the new epoch.
    FLEET_OWNERSHIP_CHANGED = "fleet.ownership_changed"
    FLEET_WORKER_FENCED = "fleet.worker_fenced"
    FLEET_TENANTS_REASSIGNED = "fleet.tenants_reassigned"

    # Rebalance plane (append-only, like every block above): PLANNED
    # zero-loss migration on the failover splice path
    # (`fleet.rebalance`). REBALANCE_PLANNED is the journaled intent
    # (tenant, source -> dest, bumped epoch); TENANT_MIGRATED is the
    # atomic commit at which ownership changes hands; MIGRATION_ABORTED
    # records an intent abandoned before commit (crash boundary or
    # failover winning the race) — ownership never moved.
    FLEET_REBALANCE_PLANNED = "fleet.rebalance_planned"
    FLEET_TENANT_MIGRATED = "fleet.tenant_migrated"
    FLEET_MIGRATION_ABORTED = "fleet.migration_aborted"

    @property
    def code(self) -> int:
        """int32 column code for the device event log."""
        return _EVENT_CODES[self]


_EVENT_CODES: dict[EventType, int] = {t: i for i, t in enumerate(EventType)}
_CODE_TO_TYPE: tuple[EventType, ...] = tuple(EventType)

#: Tap-table key meaning "every event type".
_ANY = -1


@dataclass(frozen=True)
class HypervisorEvent:
    """Immutable structured event (field set is the wire contract)."""

    event_id: str = field(default_factory=lambda: uuid.uuid4().hex[:16])
    event_type: EventType = EventType.SESSION_CREATED
    timestamp: datetime = field(default_factory=utc_now)
    session_id: Optional[str] = None
    agent_did: Optional[str] = None
    causal_trace_id: Optional[str] = None
    parent_event_id: Optional[str] = None
    payload: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "event_id": self.event_id,
            "event_type": self.event_type.value,
            "timestamp": self.timestamp.isoformat(),
            "session_id": self.session_id,
            "agent_did": self.agent_did,
            "causal_trace_id": self.causal_trace_id,
            "parent_event_id": self.parent_event_id,
            "payload": self.payload,
        }


EventHandler = Callable[[HypervisorEvent], None]


class HypervisorEventBus:
    """Columnar append-only event store with posting-list indices.

    Row r of the store is described by `_codes[r]` (EventType code),
    `_sessions[r]` / `_agents[r]` (interned handles, -1 = absent),
    `_traces[r]` (u32 hash of the causal trace id), `_stamps[r]` (epoch
    seconds) — plus `_rows[r]`, the materialized event value owning the
    payload. This is deliberately the same row shape as the device
    `EventLog`, which `device_rows()` feeds.
    """

    def __init__(self) -> None:
        self._codes = array("i")
        self._sessions = array("i")
        self._agents = array("i")
        self._traces = array("L")
        self._spans = array("L")
        self._stamps = array("d")
        self._rows: list[HypervisorEvent] = []
        self._session_ids = InternTable()
        self._agent_ids = InternTable()
        # (axis, handle) -> sorted row numbers; axes: "t" type, "s" session,
        # "a" agent.  Posting lists hold ints, never event objects.
        self._postings: dict[tuple[str, int], array] = {}
        # EventType code (or _ANY) -> handlers.
        self._taps: dict[int, list[EventHandler]] = {}

    # ── ingest ───────────────────────────────────────────────────────────

    def emit(self, event: HypervisorEvent) -> None:
        """Intern, append one row to every column, then fire taps."""
        row = len(self._rows)
        code = event.event_type.code
        session = (
            self._session_ids.intern(event.session_id) if event.session_id else -1
        )
        agent = self._agent_ids.intern(event.agent_did) if event.agent_did else -1

        # The (trace, span) device-key word pair — `causal_trace.
        # device_key_of` is the ONE hashing rule all planes share, so
        # bus rows, device EventLog rows, and TraceLog stamps fed from
        # the same traffic join on identical u32 pairs.
        trace_w, span_w = device_key_of(event.causal_trace_id)
        self._codes.append(code)
        self._sessions.append(session)
        self._agents.append(agent)
        self._traces.append(trace_w)
        self._spans.append(span_w)
        self._stamps.append(event.timestamp.timestamp())
        self._rows.append(event)

        self._post("t", code, row)
        if session >= 0:
            self._post("s", session, row)
        if agent >= 0:
            self._post("a", agent, row)

        for tap in self._taps.get(code, ()):
            tap(event)
        for tap in self._taps.get(_ANY, ()):
            tap(event)

    def _post(self, axis: str, handle: int, row: int) -> None:
        key = (axis, handle)
        rows = self._postings.get(key)
        if rows is None:
            self._postings[key] = rows = array("i")
        rows.append(row)

    # ── pub/sub ──────────────────────────────────────────────────────────

    def subscribe(
        self,
        event_type: Optional[EventType] = None,
        handler: Optional[EventHandler] = None,
    ) -> None:
        """Register a tap; event_type=None taps every event."""
        if handler is None:
            return
        key = _ANY if event_type is None else event_type.code
        self._taps.setdefault(key, []).append(handler)

    # ── queries (posting-list driven) ────────────────────────────────────

    def _rows_for(self, axis: str, handle: int) -> array:
        return self._postings.get((axis, handle), array("i"))

    def query_by_type(self, event_type: EventType) -> list[HypervisorEvent]:
        return [self._rows[r] for r in self._rows_for("t", event_type.code)]

    def query_by_session(self, session_id: str) -> list[HypervisorEvent]:
        handle = self._session_ids.lookup(session_id)
        return [self._rows[r] for r in self._rows_for("s", handle)]

    def query_by_agent(self, agent_did: str) -> list[HypervisorEvent]:
        handle = self._agent_ids.lookup(agent_did)
        return [self._rows[r] for r in self._rows_for("a", handle)]

    def query_by_time_range(
        self, start: datetime, end: Optional[datetime] = None
    ) -> list[HypervisorEvent]:
        lo = start.timestamp()
        hi = (end or utc_now()).timestamp()
        return [
            self._rows[r]
            for r, t in enumerate(self._stamps)
            if lo <= t <= hi
        ]

    def query(
        self,
        event_type: Optional[EventType] = None,
        session_id: Optional[str] = None,
        agent_did: Optional[str] = None,
        limit: Optional[int] = None,
    ) -> list[HypervisorEvent]:
        """Multi-filter query: narrowest posting list, then column compares."""
        candidates: list[array] = []
        want_session = want_agent = -2  # -2 = unconstrained; -1 = never matches
        if event_type is not None:
            candidates.append(self._rows_for("t", event_type.code))
        if session_id is not None:
            want_session = self._session_ids.lookup(session_id)
            candidates.append(self._rows_for("s", want_session))
        if agent_did is not None:
            want_agent = self._agent_ids.lookup(agent_did)
            candidates.append(self._rows_for("a", want_agent))

        if candidates:
            seed = min(candidates, key=len)
            rows = (
                r
                for r in seed
                if (want_session == -2 or self._sessions[r] == want_session)
                and (want_agent == -2 or self._agents[r] == want_agent)
                and (event_type is None or self._codes[r] == event_type.code)
            )
        else:
            rows = iter(range(len(self._rows)))

        matched = [self._rows[r] for r in rows]
        return matched[-limit:] if limit is not None else matched

    # ── aggregates ───────────────────────────────────────────────────────

    @property
    def event_count(self) -> int:
        return len(self._rows)

    @property
    def all_events(self) -> list[HypervisorEvent]:
        return list(self._rows)

    def type_counts(self) -> dict[str, int]:
        return {
            _CODE_TO_TYPE[handle].value: len(rows)
            for (axis, handle), rows in self._postings.items()
            if axis == "t"
        }

    def clear(self) -> None:
        """Empty the store and indices; subscriptions stay wired."""
        taps = self._taps
        self.__dict__.update(HypervisorEventBus().__dict__)
        self._taps = taps

    # ── device bridge ────────────────────────────────────────────────────

    def device_rows(self, since_row: int = 0):
        """Int columns for rows >= since_row, shaped for EventLog.append_batch.

        Returns (codes i32[B], sessions i32[B], agents i32[B], traces u32[B],
        stamps f32[B], spans u32[B]) as numpy arrays; pass them straight to
        `tables.logs.EventLog.append_batch` to mirror host traffic on device.
        """
        import numpy as np

        sl = slice(since_row, len(self._rows))
        return (
            np.asarray(self._codes[sl], np.int32),
            np.asarray(self._sessions[sl], np.int32),
            np.asarray(self._agents[sl], np.int32),
            np.asarray(self._traces[sl], np.uint32),
            np.asarray(self._stamps[sl], np.float32),
            np.asarray(self._spans[sl], np.uint32),
        )
