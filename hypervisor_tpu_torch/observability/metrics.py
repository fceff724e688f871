"""The metrics table's layout: the reference registry's row indices.

`hypervisor_tpu.observability.metrics` registers every counter, gauge and
histogram in one declaration order, and a row's index is its position
among its kind. This module copies the handles the device waves write
(same names, same indices): the counters declared first, the sanitizer's
counters and gauges, the occupancy gauges the wave's epilogue refreshes
(`update_gauges`) and one histogram, with the table's row counts; the
rest of the registry ports with the observability plane.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MetricHandle:
    """One registered metric: its name and its row in the table."""

    name: str
    index: int


#: The device-written counters, in the reference's declaration order.
_COUNTER_NAMES = (
    "hv_governance_wave_ticks_total",
    "hv_admission_admitted_total",
    "hv_admission_refused_total",
    "hv_sessions_archived_total",
    "hv_bonds_released_total",
    "hv_saga_steps_committed_total",
    "hv_saga_steps_failed_total",
    "hv_gateway_actions_allowed_total",
    "hv_gateway_actions_denied_total",
    "hv_liability_slashed_total",
    "hv_liability_clipped_total",
    "hv_events_mirrored_total",
)
COUNTERS = tuple(MetricHandle(n, i) for i, n in enumerate(_COUNTER_NAMES))
(
    WAVE_TICKS,
    ADMITTED,
    REFUSED,
    SESSIONS_ARCHIVED,
    BONDS_RELEASED,
    SAGA_STEPS_COMMITTED,
    SAGA_STEPS_FAILED,
    GATEWAY_ALLOWED,
    GATEWAY_DENIED,
    SLASHED,
    CLIPPED,
    EVENTS_MIRRORED,
) = COUNTERS

#: Counters the resilience plane books on the host plane (`HostCounters`):
#: the supervisor's retry ladder (rows kept for ROADMAP A4), the state's
#: shed gate and crash recovery's replay.
DISPATCH_RETRIES = MetricHandle("hv_dispatch_retries_total", 18)
DISPATCH_FAILURES = MetricHandle("hv_dispatch_failures_total", 19)
DEGRADED_ENTRIES = MetricHandle("hv_degraded_entries_total", 20)
ADMISSIONS_SHED = MetricHandle("hv_admissions_shed_total", 21)
WAL_REPLAYED_OPS = MetricHandle("hv_wal_replayed_ops_total", 22)
ADMISSIONS_DAMPED = MetricHandle("hv_admissions_damped_total", 23)
#: Counters the facade books on the host plane (`HostCounters`).
COLLUSION_FINDINGS = MetricHandle("hv_collusion_findings_total", 24)
CASCADE_DEDUPED = MetricHandle("hv_slash_cascade_deduped_total", 25)

#: The sanitizer's counters (`integrity.invariants.book_sanitizer_metrics`).
INTEGRITY_CHECKS = MetricHandle("hv_integrity_checks_total", 50)
INTEGRITY_VIOLATIONS = MetricHandle("hv_integrity_violations_total", 51)

#: Occupancy gauges, in the reference's declaration order: active agent
#: rows per ring 0..3, then the agent, quarantine, breaker, session and
#: edge counts.
RING_AGENTS = tuple(MetricHandle("hv_agents_in_ring", r) for r in range(4))
AGENTS_ACTIVE = MetricHandle("hv_agent_rows_active", 4)
QUARANTINED = MetricHandle("hv_agents_quarantined", 5)
BREAKER_TRIPPED = MetricHandle("hv_agents_breaker_tripped", 6)
SESSIONS_LIVE = MetricHandle("hv_sessions_live", 7)
VOUCH_EDGES_ACTIVE = MetricHandle("hv_vouch_edges_active", 8)
#: The sanitizer's gauges: violating rows, and restore-class rows, at the
#: last pass.
INTEGRITY_VIOLATION_ROWS = MetricHandle("hv_integrity_violation_rows", 20)
INTEGRITY_UNREPAIRABLE_ROWS = MetricHandle("hv_integrity_unrepairable_rows", 21)
#: Live rows per device table or ring (the `table` label).
TABLE_LIVE_ROWS = {
    name: MetricHandle("hv_table_live_rows", 22 + i)
    for i, name in enumerate(("agents", "sessions", "vouches", "sagas", "elevations",
                              "delta_log", "event_log", "trace_log"))
}

#: Row counts of the full reference registry (counters, gauges, histograms).
N_COUNTERS = 92
N_GAUGES = 189
N_HISTOGRAMS = 34

#: Lanes per dispatched admission/governance wave; it follows the 13
#: per-stage latency histograms in the reference's declaration order.
WAVE_LANES = MetricHandle("hv_wave_lanes", 13)

#: Shared histogram upper bounds, 2^0 .. 2^24 (+Inf implied).
DEFAULT_BUCKET_BOUNDS_US: tuple[float, ...] = tuple(float(1 << k) for k in range(25))


class HostCounters:
    """The host plane's counter rows (the reference's `Metrics.inc`):
    tallies from paths that already run on the host, in the device
    counters' row layout, int64 (no wrap). The drain that merges both
    planes ports with the rest of the metrics plane."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters = np.zeros(N_COUNTERS, np.int64)

    def inc(self, handle: MetricHandle, n: int = 1) -> None:
        with self._lock:
            self.counters[handle.index] += n


# ── the occupancy gauges (the wave's epilogue) ───────────────────────


def update_gauges(
    metrics, agents, sessions, vouches, sagas=None, elevations=None, delta_log=None,
    event_log=None, trace_log=None,
) -> None:
    """Recompute the occupancy gauges from the state tables, IN PLACE: the
    governance wave's epilogue, over whole columns. Active agents per
    ring, active, quarantined and breaker-tripped agents, live sessions
    (HANDSHAKING or ACTIVE), active edges, and each table's live rows (a
    log's cursor, capped at its capacity). Rows of the optional tables
    left out keep their last value."""
    from hypervisor_tpu_torch.models import SessionState
    from hypervisor_tpu_torch.ops import tally
    from hypervisor_tpu_torch.tables.metrics import gauge_set_many
    from hypervisor_tpu_torch.tables.state import (
        FLAG_ACTIVE,
        FLAG_BREAKER_TRIPPED,
        FLAG_QUARANTINED,
    )

    flags = agents.flags
    active = (flags & FLAG_ACTIVE) != 0
    agent_counts = tally.count_true(
        *(active & (agents.ring == r) for r in range(4)),
        active,
        active & ((flags & FLAG_QUARANTINED) != 0),
        active & ((flags & FLAG_BREAKER_TRIPPED) != 0),
        agents.did >= 0,
    )
    state = sessions.state
    sess_live = (sessions.sid >= 0) & (
        (state == SessionState.HANDSHAKING.code) | (state == SessionState.ACTIVE.code))
    sess_counts = tally.count_true(sess_live, sessions.sid >= 0)
    vouch_active = tally.count_true_1d(vouches.active)
    indices = [h.index for h in RING_AGENTS] + [
        AGENTS_ACTIVE.index, QUARANTINED.index, BREAKER_TRIPPED.index, SESSIONS_LIVE.index,
        VOUCH_EDGES_ACTIVE.index, TABLE_LIVE_ROWS["agents"].index,
        TABLE_LIVE_ROWS["sessions"].index, TABLE_LIVE_ROWS["vouches"].index,
    ]
    values = [agent_counts[r] for r in range(4)] + [
        agent_counts[4], agent_counts[5], agent_counts[6], sess_counts[0], vouch_active,
        agent_counts[7], sess_counts[1], vouch_active,
    ]
    if sagas is not None:
        indices.append(TABLE_LIVE_ROWS["sagas"].index)
        values.append(tally.count_true_1d(sagas.session >= 0))
    if elevations is not None:
        indices.append(TABLE_LIVE_ROWS["elevations"].index)
        values.append(tally.count_true_1d(elevations.active))
    for name, log in (("delta_log", delta_log), ("event_log", event_log),
                      ("trace_log", trace_log)):
        if log is not None:
            indices.append(TABLE_LIVE_ROWS[name].index)
            values.append(torch.clamp(log.cursor, max=log.capacity_rows))
    gauge_set_many(metrics, indices, values)


def apply_occupancy_gauges(metrics, gauges, has_elevs, has_delta, has_trace) -> None:
    """Write a fixed-slot occupancy vector into the rows `update_gauges`
    refreshes, IN PLACE: ring 0-3 agents, active, quarantined, breaker-
    tripped, sessions live, vouch edges, then live rows for agents,
    sessions, vouches, sagas, elevations, delta log, event log and trace
    log (the reference's `EPILOGUE_GAUGES` order). The reference's armed
    epilogue books its kernel's vector through this rule."""
    from hypervisor_tpu_torch.tables.metrics import gauge_set_many

    indices = [h.index for h in RING_AGENTS] + [
        AGENTS_ACTIVE.index, QUARANTINED.index, BREAKER_TRIPPED.index, SESSIONS_LIVE.index,
        VOUCH_EDGES_ACTIVE.index, TABLE_LIVE_ROWS["agents"].index,
        TABLE_LIVE_ROWS["sessions"].index, TABLE_LIVE_ROWS["vouches"].index,
        TABLE_LIVE_ROWS["sagas"].index,
    ]
    values = [gauges[i] for i in range(13)]
    for present, name, slot in ((has_elevs, "elevations", 13), (has_delta, "delta_log", 14),
                                (True, "event_log", 15), (has_trace, "trace_log", 16)):
        if present:
            indices.append(TABLE_LIVE_ROWS[name].index)
            values.append(gauges[slot])
    gauge_set_many(metrics, indices, values)
