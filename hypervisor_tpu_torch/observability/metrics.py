"""Host registry + drain for the device-resident metrics plane.

The torch counterpart of `hypervisor_tpu_torch.observability.metrics`.
`tables.metrics.MetricsTable` is the device side: counters, gauges and
histogram buckets the waves add into IN PLACE, as tensor arithmetic.
This module is everything around it:

  * the typed registry mapping metric NAMES (+ Prometheus labels) to row
    handles, in the reference's declaration order, so every row index,
    name and label set is the reference's;
  * the shared log-spaced bucket layout (powers of two, 1 µs .. ~16.8 s,
    then +Inf) used by every latency histogram on both planes;
  * the `Metrics` host object: one device table, a host-plane mirror for
    samples that exist only on the host (wall-clock stage latencies,
    tallies from paths that already read back, the facade's and the
    resilience plane's counters), and the drain: `snapshot()` copies the
    table's four columns to the host behind ONE wait on the device,
    outside every wave, merges both planes, and carries u32 counter
    wraps so exposition stays monotonic;
  * Prometheus text exposition (`to_prometheus`) and bucket-quantile
    math (`MetricsSnapshot.quantile`).

A stage timer (`Metrics.stage`) measures the host's enqueue of a
dispatch, as the reference's does: it never waits on the device. It is a
span of the recorder (`profiling.stage_scope`) whose duration is also
the histogram's sample; while a profiler records, its `hv.<stage>`
range labels the profile, so a profile and the latency histograms
correlate line for line.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Iterator, Mapping, Optional

import numpy as np
import torch

from hypervisor_tpu_torch.observability import profiling

#: Shared histogram upper bounds, in microseconds: 2^0 .. 2^24 µs
#: (1 µs .. ~16.8 s), +Inf implied as the final overflow bucket.
#: Log-spaced so one layout covers a 0.13 ms admission wave and a
#: multi-second sharded compile-miss with ~7% worst-case quantile error
#: per octave interpolation.
DEFAULT_BUCKET_BOUNDS_US: tuple[float, ...] = tuple(
    float(1 << k) for k in range(25)
)

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

COUNTER, GAUGE, HISTOGRAM = "counter", "gauge", "histogram"


def escape_label_value(value) -> str:
    """Prometheus exposition-spec label-value escaping — the ONE rule
    every exposition writer shares (handle labels, the tenant-arena
    `tenant="<id>"` merge, the fleet drain's `worker="<id>"` merge):
    backslash, double quote, and newline must escape or a hostile id
    breaks the scrape line (and can forge neighboring labels)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


@dataclasses.dataclass(frozen=True)
class MetricHandle:
    """One registered metric: its table row + exposition metadata."""

    name: str
    kind: str
    index: int
    help: str = ""
    labels: tuple[tuple[str, str], ...] = ()

    def label_str(self) -> str:
        if not self.labels:
            return ""
        inner = ",".join(
            f'{k}="{escape_label_value(v)}"' for k, v in self.labels
        )
        return "{" + inner + "}"


class MetricsRegistry:
    """Name -> handle registry; freezes into a MetricsTable layout.

    Handles are dense row indices per kind, so the device table is
    exactly [C]/[G]/[H, NB] with no holes. Registration order is
    exposition order. A (name, labels) pair registers once; metrics
    sharing a name must share a kind (Prometheus series semantics).
    """

    def __init__(
        self, bounds: tuple[float, ...] = DEFAULT_BUCKET_BOUNDS_US
    ) -> None:
        self.bounds = tuple(float(b) for b in bounds)
        self._handles: list[MetricHandle] = []
        self._by_key: dict[tuple, MetricHandle] = {}
        self._kind_of_name: dict[str, str] = {}
        self._next = {COUNTER: 0, GAUGE: 0, HISTOGRAM: 0}

    def _register(
        self, kind: str, name: str, help: str, labels: Mapping[str, str]
    ) -> MetricHandle:
        label_items = tuple(sorted((labels or {}).items()))
        key = (name, label_items)
        if key in self._by_key:
            existing = self._by_key[key]
            if existing.kind != kind:
                raise ValueError(
                    f"{name} already registered as {existing.kind}"
                )
            return existing
        if self._kind_of_name.setdefault(name, kind) != kind:
            raise ValueError(
                f"{name} series already registered as "
                f"{self._kind_of_name[name]}"
            )
        handle = MetricHandle(
            name=name,
            kind=kind,
            index=self._next[kind],
            help=help,
            labels=label_items,
        )
        self._next[kind] += 1
        self._handles.append(handle)
        self._by_key[key] = handle
        return handle

    def counter(self, name: str, help: str = "", **labels) -> MetricHandle:
        return self._register(COUNTER, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> MetricHandle:
        return self._register(GAUGE, name, help, labels)

    def histogram(self, name: str, help: str = "", **labels) -> MetricHandle:
        return self._register(HISTOGRAM, name, help, labels)

    @property
    def handles(self) -> tuple[MetricHandle, ...]:
        return tuple(self._handles)

    def counts(self) -> tuple[int, int, int]:
        return (
            self._next[COUNTER],
            self._next[GAUGE],
            self._next[HISTOGRAM],
        )

    def create_table(self, device: str | torch.device = "cuda"):
        from hypervisor_tpu_torch.tables.metrics import MetricsTable

        c, g, h = self.counts()
        return MetricsTable.create(device, c, g, h, self.bounds)


# ── the hypervisor schema ────────────────────────────────────────────
# One module-level registry: handle indices are compile-time constants
# inside the jitted waves (ops reference `HANDLE.index` directly), and
# every HypervisorState's table shares this layout.

REGISTRY = MetricsRegistry()

# Wave/tick counters (device-written inside the jitted programs).
WAVE_TICKS = REGISTRY.counter(
    "hv_governance_wave_ticks_total", "full-pipeline waves dispatched"
)
ADMITTED = REGISTRY.counter(
    "hv_admission_admitted_total", "join lanes admitted (ADMIT_OK)"
)
REFUSED = REGISTRY.counter(
    "hv_admission_refused_total", "join lanes refused (any ADMIT_* error)"
)
SESSIONS_ARCHIVED = REGISTRY.counter(
    "hv_sessions_archived_total", "sessions archived by terminate waves"
)
BONDS_RELEASED = REGISTRY.counter(
    "hv_bonds_released_total", "vouch bonds released at terminate"
)
SAGA_STEPS_COMMITTED = REGISTRY.counter(
    "hv_saga_steps_committed_total", "saga step executions committed"
)
SAGA_STEPS_FAILED = REGISTRY.counter(
    "hv_saga_steps_failed_total", "saga step executions failed (post-retry)"
)
GATEWAY_ALLOWED = REGISTRY.counter(
    "hv_gateway_actions_allowed_total", "per-action gateway verdicts: allowed"
)
GATEWAY_DENIED = REGISTRY.counter(
    "hv_gateway_actions_denied_total", "per-action gateway verdicts: denied"
)
SLASHED = REGISTRY.counter(
    "hv_liability_slashed_total", "agents blacklisted by slash cascades"
)
CLIPPED = REGISTRY.counter(
    "hv_liability_clipped_total", "vouchers clipped by slash cascades"
)
EVENTS_MIRRORED = REGISTRY.counter(
    "hv_events_mirrored_total",
    "host bus events mirrored into the device EventLog",
)

# Occupancy gauges (device-computed at snapshot, `update_gauges`).
RING_AGENTS = tuple(
    REGISTRY.gauge(
        "hv_agents_in_ring", "active agent rows per execution ring",
        ring=str(r),
    )
    for r in range(4)
)
AGENTS_ACTIVE = REGISTRY.gauge(
    "hv_agent_rows_active", "live agent rows (FLAG_ACTIVE)"
)
QUARANTINED = REGISTRY.gauge(
    "hv_agents_quarantined", "agent rows in read-only isolation"
)
BREAKER_TRIPPED = REGISTRY.gauge(
    "hv_agents_breaker_tripped", "agent rows with a tripped circuit breaker"
)
SESSIONS_LIVE = REGISTRY.gauge(
    "hv_sessions_live", "sessions in HANDSHAKING or ACTIVE"
)
VOUCH_EDGES_ACTIVE = REGISTRY.gauge(
    "hv_vouch_edges_active", "live liability edges"
)

#: Stage names (shared with the `hv.<stage>` profiler spans): each gets
#: a latency histogram, host-bracketed around the dispatched wave.
STAGES: tuple[str, ...] = (
    "governance_wave",
    "governance_wave_sharded",
    "admission_wave",
    "saga_round",
    "slash_cascade",
    "gateway_wave",
    "gateway_wave_sharded",
    "breach_sweep",
    "delta_chain",
    "terminate_wave",
    "reconcile_wave_sessions",
    # Tenant-dense serving (round 16): the arena's ONE-dispatch-for-T
    # batched programs, bracketed on the ARENA's host metrics plane
    # (per-tenant planes carry the per-tenant series; a T-tenant wall
    # is not any one tenant's latency). Appended — STAGES is an
    # append-only registry like the EventType codes (hvlint HVA004).
    "tenant_governance_wave",
    "tenant_sessions_create",
)
STAGE_LATENCY: dict[str, MetricHandle] = {
    stage: REGISTRY.histogram(
        "hv_stage_latency_us",
        "host wall-clock of one dispatched device wave, microseconds",
        stage=stage,
    )
    for stage in STAGES
}
#: Device-written size histogram: lanes per governance/admission wave.
WAVE_LANES = REGISTRY.histogram(
    "hv_wave_lanes", "join lanes per dispatched admission/governance wave"
)

# ── health plane (compile telemetry / occupancy / watchdog) ──────────
# Compile counters are HOST-MIRRORED ABSOLUTE TOTALS: the compile watch
# (`observability.health`) owns the authoritative count — it is
# process-global, like the module-level jit caches it watches — and the
# drain publishes it via `Metrics.counter_set` so exposition stays
# monotonic without double counting across deployments in one process.
COMPILES = REGISTRY.counter(
    "hv_compiles_total", "XLA compiles of watched wave entry points"
)
RECOMPILES = REGISTRY.counter(
    "hv_recompiles_total",
    "unplanned recompiles (a watched program re-traced after first use)",
)
DONATION_FAILURES = REGISTRY.counter(
    "hv_donation_failures_total",
    "compiles whose donated buffers were not usable (donation fell back "
    "to copies)",
)
COMPILE_WALL_MS = REGISTRY.counter(
    "hv_compile_wall_ms_total",
    "cumulative wall-clock spent compiling watched programs, ms",
)
WAVE_STRAGGLERS = REGISTRY.counter(
    "hv_wave_stragglers_total",
    "dispatched waves that overran their watchdog deadline (p99 x k)",
)
CAPACITY_WARNINGS = REGISTRY.counter(
    "hv_capacity_warnings_total",
    "table/ring occupancy crossings above the configured warn threshold",
)

# ── resilience plane (supervisor / WAL / degraded mode) ──────────────
# Host-incremented on the supervisor's retry ladder and the state's
# shed paths (`hypervisor_tpu_torch.resilience`).
DISPATCH_RETRIES = REGISTRY.counter(
    "hv_dispatch_retries_total",
    "wave dispatch attempts retried after a transient fault",
)
DISPATCH_FAILURES = REGISTRY.counter(
    "hv_dispatch_failures_total",
    "wave dispatches that exhausted their retry budget",
)
DEGRADED_ENTRIES = REGISTRY.counter(
    "hv_degraded_entries_total",
    "times the supervisor flipped the degraded-mode policy on",
)
ADMISSIONS_SHED = REGISTRY.counter(
    "hv_admissions_shed_total",
    "join stagings refused by an active degraded-mode policy",
)
WAL_REPLAYED_OPS = REGISTRY.counter(
    "hv_wal_replayed_ops_total",
    "committed WAL records replayed by crash recovery",
)

# ── adversarial governance plane (scenario harness + hardening) ──────
# Host-incremented by the targeted shed gate, the collusion detector,
# the deduped slash cascade, and the scenario harness
# (`hypervisor_tpu_torch.adversarial`, `testing.scenarios`).
ADMISSIONS_DAMPED = REGISTRY.counter(
    "hv_admissions_damped_total",
    "low-sigma joins shed by the admission-rate sybil damper "
    "(subset of hv_admissions_shed_total)",
)
COLLUSION_FINDINGS = REGISTRY.counter(
    "hv_collusion_findings_total",
    "vouch-graph cliques flagged by the collusion detector",
)
CASCADE_DEDUPED = REGISTRY.counter(
    "hv_slash_cascade_deduped_total",
    "duplicate per-agent slash/clip events suppressed by the "
    "visited-set cascade guard",
)
SCENARIO_RUNS = REGISTRY.counter(
    "hv_scenario_runs_total",
    "seeded adversarial scenarios executed by the harness",
)
SCENARIO_ATTACK_EVENTS = REGISTRY.counter(
    "hv_scenario_attack_events_total",
    "individual adversary actions driven against the live state",
)
SCENARIO_UNCONTAINED = REGISTRY.counter(
    "hv_scenario_uncontained_total",
    "scenario runs whose containment score fell below the floor",
)
SCENARIO_CONTAINMENT = REGISTRY.gauge(
    "hv_scenario_containment_score",
    "containment score [0, 1] of the most recent scenario run",
)

# ── serving front door (ingestion queues + wave scheduler) ───────────
# Host-incremented by `hypervisor_tpu_torch.serving` (FrontDoor submit paths
# and WaveScheduler dispatches). Queue names are the serving request
# classes; shed reasons are the typed-refusal kinds.
SERVING_QUEUES: tuple[str, ...] = (
    "join", "action", "lifecycle", "terminate", "saga",
)
SERVING_SHED_REASONS: tuple[str, ...] = (
    "queue_full", "degraded", "sybil_damped", "duplicate",
)
SERVING_ENQUEUED = {
    q: REGISTRY.counter(
        "hv_serving_enqueued_total",
        "requests accepted into a serving ingestion queue",
        queue=q,
    )
    for q in SERVING_QUEUES
}
SERVING_SERVED = {
    q: REGISTRY.counter(
        "hv_serving_served_total",
        "requests resolved by a dispatched serving wave",
        queue=q,
    )
    for q in SERVING_QUEUES
}
SERVING_SHED = {
    r: REGISTRY.counter(
        "hv_serving_shed_total",
        "requests refused at the front door (typed refusals)",
        reason=r,
    )
    for r in SERVING_SHED_REASONS
}
SERVING_WAVES = {
    q: REGISTRY.counter(
        "hv_serving_waves_total",
        "shape-bucketed waves dispatched by the scheduler",
        queue=q,
    )
    for q in SERVING_QUEUES
}
SERVING_QUEUE_DEPTH = {
    q: REGISTRY.gauge(
        "hv_serving_queue_depth",
        "requests currently pending in a serving queue",
        queue=q,
    )
    for q in SERVING_QUEUES
}
SERVING_WAVE_FILL = {
    q: REGISTRY.gauge(
        "hv_serving_wave_fill_pct",
        "real-lane fill percentage of the most recent bucketed wave",
        queue=q,
    )
    for q in SERVING_QUEUES
}
SERVING_LATENCY = {
    q: REGISTRY.histogram(
        "hv_serving_latency_us",
        "submit-to-served latency (queue wait + wave dispatch)",
        queue=q,
    )
    for q in SERVING_QUEUES
}
SERVING_DEADLINE_MISSES = REGISTRY.counter(
    "hv_serving_deadline_misses_total",
    "served requests whose latency exceeded their class deadline",
)
SERVING_PADDED_LANES = REGISTRY.counter(
    "hv_serving_padded_lanes_total",
    "no-op pad lanes dispatched to hold the closed bucket shapes",
)

# ── integrity plane (sanitizer / scrubber / escalation ladder) ───────
# The first four are DEVICE-written inside the sanitizer program
# (`integrity.invariants.check_invariants`) so detection rides the
# existing drain; the rest are host-incremented on the repair/restore
# paths (`integrity.plane`).
INTEGRITY_CHECKS = REGISTRY.counter(
    "hv_integrity_checks_total",
    "in-jit invariant sanitizer passes dispatched",
)
INTEGRITY_VIOLATIONS = REGISTRY.counter(
    "hv_integrity_violations_total",
    "violating rows observed by sanitizer passes (cumulative)",
)
INTEGRITY_VIOLATION_ROWS = REGISTRY.gauge(
    "hv_integrity_violation_rows",
    "rows violating an invariant at the last sanitizer pass",
)
INTEGRITY_UNREPAIRABLE_ROWS = REGISTRY.gauge(
    "hv_integrity_unrepairable_rows",
    "restore-class violating rows at the last sanitizer pass",
)
INTEGRITY_REPAIRS = REGISTRY.counter(
    "hv_integrity_repairs_total",
    "rows repaired in place by the integrity ladder",
)
INTEGRITY_ROWS_QUARANTINED = REGISTRY.counter(
    "hv_integrity_rows_quarantined_total",
    "agent rows quarantined by integrity containment",
)
INTEGRITY_SCRUB_LINKS = REGISTRY.counter(
    "hv_integrity_scrub_links_total",
    "DeltaLog chain links + heads re-hashed by the Merkle scrubber",
)
INTEGRITY_SCRUB_MISMATCHES = REGISTRY.counter(
    "hv_integrity_scrub_mismatches_total",
    "chain links whose recomputed digest diverged from the recorded one",
)
INTEGRITY_RESTORES = REGISTRY.counter(
    "hv_integrity_restores_total",
    "checkpoint-restore escalations triggered by the integrity ladder",
)

#: Tables the occupancy accounting names. `metrics` is excluded from the
#: warn set (its layout is static — always "full"); rings (the three
#: logs) warn once as they approach their first wrap.
HEALTH_TABLES: tuple[str, ...] = (
    "agents",
    "sessions",
    "vouches",
    "sagas",
    "elevations",
    "delta_log",
    "event_log",
    "trace_log",
)
#: Live rows are DEVICE gauges (recomputed by `update_gauges` in the one
#: drain program); capacity/bytes are static array metadata published as
#: HOST gauges; high-water is host-tracked from drained live values.
TABLE_LIVE_ROWS = {
    t: REGISTRY.gauge(
        "hv_table_live_rows", "live rows per device table/ring", table=t
    )
    for t in HEALTH_TABLES
}
TABLE_CAPACITY_ROWS = {
    t: REGISTRY.gauge(
        "hv_table_capacity_rows", "row capacity per device table/ring",
        table=t,
    )
    for t in HEALTH_TABLES
}
TABLE_HBM_BYTES = {
    t: REGISTRY.gauge(
        "hv_table_hbm_bytes", "HBM bytes held per device table/ring",
        table=t,
    )
    for t in HEALTH_TABLES
}
TABLE_HIGH_WATER_ROWS = {
    t: REGISTRY.gauge(
        "hv_table_high_water_rows",
        "high-water live rows per device table/ring (since process start)",
        table=t,
    )
    for t in HEALTH_TABLES
}

# ── latency observatory (critical-path attribution + SLO burn rate) ──
# Host-incremented by `observability.attribution.CriticalPathAggregator`
# (ticket resolve) and `observability.slo.SLOEngine` (note/evaluate) —
# all host-plane rows riding the existing drain: ZERO extra device
# transfers on the serving clean path. APPENDED at the registry tail
# (hvlint HVA004: registration order is the device-table row layout).
ATTR_COMPONENTS: tuple[str, ...] = ("queue_wait", "pad_wait", "wave_wall")
SERVING_ATTR_LATENCY = {
    (q, c): REGISTRY.histogram(
        "hv_serving_attr_latency_us",
        "per-ticket critical-path component latency (decomposition of "
        "hv_serving_latency_us: queue_wait + pad_wait + wave_wall)",
        queue=q,
        component=c,
    )
    for q in SERVING_QUEUES
    for c in ATTR_COMPONENTS
}
SERVING_ATTR_TICKETS = {
    q: REGISTRY.counter(
        "hv_serving_attr_tickets_total",
        "resolved tickets folded into the critical-path attribution",
        queue=q,
    )
    for q in SERVING_QUEUES
}
SLO_GOOD = {
    q: REGISTRY.counter(
        "hv_slo_good_total",
        "requests that met their class objective (served inside the "
        "deadline)",
        queue=q,
    )
    for q in SERVING_QUEUES
}
SLO_BAD = {
    q: REGISTRY.counter(
        "hv_slo_bad_total",
        "requests that burned error budget (deadline miss or overload "
        "shed)",
        queue=q,
    )
    for q in SERVING_QUEUES
}
SLO_WINDOWS: tuple[str, ...] = ("fast", "slow", "long")
SLO_BURN_RATE = {
    (q, w): REGISTRY.gauge(
        "hv_slo_burn_rate",
        "error-budget burn rate per class and evaluation window "
        "(1.0 = spending exactly the budget)",
        queue=q,
        window=w,
    )
    for q in SERVING_QUEUES
    for w in SLO_WINDOWS
}
SLO_ALERTS = {
    s: REGISTRY.counter(
        "hv_slo_alerts_total",
        "burn-rate alert transitions fired by the SLO engine",
        severity=s,
    )
    for s in ("warning", "critical", "recovered")
}

# ── roofline observatory (compiled-program cost models, round 15) ────
# HOST-owned gauges set by `observability.roofline.publish` at the
# existing metrics drain: modeled bytes/FLOPs come from the compile-
# time cost registry, achieved fractions join them against the host-
# plane stage walls — ZERO extra device transfers on the clean path.
# APPENDED at the registry tail (hvlint HVA004: registration order is
# the device-table row layout).

#: The CLOSED set of watched jit entry points (`state.py` `instrument`
#: names) the observatory publishes per-program series for — pinned
#: equal to the live watch set by tests/unit/test_roofline.py.
ROOFLINE_PROGRAMS: tuple[str, ...] = (
    "admit_batch",
    "admit_batch_donated",
    "saga_table_tick",
    "terminate_batch",
    "governance_wave",
    "governance_wave_donated",
    "record_calls",
    "slash_cascade",
    "breach_sweep",
    "elevation_expiry",
    "quarantine_enter",
    "rate_consume",
    "quarantine_sweep",
    "fanout_round",
    "effective_rings",
    "gateway_check_actions",
    "update_gauges",
    "merge_wave_session_states",
    # Tenant-dense serving (round 16): the arena's batched programs —
    # the roofline observatory models the `[T, …]` dispatch like any
    # other watched entry point (per-tenant bytes scale ~linearly with
    # T; the dispatch cost does not — that gap IS the amortization the
    # tenant_dense bench row pins). Appended (HVA004).
    "tenant_governance_wave",
    "tenant_governance_wave_donated",
    "tenant_sessions_create",
    "tenant_update_gauges",
)
ROOFLINE_MODELED_BYTES = {
    p: REGISTRY.gauge(
        "hv_roofline_modeled_bytes",
        "XLA cost-analysis bytes accessed per compiled program (latest "
        "captured bucket)",
        program=p,
    )
    for p in ROOFLINE_PROGRAMS
}
ROOFLINE_MODELED_FLOPS = {
    p: REGISTRY.gauge(
        "hv_roofline_modeled_flops",
        "XLA cost-analysis FLOPs per compiled program (latest captured "
        "bucket)",
        program=p,
    )
    for p in ROOFLINE_PROGRAMS
}
ROOFLINE_ACHIEVED_BW_FRAC = {
    p: REGISTRY.gauge(
        "hv_roofline_achieved_bw_frac",
        "modeled bytes / measured stage p50 wall / peak HBM bandwidth "
        "(1.0 = at the roofline)",
        program=p,
    )
    for p in ROOFLINE_PROGRAMS
}
ROOFLINE_MFU = {
    p: REGISTRY.gauge(
        "hv_roofline_mfu",
        "modeled FLOPs / measured stage p50 wall / peak FLOP rate",
        program=p,
    )
    for p in ROOFLINE_PROGRAMS
}
#: Per-wave-phase twins (the `HV_PHASES` vocabulary): bytes
#: from the HLO per-phase walk, walls from the cached measured shares.
ROOFLINE_WAVE_PHASES: tuple[str, ...] = (
    "admission", "fsm_saga", "audit", "gateway", "epilogue",
)
ROOFLINE_PHASE_BYTES = {
    ph: REGISTRY.gauge(
        "hv_roofline_modeled_bytes",
        "per-phase HLO output-byte model of the fused wave",
        phase=ph,
    )
    for ph in ROOFLINE_WAVE_PHASES
}
ROOFLINE_PHASE_FLOPS = {
    ph: REGISTRY.gauge(
        "hv_roofline_modeled_flops",
        "per-phase modeled FLOPs (attributed by the phase byte model)",
        phase=ph,
    )
    for ph in ROOFLINE_WAVE_PHASES
}
ROOFLINE_PHASE_BW_FRAC = {
    ph: REGISTRY.gauge(
        "hv_roofline_achieved_bw_frac",
        "per-phase achieved-bandwidth fraction (phase bytes / measured "
        "phase wall / peak HBM bandwidth)",
        phase=ph,
    )
    for ph in ROOFLINE_WAVE_PHASES
}
ROOFLINE_PHASE_MFU = {
    ph: REGISTRY.gauge(
        "hv_roofline_mfu",
        "per-phase model FLOP utilization (attributed FLOPs / measured "
        "phase wall / peak FLOP rate)",
        phase=ph,
    )
    for ph in ROOFLINE_WAVE_PHASES
}
ROOFLINE_FLOOR_DISTANCE = REGISTRY.gauge(
    "hv_roofline_floor_distance",
    "measured fused-wave p50 wall over its modeled bandwidth/dispatch "
    "floor (1.0 = as fast as the hardware allows) — the live "
    "replacement for ROOFLINE.md's static distance estimate",
)

# ── autopilot observatory (decision plane, round 17) ─────────────────
# HOST-owned rows bumped by `autopilot.Autopilot` as decisions apply
# and outcomes attribute — the ledger's metric drain. APPENDED at the
# registry tail (hvlint HVA004).
AUTOPILOT_DECISIONS = REGISTRY.counter(
    "hv_autopilot_decisions_total",
    "knob deltas applied by the autopilot decision plane",
)
AUTOPILOT_OUTCOMES_CONFIRMED = REGISTRY.counter(
    "hv_autopilot_outcomes_confirmed_total",
    "post-hoc attributions where the signal moved as the rule predicted",
)
AUTOPILOT_OUTCOMES_REFUTED = REGISTRY.counter(
    "hv_autopilot_outcomes_refuted_total",
    "post-hoc attributions where the signal did NOT move as predicted",
)
AUTOPILOT_PREWARM_COMPILES = REGISTRY.counter(
    "hv_autopilot_prewarm_compiles_total",
    "ledger-bracketed PLANNED compiles from bucket-grow pre-warms (the "
    "zero-UNPLANNED-recompile contract subtracts these)",
)
AUTOPILOT_MAX_BUCKET = REGISTRY.gauge(
    "hv_autopilot_max_bucket",
    "largest bucket in the live closed serving set (vs the static "
    "default hv_top renders)",
)
AUTOPILOT_SANITIZE_EVERY = REGISTRY.gauge(
    "hv_autopilot_sanitize_every",
    "live sanitizer cadence (dispatches between fused sanitize passes) "
    "after autopilot retunes",
)

# ── fleet observatory (liveness + merged drain, round 18) ────────────
# HOST-owned rows bumped by `fleet.FleetObservatory` as the lease plane
# evaluates and the merged cross-worker drain folds — APPENDED at the
# registry tail (hvlint HVA004).
FLEET_WORKERS_ALIVE = REGISTRY.gauge(
    "hv_fleet_workers_alive",
    "workers the lease plane currently holds alive",
)
FLEET_WORKERS_SUSPECTED = REGISTRY.gauge(
    "hv_fleet_workers_suspected",
    "workers past the suspect window but not yet declared dead",
)
FLEET_WORKERS_DEAD = REGISTRY.gauge(
    "hv_fleet_workers_dead",
    "workers the lease plane has declared dead",
)
FLEET_LEASE_TRANSITIONS = REGISTRY.counter(
    "hv_fleet_lease_transitions_total",
    "lease state transitions recorded by the fleet registry's "
    "replayable transition log",
)
FLEET_SCRAPES = REGISTRY.counter(
    "hv_fleet_scrapes_total",
    "merged-drain scrape rounds completed across the fleet",
)
FLEET_SCRAPE_ERRORS = REGISTRY.counter(
    "hv_fleet_scrape_errors_total",
    "per-worker scrape failures folded into the merged drain "
    "(a dead worker's series drop out; the fetch error lands here)",
)

# ── hindsight plane (retained history + incidents, round 19) ─────────
# HOST-owned rows — APPENDED at the registry tail (hvlint HVA004).
# The history trio are GAUGES set to the plane's absolute totals: the
# plane samples the drain ITSELF, so per-drain counter increments here
# would make a quiet scrape mutate scrape-visible counters (the
# drain-idempotence contract `test_double_drain_is_idempotent...`
# pins). The incident rows stay counters — they move on health-plane
# events, never on a drain.
HISTORY_SAMPLES = REGISTRY.gauge(
    "hv_history_samples",
    "metrics-drain samples appended into the tiered history rings "
    "(absolute plane total)",
)
HISTORY_EVICTIONS = REGISTRY.gauge(
    "hv_history_evictions",
    "history points evicted from any tier's retention ring (the fixed "
    "HV_HISTORY_* memory budget counting its losses loudly; absolute "
    "plane total)",
)
HISTORY_POINTS_RETAINED = REGISTRY.gauge(
    "hv_history_points_retained",
    "points currently retained across every series and tier",
)
INCIDENTS_CAPTURED = REGISTRY.counter(
    "hv_incidents_captured_total",
    "black-box incident bundles captured by the trigger taxonomy",
)
INCIDENTS_SUPPRESSED = REGISTRY.counter(
    "hv_incidents_suppressed_total",
    "triggers swallowed by per-class cooldown/dedup (the taxonomy "
    "fired; no new bundle was due)",
)
INCIDENTS_EVICTED = REGISTRY.counter(
    "hv_incidents_evicted_total",
    "incident bundles evicted from the bounded retention ring",
)
INCIDENTS_RETAINED = REGISTRY.gauge(
    "hv_incidents_retained",
    "incident bundles currently held in the retention ring",
)

# ── failover plane (durable ownership + reassignment, round 20) ──────
# HOST-owned rows bumped by `fleet.failover` as the reassignment state
# machine runs and fenced zombies refuse writes — APPENDED at the
# registry tail (hvlint HVA004).
FAILOVER_REASSIGNMENTS = REGISTRY.counter(
    "hv_failover_reassignments_total",
    "completed reassignment state machines (one per convicted-dead "
    "worker whose tenants were absorbed by survivors)",
)
FAILOVER_TENANTS_REASSIGNED = REGISTRY.counter(
    "hv_failover_tenants_reassigned_total",
    "tenants recovered from a dead worker's durable checkpoint + WAL "
    "suffix and spliced into a survivor's arena",
)
FAILOVER_REPLAYED_OPS = REGISTRY.counter(
    "hv_failover_replayed_ops_total",
    "committed WAL records replayed past checkpoint watermarks during "
    "failover recoveries (graceful drains replay ZERO)",
)
FAILOVER_FENCED_APPENDS = REGISTRY.counter(
    "hv_failover_fenced_appends_total",
    "WAL appends / checkpoint publications refused because the "
    "writer's fencing epoch is below the fence floor (the zombie "
    "hazard refusing loudly — zero bytes reach disk)",
)
FAILOVER_EPOCH = REGISTRY.gauge(
    "hv_failover_epoch",
    "the ownership map's current fencing epoch (bumped once per "
    "reassignment; stale-epoch writers are fenced below it)",
)

# ── rebalance plane (planned zero-loss migration, round 21) ──────────
# HOST-owned rows bumped by `fleet.rebalance` as planned migrations
# run on the failover splice path — APPENDED at the registry tail
# (hvlint HVA004).
REBALANCE_MIGRATIONS = REGISTRY.counter(
    "hv_rebalance_migrations_total",
    "planned tenant migrations committed (journaled intent -> drain "
    "-> per-tenant fence -> destination adoption -> commit)",
)
REBALANCE_ABORTED = REGISTRY.counter(
    "hv_rebalance_aborted_total",
    "planned migrations aborted before commit (crash at a protocol "
    "boundary, failover winning the race, or operator abort)",
)
REBALANCE_REPLAYED_OPS = REGISTRY.counter(
    "hv_rebalance_replayed_ops_total",
    "committed WAL records replayed during destination adoption (the "
    "clean drained path replays ZERO)",
)
REBALANCE_INFLIGHT = REGISTRY.gauge(
    "hv_rebalance_inflight",
    "migrations with a journaled intent and no commit/abort yet",
)


#: The device-written counters declared first (the rows the waves add
#: into), in declaration order.
COUNTERS = (
    WAVE_TICKS, ADMITTED, REFUSED, SESSIONS_ARCHIVED, BONDS_RELEASED,
    SAGA_STEPS_COMMITTED, SAGA_STEPS_FAILED, GATEWAY_ALLOWED, GATEWAY_DENIED,
    SLASHED, CLIPPED, EVENTS_MIRRORED,
)

#: Row counts of the whole registry (counters, gauges, histograms).
N_COUNTERS, N_GAUGES, N_HISTOGRAMS = REGISTRY.counts()


# ── host object: device table + host mirror + drain ──────────────────


def _host_columns(table, pinned: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(counters, gauges, hist, hist_sum) of a device table on the host,
    behind ONE wait on the device: on CUDA the four columns copy into
    pinned host buffers (`pinned`, kept across drains) without blocking
    and a single stream synchronisation closes them; on the CPU they are
    read directly. The arrays returned are fresh copies (the raw counters
    persist across drains)."""
    cols = (table.counters, table.gauges, table.hist, table.hist_sum)
    if cols[0].device.type != "cuda":
        return tuple(c.numpy().copy() for c in cols)
    outs = []
    for i, col in enumerate(cols):
        buf = pinned.get(i)
        if buf is None or buf.shape != col.shape or buf.dtype != col.dtype:
            buf = pinned[i] = torch.empty(col.shape, dtype=col.dtype, pin_memory=True)
        buf.copy_(col, non_blocking=True)
        outs.append(buf)
    torch.cuda.current_stream(cols[0].device).synchronize()
    return tuple(o.numpy().copy() for o in outs)


class Metrics:
    """One deployment's metrics plane.

    Owns the device `MetricsTable` (pass `.table` into waves; they add
    into it in place, so it is never rebound) and a host-plane mirror with the SAME row layout
    for samples that never touch the device: wall-clock stage latencies
    (there is no device clock to read inside a wave) and tallies from
    paths that already run on the host. `snapshot()` merges both planes.

    Thread-safety: host-plane mutations take the lock; whole drains
    serialize on a second lock.
    """

    def __init__(
        self, registry: MetricsRegistry = REGISTRY, device: str | torch.device = "cuda"
    ) -> None:
        self.registry = registry
        c, g, h = registry.counts()
        nb = len(registry.bounds) + 1
        self._lock = threading.Lock()
        # Serializes whole drains (the copy + wrap accounting): two
        # racing snapshots could otherwise account a STALE raw read
        # after a fresher one, producing a bogus mod-2^32 delta.
        self._drain_lock = threading.Lock()
        self.table = registry.create_table(device)
        self._bounds = np.asarray(registry.bounds, np.float64)
        # Host plane (int64: no wrap handling needed here). Gauges are
        # last-write-wins LEVELS, so the two planes never sum: a gauge
        # row is either device-recomputed by `update_gauges` or host-
        # OWNED (`gauge_set` flips its bit in `_h_gauge_owned`), and the
        # host value then overrides the device column at merge.
        self._h_counters = np.zeros(max(c, 1), np.int64)
        self._h_hist = np.zeros((max(h, 1), nb), np.int64)
        self._h_sum = np.zeros(max(h, 1), np.float64)
        self._h_gauges = np.zeros(max(g, 1), np.float64)
        self._h_gauge_owned = np.zeros(max(g, 1), bool)
        # Device-plane wrap accounting: last raw u32 seen + cumulative.
        self._d_counters_raw = np.zeros(max(c, 1), np.uint32)
        self._d_counters_cum = np.zeros(max(c, 1), np.int64)
        self._d_hist_raw = np.zeros((max(h, 1), nb), np.uint32)
        self._d_hist_cum = np.zeros((max(h, 1), nb), np.int64)
        # The drain's pinned host buffers, made at the first CUDA drain.
        self._pinned: dict = {}

    # ── host side ────────────────────────────────────────────────────

    def inc(self, handle: MetricHandle, n: int = 1) -> None:
        with self._lock:
            self._h_counters[handle.index] += n

    def counter_set(self, handle: MetricHandle, total: int) -> None:
        """Publish an ABSOLUTE monotonic total on the host plane, for
        counters whose authoritative count lives elsewhere (the process-
        global compile watch). Never mix with `inc` on the same handle."""
        with self._lock:
            self._h_counters[handle.index] = max(
                int(total), int(self._h_counters[handle.index])
            )

    def gauge_set(self, handle: MetricHandle, value: float) -> None:
        """Set a HOST-owned gauge level; overrides the device column at
        merge (see `_h_gauge_owned`)."""
        with self._lock:
            self._h_gauges[handle.index] = float(value)
            self._h_gauge_owned[handle.index] = True

    def observe_us(self, handle: MetricHandle, us: float) -> None:
        """Record one host-plane histogram sample (microseconds)."""
        b = int(np.searchsorted(self._bounds, us, side="left"))
        with self._lock:
            self._h_hist[handle.index, b] += 1
            self._h_sum[handle.index] += us

    def host_quantile(
        self, handle: MetricHandle, q: float
    ) -> tuple[int, float]:
        """(sample_count, quantile_us) from the HOST plane only — no
        device read, so the wave watchdog can derive per-stage deadlines
        on the dispatch path."""
        with self._lock:
            counts = self._h_hist[handle.index].copy()
        return int(counts.sum()), _bucket_quantile(counts, self._bounds, q)

    def stage(self, name: str) -> "_StageSample":
        """Bracket one dispatched wave: a span `name`
        (`profiling.stage_scope`) + a latency sample of the host's
        enqueue (the dispatch-to-return wall clock; it never waits on the
        device)."""
        return _StageSample(self, STAGE_LATENCY[name], name)

    # ── drain ────────────────────────────────────────────────────────

    def snapshot(self, refresh=None, host_table=None) -> "MetricsSnapshot":
        """Merge both planes into an immutable snapshot.

        ONE wait on the device (`_host_columns`): the only read-back in
        the metrics plane, and it happens here, outside every wave.
        Idempotent: draining twice without traffic yields identical
        values (u32 wrap deltas accumulate into host int64 cumulatives
        keyed on the last raw value seen).

        `refresh` (table -> table) drains a derived view — the gauge
        recompute over a copy of the gauge column — WITHOUT writing
        `self.table`. `host_table`, an already-fetched host copy with the
        table's four columns as numpy arrays, skips the read; it is
        exclusive with `refresh`.
        """
        if host_table is not None and refresh is not None:
            raise ValueError(
                "snapshot(host_table=...) is the pre-fetched drain; "
                "refresh the table before the one read instead"
            )
        with self._drain_lock:
            with self._lock:
                table = None if host_table is not None else self.table
                h_counters = self._h_counters.copy()
                h_hist = self._h_hist.copy()
                h_sum = self._h_sum.copy()
                h_gauges = self._h_gauges.copy()
                h_gauge_owned = self._h_gauge_owned.copy()
            if host_table is not None:
                cols = tuple(
                    np.array(getattr(host_table, f), copy=True)
                    for f in ("counters", "gauges", "hist", "hist_sum")
                )
            else:
                if refresh is not None:
                    table = refresh(table)
                cols = _host_columns(table, self._pinned)
            raw_c = cols[0].view(np.uint32) if cols[0].dtype == np.int32 else cols[0].astype(np.uint32)
            raw_h = cols[2].view(np.uint32) if cols[2].dtype == np.int32 else cols[2].astype(np.uint32)
            with self._lock:
                # delta = (raw - last) mod 2^32: monotonic past u32 wrap.
                self._d_counters_cum += (
                    raw_c - self._d_counters_raw
                ).astype(np.uint32)
                self._d_counters_raw = raw_c
                self._d_hist_cum += (raw_h - self._d_hist_raw).astype(np.uint32)
                self._d_hist_raw = raw_h
                counters = self._d_counters_cum + h_counters
                hist = self._d_hist_cum + h_hist
        gauges = np.where(
            h_gauge_owned, h_gauges, np.asarray(cols[1], np.float64)
        )
        hist_sum = np.asarray(cols[3], np.float64) + h_sum
        return MetricsSnapshot(
            registry=self.registry,
            counters=counters,
            gauges=gauges,
            hist=hist,
            hist_sum=hist_sum,
            bounds=self._bounds.copy(),
            taken_at=time.time(),
        )

    def to_prometheus(self) -> str:
        return self.snapshot().to_prometheus()


class _StageSample(profiling.stage_scope):
    """`profiling.stage_scope` plus one wall-clock histogram sample of
    the span's own duration on a clean exit."""

    __slots__ = ("_metrics", "_handle")

    def __init__(self, metrics: Metrics, handle: MetricHandle, name: str):
        super().__init__(name)
        self._metrics = metrics
        self._handle = handle

    def __exit__(self, exc_type, exc, tb) -> None:
        super().__exit__(exc_type, exc, tb)
        # A raising wave never completed: recording its partial elapsed
        # time would pollute the latency quantiles operators alert on.
        if exc_type is None:
            self._metrics.observe_us(self._handle, self.ns / 1e3)


@dataclasses.dataclass(frozen=True)
class MetricsSnapshot:
    """Immutable merged view of both planes at one drain."""

    registry: MetricsRegistry
    counters: np.ndarray  # i64[C]
    gauges: np.ndarray    # f64[G]
    hist: np.ndarray      # i64[H, NB]
    hist_sum: np.ndarray  # f64[H]
    bounds: np.ndarray    # f64[NB-1]
    taken_at: float

    def counter(self, handle: MetricHandle) -> int:
        return int(self.counters[handle.index])

    def gauge(self, handle: MetricHandle) -> float:
        return float(self.gauges[handle.index])

    def hist_count(self, handle: MetricHandle) -> int:
        return int(self.hist[handle.index].sum())

    def quantile(self, handle: MetricHandle, q: float) -> float:
        """Prometheus-style bucket quantile (linear within the bucket).

        Returns 0.0 for an empty histogram; samples in the +Inf
        overflow bucket resolve to the highest finite bound (the same
        clamp `histogram_quantile` applies).
        """
        return _bucket_quantile(self.hist[handle.index], self.bounds, q)

    def to_prometheus(
        self, extra_labels: Optional[Mapping[str, str]] = None,
        emit_headers: bool = True,
    ) -> str:
        """Prometheus/OpenMetrics text exposition (version 0.0.4).

        `extra_labels` is injected into EVERY series (the tenant-arena
        drain stamps `tenant="<id>"` so per-class serving latency, SLO
        burn, shed, and occupancy series stay per-tenant in one merged
        exposition); `emit_headers`
        off suppresses the HELP/TYPE block so T per-tenant renderings
        concatenate into one valid exposition (headers once, from the
        first tenant)."""
        lines: list[str] = []
        seen_header: set[str] = set()
        extra = dict(extra_labels or {})

        def header(name: str, kind: str, help: str) -> None:
            if not emit_headers or name in seen_header:
                return
            seen_header.add(name)
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {kind}")

        def label_str(h: MetricHandle) -> str:
            if not extra:
                return h.label_str()
            merged = dict(h.labels)
            merged.update(extra)
            return _labels(merged)

        for h in self.registry.handles:
            if h.kind == COUNTER:
                header(h.name, COUNTER, h.help)
                lines.append(
                    f"{h.name}{label_str(h)} {int(self.counters[h.index])}"
                )
            elif h.kind == GAUGE:
                header(h.name, GAUGE, h.help)
                lines.append(
                    f"{h.name}{label_str(h)} {_fmt(self.gauges[h.index])}"
                )
            else:
                header(h.name, HISTOGRAM, h.help)
                base = dict(h.labels)
                base.update(extra)
                cum = 0
                for b, bound in enumerate(self.bounds):
                    cum += int(self.hist[h.index, b])
                    lines.append(
                        f"{h.name}_bucket{_labels(base, le=_fmt(bound))} {cum}"
                    )
                cum += int(self.hist[h.index, -1])
                lines.append(
                    f"{h.name}_bucket{_labels(base, le='+Inf')} {cum}"
                )
                lines.append(
                    f"{h.name}_sum{_labels(base)} "
                    f"{_fmt(self.hist_sum[h.index])}"
                )
                lines.append(f"{h.name}_count{_labels(base)} {cum}")
        return "\n".join(lines) + "\n"


def _bucket_quantile(counts: np.ndarray, bounds: np.ndarray, q: float) -> float:
    """Prometheus-style bucket quantile (linear within the bucket),
    shared by snapshot quantiles and the host-plane watchdog path."""
    total = counts.sum()
    if total == 0:
        return 0.0
    target = q * total
    cum = np.cumsum(counts)
    b = int(np.searchsorted(cum, target, side="left"))
    if b >= len(bounds):
        return float(bounds[-1])
    lo = 0.0 if b == 0 else float(bounds[b - 1])
    hi = float(bounds[b])
    prev = 0 if b == 0 else int(cum[b - 1])
    frac = (target - prev) / max(int(counts[b]), 1)
    return lo + (hi - lo) * min(max(frac, 0.0), 1.0)


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def _labels(base: Mapping[str, str], **extra: str) -> str:
    items = list(base.items()) + list(extra.items())
    if not items:
        return ""
    return "{" + ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in items
    ) + "}"



def _host_array(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def tally_wave_host(
    m: Metrics,
    *,
    status,
    step_state,
    fsm_err,
    sess_state,
    released: int,
    lane_width: float,
    n_waves: int = 1,
) -> None:
    """Mirror one dispatched wave's in-wave tallies on the host plane,
    from outputs already read back (the reference's rule, shared by the
    bench mirror): admitted and refused lanes, committed and failed saga
    steps, archived sessions (ARCHIVED with no FSM error), released bonds
    and the wave-size sample; `n_waves` scales identical repeated waves."""
    from hypervisor_tpu_torch.models import SessionState
    from hypervisor_tpu_torch.ops import admission, saga_ops

    status = _host_array(status)
    step_state = _host_array(step_state)
    ok = int((status == admission.ADMIT_OK).sum())
    committed = int((step_state == saga_ops.STEP_COMMITTED).sum())
    failed = int((step_state == saga_ops.STEP_FAILED).sum())
    archived = int(
        (
            (_host_array(sess_state) == SessionState.ARCHIVED.code)
            & ~_host_array(fsm_err)
        ).sum()
    )
    m.inc(WAVE_TICKS, n_waves)
    m.inc(ADMITTED, ok * n_waves)
    m.inc(REFUSED, (status.shape[0] - ok) * n_waves)
    m.inc(SAGA_STEPS_COMMITTED, committed * n_waves)
    m.inc(SAGA_STEPS_FAILED, failed * n_waves)
    m.inc(SESSIONS_ARCHIVED, archived * n_waves)
    m.inc(BONDS_RELEASED, int(released) * n_waves)
    for _ in range(n_waves):
        m.observe_us(WAVE_LANES, float(lane_width))


def tally_gateway_host(m: Metrics, verdict, n_lanes: int) -> None:
    """Mirror one gateway dispatch's verdict counters on the host plane
    (the same series the single-device path counts in-wave)."""
    from hypervisor_tpu_torch.ops import gateway as gateway_ops

    n_allowed = int((_host_array(verdict) == gateway_ops.GATE_ALLOWED).sum())
    m.inc(GATEWAY_ALLOWED, n_allowed)
    m.inc(GATEWAY_DENIED, n_lanes - n_allowed)


# ── device-side gauge refresh (the wave's epilogue and the drain) ────


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


def iter_stage_quantiles(
    snap: MetricsSnapshot, qs: tuple[float, ...] = (0.5, 0.95)
) -> Iterator[tuple[str, int, tuple[float, ...]]]:
    """(stage, sample_count, quantiles_us) per stage with samples."""
    for stage, handle in STAGE_LATENCY.items():
        n = snap.hist_count(handle)
        if n:
            yield stage, n, tuple(snap.quantile(handle, q) for q in qs)
