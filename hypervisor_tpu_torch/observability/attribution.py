"""Per-request critical-path attribution for the serving front door.

An aggregate p99 says the serving plane was slow; it cannot say WHY a
given ticket's 689 ms was spent. This module decomposes every resolved
serving ticket into the segments an operator can act on:

  * **queue_wait** — submit until arrivals stopped contributing to the
    ticket's wave (the ingestion-queue residence the scheduler could
    not avoid: the bucket was still filling).
  * **pad_wait** — dispatch time minus the wave's NEWEST submit: the
    tail the whole wave spent waiting for a fill that never came (zero
    when the bucket filled exactly — dispatch triggers on fill; the
    deadline-flush padding delay otherwise). This is the bucket-padding
    cost the closed-shape contract charges.
  * **wave_wall** — the measured wall clock of the wave dispatch that
    served the ticket.

The INVARIANT (test-pinned, gate 6g): `queue_wait + pad_wait +
wave_wall == latency` for every ticket, to float precision — the
decomposition is a partition of the measured end-to-end latency, not an
estimate alongside it.

`wave_wall` further splits across the PR 11 megakernel block vocabulary
(`HV_PHASES`: admission / fsm_saga / audit / gateway / epilogue) by
joining the ticket's wave — via the host `Tracer`'s wave index and the
in-wave TraceLog stamps, the `causal_trace.device_key_of` join — and
normalizing the reconstructed child-span durations to the measured
wall. Phase placement is LOGICAL (there is no readable clock inside a
lowered program; stamp order is real, intra-wave timing interpolates —
the same caveat `tracing.drain` documents), but the shares sum to the
measured wall exactly. Phase reconstruction drains the trace ring (one
`device_get`), so it runs only on demand (`/debug/slo`, the soak
report) — the per-ticket observe path is host-arithmetic only and the
aggregate histograms ride the metrics plane's EXISTING drain: zero
extra device transfers on the clean path.

**Exemplars**: each (class, latency-bucket) retains the most recent
ticket's CausalTraceId + its wave's trace id, so a `/metrics` tail
bucket links straight to `/trace/{session}` — rendered as
OpenMetrics-style `# EXEMPLAR` comment lines (format-0.0.4 parsers
ignore comments) and served structured on `/debug/slo`.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Optional

import numpy as np

#: The wave-phase vocabulary of the attribution plane — the PR 11
#: megakernel block boundaries (`hv_phase.*` named scopes in
#: `ops/pipeline.py`). APPEND ONLY (the soak row's decomposition keys).
HV_PHASES: tuple[str, ...] = (
    "admission", "fsm_saga", "audit", "gateway", "epilogue",
)

#: TraceLog stage -> hv_phase block. The in-wave stamps speak the
#: `WAVE_CHILD_STAGES` vocabulary (admission/fsm/chain/saga/terminate);
#: the megakernel collapsed fsm+saga+terminate into one walk block and
#: delta_chain into the audit block — this is that projection. Stages
#: with no stamp (gateway lanes on non-action waves, the epilogue tail)
#: surface as the root-bracket residual, attributed to `epilogue` (and
#: `gateway` when the wave carried gateway stamps).
WAVE_PHASE_OF: dict[str, str] = {
    "admission_wave": "admission",
    "session_fsm": "fsm_saga",
    "saga_round": "fsm_saga",
    "terminate_wave": "fsm_saga",
    "delta_chain": "audit",
    "gateway_wave": "gateway",
    "gateway_wave_sharded": "gateway",
}


@dataclasses.dataclass(frozen=True)
class TicketPath:
    """One resolved ticket's critical path (host-plane record)."""

    kind: str
    trace_id: Optional[str]       # the ticket's CausalTraceId.full_id
    wave_seq: Optional[int]       # host wave index of the serving wave
    wave_trace_id: Optional[str]  # that wave's trace id (/trace join)
    submitted_at: float
    resolved_at: float
    queue_wait_s: float
    pad_wait_s: float
    wave_wall_s: float
    latency_s: float
    deadline_s: float
    deadline_missed: bool
    ok: bool

    def components(self) -> dict[str, float]:
        return {
            "queue_wait": self.queue_wait_s,
            "pad_wait": self.pad_wait_s,
            "wave_wall": self.wave_wall_s,
        }

    def sum_error_s(self) -> float:
        """|Σ components − latency| — the attribution-sum invariant."""
        return abs(
            self.queue_wait_s + self.pad_wait_s + self.wave_wall_s
            - self.latency_s
        )

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "trace_id": self.trace_id,
            "wave_seq": self.wave_seq,
            "wave_trace_id": self.wave_trace_id,
            "latency_ms": round(self.latency_s * 1e3, 3),
            "queue_wait_ms": round(self.queue_wait_s * 1e3, 3),
            "pad_wait_ms": round(self.pad_wait_s * 1e3, 3),
            "wave_wall_ms": round(self.wave_wall_s * 1e3, 3),
            "deadline_ms": round(self.deadline_s * 1e3, 3),
            "deadline_missed": self.deadline_missed,
            "ok": self.ok,
        }


class CriticalPathAggregator:
    """Folds resolved tickets into per-class decomposition histograms.

    Attached by the `FrontDoor`; `observe()` runs at ticket resolve
    (host arithmetic + host-plane histogram samples — the rows merge at
    the metrics plane's existing drain). Exemplars and a bounded ring
    of recent paths serve `/debug/slo`; `phase_shares()` joins the
    trace plane on demand.
    """

    def __init__(self, metrics, recent_capacity: int = 256) -> None:
        self.metrics = metrics
        self._lock = threading.Lock()
        self._recent: deque[TicketPath] = deque(maxlen=recent_capacity)
        # (kind, latency-bucket index) -> most recent exemplar.
        self._exemplars: dict[tuple[str, int], dict] = {}
        self._buckets_seen: set[tuple[str, int]] = set()
        self.tickets = 0
        self.max_sum_error_s = 0.0

    # ── ingest (the resolve hot path: host-only) ─────────────────────

    def observe(self, path: TicketPath) -> None:
        from hypervisor_tpu_torch.observability import metrics as mp

        m = self.metrics
        for component, value_s in path.components().items():
            handle = mp.SERVING_ATTR_LATENCY.get((path.kind, component))
            if handle is not None:
                m.observe_us(handle, value_s * 1e6)
        counter = mp.SERVING_ATTR_TICKETS.get(path.kind)
        if counter is not None:
            m.inc(counter)
        bucket = int(
            np.searchsorted(
                np.asarray(mp.DEFAULT_BUCKET_BOUNDS_US),
                path.latency_s * 1e6,
                side="left",
            )
        )
        with self._lock:
            self.tickets += 1
            self.max_sum_error_s = max(
                self.max_sum_error_s, path.sum_error_s()
            )
            self._recent.append(path)
            key = (path.kind, bucket)
            self._buckets_seen.add(key)
            if path.trace_id is not None:
                self._exemplars[key] = {
                    "queue": path.kind,
                    "bucket": bucket,
                    "le_us": (
                        mp.DEFAULT_BUCKET_BOUNDS_US[bucket]
                        if bucket < len(mp.DEFAULT_BUCKET_BOUNDS_US)
                        else float("inf")
                    ),
                    "trace_id": path.trace_id,
                    "wave_trace_id": path.wave_trace_id,
                    "wave_seq": path.wave_seq,
                    "latency_us": round(path.latency_s * 1e6, 1),
                    "at": path.resolved_at,
                }

    # ── views ────────────────────────────────────────────────────────

    def recent_paths(self, limit: int = 16) -> list[dict]:
        with self._lock:
            return [p.to_dict() for p in list(self._recent)[-limit:]]

    def exemplars(self) -> list[dict]:
        with self._lock:
            return [
                self._exemplars[k] for k in sorted(self._exemplars)
            ]

    def exemplar_coverage(self) -> float:
        """Fraction of observed (class, latency-bucket) cells holding a
        live exemplar — 1.0 when every populated tail bucket links to a
        trace (the soak row's `exemplar_coverage`)."""
        with self._lock:
            if not self._buckets_seen:
                return 0.0
            return round(len(self._exemplars) / len(self._buckets_seen), 4)

    def exemplar_lines(self) -> list[str]:
        """OpenMetrics-style exemplar COMMENT lines appended to the
        Prometheus exposition (`# EXEMPLAR ...` — 0.0.4 parsers skip
        comments, humans and scrapers that want the join get the
        CausalTraceId next to the bucket it exemplifies)."""
        lines = []
        for ex in self.exemplars():
            le = (
                "+Inf" if ex["le_us"] == float("inf")
                else f"{ex['le_us']:g}"
            )
            lines.append(
                "# EXEMPLAR hv_serving_latency_us_bucket"
                f'{{queue="{ex["queue"]}",le="{le}"}} '
                f'trace_id="{ex["trace_id"]}" '
                f'wave_trace_id="{ex["wave_trace_id"]}" '
                f"latency_us={ex['latency_us']}"
            )
        return lines

    def summary(self) -> dict:
        """Per-class decomposition quantiles — host-plane histograms
        only (`Metrics.host_quantile`): NO device round-trip, so the
        health endpoint and hv_top can poll it freely."""
        from hypervisor_tpu_torch.observability import metrics as mp

        classes: dict[str, dict] = {}
        for queue in mp.SERVING_QUEUES:
            row: dict[str, dict] = {}
            n_total = 0
            for component in mp.ATTR_COMPONENTS:
                handle = mp.SERVING_ATTR_LATENCY.get((queue, component))
                if handle is None:
                    continue
                n, p50 = self.metrics.host_quantile(handle, 0.5)
                _, p99 = self.metrics.host_quantile(handle, 0.99)
                if n:
                    # host_quantile hands back numpy scalars; the
                    # summary is host-plane (JSON-clean) values.
                    row[component] = {
                        "n": int(n),
                        "p50_ms": round(float(p50) / 1e3, 3),
                        "p99_ms": round(float(p99) / 1e3, 3),
                    }
                    n_total = max(n_total, n)
            if row:
                classes[queue] = row
        with self._lock:
            max_err = self.max_sum_error_s
            tickets = self.tickets
        return {
            "tickets": tickets,
            "classes": classes,
            "max_sum_error_ms": round(max_err * 1e3, 6),
            "exemplar_coverage": self.exemplar_coverage(),
            "exemplars": len(self._exemplars),
        }

    # ── the trace-plane join (on demand: ONE device_get) ─────────────

    def phase_shares(self, tracer, last: int = 64) -> Optional[dict]:
        """Mean per-phase share of the wave wall over the most recent
        reconstructed waves — see `wave_phase_shares` (the module-level
        rule this delegates to; the roofline observatory joins the
        SAME shares against its per-phase byte model)."""
        return wave_phase_shares(tracer, last)

    def phase_decomposition(
        self, path: TicketPath, shares: Optional[dict]
    ) -> Optional[dict[str, float]]:
        """One ticket's wave_wall split across `HV_PHASES` (ms), summing
        to `wave_wall_ms` exactly (shares partition 1.0)."""
        if shares is None:
            return None
        wall_ms = path.wave_wall_s * 1e3
        return {p: round(wall_ms * shares[p], 6) for p in HV_PHASES}


def wave_phase_shares(tracer, last: int = 64) -> Optional[dict]:
    """Mean per-phase share of the wave wall over the most recent
    reconstructed waves, normalized to sum to 1.0 exactly.

    Joins the host wave index with the in-wave TraceLog stamps
    (`tracer.drain()` — one device_get; call from debug endpoints /
    the soak report, never the resolve path). Stamped stages map
    through `WAVE_PHASE_OF`; the root-bracket residual the stamps
    do not cover lands on `epilogue`. Returns None with no
    reconstructable waves (plane disabled, ring wrapped).

    ONE rule shared by the latency observatory (per-ticket wave_wall
    decomposition) and the roofline observatory (per-phase achieved
    bandwidth) — the two planes must split the same wall the same way.
    """
    spans = tracer.drain()
    if not spans:
        return None
    totals = {phase: 0.0 for phase in HV_PHASES}
    weight = 0.0
    for root in spans[-last:]:
        root_us = max(root.end_us - root.start_us, 0.0)
        if root_us <= 0.0:
            continue
        covered = 0.0
        for child in root.children:
            phase = WAVE_PHASE_OF.get(child.stage)
            dur = max(child.end_us - child.start_us, 0.0)
            if phase is None:
                phase = "epilogue"
            totals[phase] += dur
            covered += dur
        totals["epilogue"] += max(root_us - covered, 0.0)
        weight += root_us
    if weight <= 0.0:
        return None
    # Round FIRST, then fold the residual onto the largest share:
    # per-share rounding after an exact normalization reintroduces
    # up to len(HV_PHASES)/2 ulps of 1e-6 drift, breaking the
    # phase-sum invariant the callers pin.
    shares = {p: round(totals[p] / weight, 6) for p in HV_PHASES}
    top = max(shares, key=shares.get)
    shares[top] += 1.0 - sum(shares.values())
    return shares


__all__ = [
    "HV_PHASES",
    "WAVE_PHASE_OF",
    "CriticalPathAggregator",
    "TicketPath",
    "wave_phase_shares",
]
