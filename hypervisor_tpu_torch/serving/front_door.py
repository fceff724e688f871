"""Serving front door: continuous admission over the wave machinery.

Production traffic is a continuous open stream; the device plane wants
warm, shape-stable waves. This module is the boundary between the two:

  * **Bounded ingestion queues** — one per request class (joins into
    live sessions, gateway actions, full ephemeral lifecycles,
    terminations, saga-step outcomes), each with a hard depth. A full
    queue is backpressure, not an error: the submit returns a typed
    `Refusal` (never raises), carrying a Retry-After hint the API
    transports surface as HTTP 429.
  * **The overload valve** — the PR 4 degraded-mode shedding and the
    sybil damper's targeted floor apply at SUBMIT time (join and
    lifecycle classes only; terminations and saga settles always flow,
    per the `resilience.policy` table). A shed surfaces as a
    `Refusal(kind="degraded"|"sybil_damped")`, counted on
    `hv_serving_shed_total{reason=...}` alongside the resilience
    plane's own counters.
  * **Tickets** — an accepted submit returns a `Ticket` resolved by the
    wave that serves it (`serving.scheduler.WaveScheduler`), carrying
    the admission status / gateway verdict / Merkle root and the
    measured latency (virtual queue wait + wall wave time).

All decision inputs are clock-explicit (`now` flows in from the caller,
defaulting to `state.now()`), so a seeded trace replay makes identical
admission/shed decisions — the determinism contract the soak harness
(`serving.loadgen`) pins.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from collections import deque
from typing import Any, Optional

import numpy as np

from hypervisor_tpu_torch.observability import metrics as metrics_plane
from hypervisor_tpu_torch.observability.attribution import (
    CriticalPathAggregator,
    TicketPath,
)
from hypervisor_tpu_torch.observability.causal_trace import CausalTraceId
from hypervisor_tpu_torch.observability.slo import (
    SLOEngine,
    objectives_from_serving_config,
)
from hypervisor_tpu_torch.resilience.policy import (
    DegradedModeRefusal,
    SybilShedRefusal,
)


def _env_buckets() -> tuple[int, ...]:
    raw = os.environ.get("HV_SERVE_BUCKETS")
    if not raw:
        return (4, 8, 16, 32)
    return tuple(sorted(int(x) for x in raw.split(",") if x.strip()))


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Knobs for the front door + scheduler (docs/OPERATIONS.md
    "Serving front door").

    `buckets` is the CLOSED set of padded wave shapes — the jit cache
    holds one entry per (program, bucket) and nothing else, so a warmed
    scheduler never recompiles (compile-telemetry-pinned). Deadlines
    are per-class latency budgets: a bucket dispatches when it fills OR
    when its oldest request is within `dispatch_margin_s` of missing
    its deadline.
    """

    # Env-tunable knobs read through default_factory so the variable is
    # consulted PER INSTANTIATION, not frozen at first import — the
    # per-call env-arming contract (hvlint HVA002; the
    # HV_SHA256_PALLAS / HV_SUP_* bug class). A bare
    # `float(os.environ.get(...))` here executes when the class body
    # does, i.e. at import time.
    buckets: tuple[int, ...] = dataclasses.field(
        default_factory=_env_buckets
    )
    join_deadline_s: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("HV_SERVE_JOIN_DEADLINE_S", 0.05)
        )
    )
    action_deadline_s: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("HV_SERVE_ACTION_DEADLINE_S", 0.05)
        )
    )
    lifecycle_deadline_s: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("HV_SERVE_LIFECYCLE_DEADLINE_S", 0.1)
        )
    )
    terminate_deadline_s: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("HV_SERVE_TERMINATE_DEADLINE_S", 0.2)
        )
    )
    saga_deadline_s: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("HV_SERVE_SAGA_DEADLINE_S", 0.1)
        )
    )
    dispatch_margin_s: float = 0.0
    #: Queue depths. The join queue is capped at the largest bucket
    #: because `flush_joins` harvests the WHOLE staging queue in one
    #: wave — more than a bucket of staged joins would force an
    #: off-bucket shape. The other classes chunk, so their depths are
    #: backpressure policy, not a shape constraint.
    action_queue_depth: int = 256
    lifecycle_queue_depth: int = 256
    terminate_queue_depth: int = 256
    saga_queue_depth: int = 256
    #: Retry-After FALLBACK (seconds) stamped on refusals while the
    #: per-class drain rate is unwarmed; once a class has drained a few
    #: waves the hint derives from live depth × observed drain rate
    #: (`FrontDoor.retry_after_for`), scaled by the class's SLO burn
    #: state. API transports surface it as the HTTP Retry-After header.
    retry_after_s: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("HV_SERVE_RETRY_AFTER_S", 1.0)
        )
    )
    #: SLO plane (observability/slo.py): per-class objective target —
    #: the fraction of requests that must resolve inside the class
    #: deadline (sheds burn budget too). Windows/thresholds follow the
    #: SRE multi-window multi-burn-rate shape; all env knobs read via
    #: default_factory (the HVA002 per-instantiation arming contract).
    slo_target: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("HV_SERVE_SLO_TARGET", 0.99)
        )
    )
    slo_fast_window_s: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("HV_SERVE_SLO_FAST_S", 300.0)
        )
    )
    slo_slow_window_s: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("HV_SERVE_SLO_SLOW_S", 3600.0)
        )
    )
    slo_long_window_s: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("HV_SERVE_SLO_LONG_S", 21600.0)
        )
    )
    slo_critical_burn: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("HV_SERVE_SLO_CRIT_BURN", 14.4)
        )
    )
    slo_warning_burn: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("HV_SERVE_SLO_WARN_BURN", 6.0)
        )
    )
    slo_min_events: int = dataclasses.field(
        default_factory=lambda: int(
            float(os.environ.get("HV_SERVE_SLO_MIN_EVENTS", 24))
        )
    )
    #: Audit turns per ephemeral lifecycle (the T axis of the fused
    #: wave's delta bodies; fixed per deployment so the program shape
    #: closes over the bucket set).
    lifecycle_turns: int = 1

    @property
    def max_bucket(self) -> int:
        return max(self.buckets)

    @property
    def join_queue_depth(self) -> int:
        return self.max_bucket

    def deadline_for(self, kind: str) -> float:
        return {
            "join": self.join_deadline_s,
            "action": self.action_deadline_s,
            "lifecycle": self.lifecycle_deadline_s,
            "terminate": self.terminate_deadline_s,
            "saga": self.saga_deadline_s,
        }[kind]


@dataclasses.dataclass(frozen=True)
class Refusal:
    """A typed shed: the front door's answer when it will NOT serve.

    Refusals are return values, not exceptions — a caller that treats
    backpressure as an error path retries blindly; one that reads the
    kind and the Retry-After hint backs off correctly. The API maps
    refusals to HTTP 429 with a Retry-After header.
    """

    kind: str          # queue_full | degraded | sybil_damped | duplicate
    detail: str
    retry_after_s: float

    refused = True

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "detail": self.detail,
            "retry_after_s": self.retry_after_s,
        }


@dataclasses.dataclass
class Ticket:
    """One accepted request, resolved by the wave that serves it.

    Carries a `CausalTraceId` from submit (the attribution plane's join
    key: `/metrics` exemplars and `/debug/slo` paths name it) and, once
    resolved, the critical-path decomposition — queue_wait + pad_wait +
    wave_wall partition `latency_s` exactly (the attribution-sum
    invariant, test-pinned) — plus the serving wave's own trace id so
    the ticket links to the wave's `/trace` span tree.
    """

    kind: str
    submitted_at: float          # virtual (caller-clock) submit time
    deadline_s: float
    payload: dict
    refused = False
    done: bool = False
    ok: bool = False             # admitted / allowed / terminated
    status: Optional[int] = None  # class-specific code (admission status,
                                  # gateway verdict, ...)
    result: Any = None           # class-specific extra (root hex, ring, ...)
    served_at: Optional[float] = None
    latency_s: Optional[float] = None
    deadline_missed: bool = False
    trace: Optional[CausalTraceId] = None   # assigned at submit
    queue_wait_s: Optional[float] = None    # critical-path decomposition
    pad_wait_s: Optional[float] = None
    wave_wall_s: Optional[float] = None
    wave_seq: Optional[int] = None          # the serving wave's host index
    wave_trace_id: Optional[str] = None     # ... and its CausalTraceId

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "done": self.done,
            "ok": self.ok,
            "status": self.status,
            "latency_ms": (
                None if self.latency_s is None
                else round(self.latency_s * 1e3, 3)
            ),
            "deadline_missed": self.deadline_missed,
            "trace_id": self.trace.full_id if self.trace else None,
            "wave_trace_id": self.wave_trace_id,
        }


class FrontDoor:
    """The ingestion layer over one `HypervisorState`.

    Attach once per state (`state.serving = self` happens here); the
    companion `WaveScheduler` drains the queues through the fused wave
    programs. Submits are synchronous and cheap — queue admission plus
    the overload valve — and never dispatch a wave themselves.
    """

    def __init__(self, state, config: Optional[ServingConfig] = None) -> None:
        self.state = state
        self.config = config or ServingConfig()
        if not self.config.buckets:
            raise ValueError("ServingConfig.buckets must be non-empty")
        self.joins: deque[Ticket] = deque()
        self.actions: deque[Ticket] = deque()
        self.lifecycles: deque[Ticket] = deque()
        self.terminations: deque[Ticket] = deque()
        self.saga_steps: deque[Ticket] = deque()
        self._queues = {
            "join": self.joins,
            "action": self.actions,
            "lifecycle": self.lifecycles,
            "terminate": self.terminations,
            "saga": self.saga_steps,
        }
        self._depths = {
            "join": self.config.join_queue_depth,
            "action": self.config.action_queue_depth,
            "lifecycle": self.config.lifecycle_queue_depth,
            "terminate": self.config.terminate_queue_depth,
            "saga": self.config.saga_queue_depth,
        }
        # Submits may come from many transport threads; the scheduler
        # drains under the same lock.
        self._lock = threading.RLock()
        # A sealed door refuses every admission (planned migration:
        # the source stops admitting, drains, then hands off). The
        # detail string names why; None = open.
        self._sealed: Optional[str] = None
        # Park session for terminate-wave padding, allocated lazily (a
        # memberless session whose re-archival is an idempotent no-op).
        self._park_slot: Optional[int] = None
        # Accounting (mirrored onto the metrics plane).
        self.enqueued = {q: 0 for q in self._queues}
        self.served = {q: 0 for q in self._queues}
        self.shed = {r: 0 for r in metrics_plane.SERVING_SHED_REASONS}
        self.deadline_misses = 0
        self.waves = {q: 0 for q in self._queues}
        self.padded_lanes = 0
        self.last_wave: dict[str, dict] = {}
        # ── latency observatory (ISSUE 13) ──────────────────────────
        # Critical-path aggregator: per-ticket decomposition histograms
        # + exemplars, host-plane only (rides the existing drain).
        self.attribution = CriticalPathAggregator(state.metrics)
        # SLO burn-rate engine: alerts fan through the health monitor's
        # listener set, so the supervisor and the facade's bus bridge
        # both see slo_burn_{warning,critical}/slo_recovered.
        self.slo = SLOEngine(
            objectives_from_serving_config(self.config),
            fast_window_s=self.config.slo_fast_window_s,
            slow_window_s=self.config.slo_slow_window_s,
            long_window_s=self.config.slo_long_window_s,
            critical_burn=self.config.slo_critical_burn,
            warning_burn=self.config.slo_warning_burn,
            min_events=self.config.slo_min_events,
            metrics=state.metrics,
            emit=state.health.emit_event,
        )
        # Observed drain rate per class (requests/virtual-second, EWMA
        # over dispatched waves): the live Retry-After derivation.
        self._drain_rate = {q: 0.0 for q in self._queues}
        self._drain_waves = {q: 0 for q in self._queues}
        self._drain_last_t: dict[str, Optional[float]] = {
            q: None for q in self._queues
        }
        self._drain_pending = {q: 0 for q in self._queues}
        state.serving = self

    def reconfigure(self, config: ServingConfig) -> None:
        """Swap the serving config live — the autopilot's knob path.

        Updates the config and the per-queue depth caps under the
        submit/drain lock; queued tickets and all accounting survive.
        GROWING `buckets` widens the closed set: the caller MUST
        pre-warm the new (program, bucket) tiles first
        (`WaveScheduler.warm_bucket`) or the next dispatch at the new
        shape pays an UNPLANNED compile — the autopilot's grow rule
        brackets that pre-warm with compile-telemetry reads so the
        zero-recompile contract stays auditable. SLO objectives keep
        their original windows/targets (deadlines are not autopilot
        knobs in this round).
        """
        if not config.buckets:
            raise ValueError("ServingConfig.buckets must be non-empty")
        with self._lock:
            self.config = config
            self._depths = {
                "join": config.join_queue_depth,
                "action": config.action_queue_depth,
                "lifecycle": config.lifecycle_queue_depth,
                "terminate": config.terminate_queue_depth,
                "saga": config.saga_queue_depth,
            }

    # ── submit paths ─────────────────────────────────────────────────

    def _now(self, now: Optional[float]) -> float:
        return self.state.now() if now is None else float(now)

    def retry_after_for(
        self, queue: Optional[str] = None, now: Optional[float] = None
    ) -> float:
        """The LIVE Retry-After hint for one class.

        depth × observed drain rate — "come back when the backlog ahead
        of you has drained" — scaled by the class's SLO burn state
        (a burning class tells clients to back off 2–4× harder), and
        falling back to the static `config.retry_after_s` while the
        drain rate is unwarmed (< 3 dispatched waves). The PR 10 bug
        this replaces: the static constant was returned even when the
        queue was draining in milliseconds.
        """
        base = self.config.retry_after_s
        if queue is None or queue not in self._queues:
            return base
        mult = self.slo.backoff_multiplier(queue)
        rate = self._drain_rate[queue]
        if self._drain_waves[queue] < 3 or rate <= 0.0:
            return round(base * mult, 3)
        depth = len(self._queues[queue])
        estimate = (depth + 1) / rate
        # Clamp: never promise sub-50 ms (a tick must elapse), never
        # exceed 8× the configured fallback (a stalled drain is the
        # supervisor's problem, not an hour-long client backoff).
        return round(
            min(max(estimate, 0.05), base * 8.0) * mult, 3
        )

    def _refuse(
        self, kind: str, detail: str, queue: Optional[str] = None,
        now: Optional[float] = None,
    ) -> Refusal:
        self.shed[kind] += 1
        self.state.metrics.inc(metrics_plane.SERVING_SHED[kind])
        # Overload sheds burn the class's error budget (a duplicate is
        # a caller mistake, not an SLO event).
        if queue is not None and kind != "duplicate" and now is not None:
            self.slo.note(queue, now, good=False)
        return Refusal(
            kind=kind,
            detail=detail,
            retry_after_s=self.retry_after_for(queue, now),
        )

    def _accept(self, queue: str, ticket: Ticket) -> Ticket:
        if ticket.trace is None:
            ticket.trace = CausalTraceId()
        self._queues[queue].append(ticket)
        self.enqueued[queue] += 1
        self.state.metrics.inc(metrics_plane.SERVING_ENQUEUED[queue])
        return ticket

    def seal(self, detail: str = "sealed") -> None:
        """Stop admitting: every subsequent submit sheds with the
        standard `queue_full` refusal (clients already back off on
        it). Queued work still drains — seal + drain is the planned
        handoff's quiesce step."""
        with self._lock:
            self._sealed = str(detail)

    def unseal(self) -> None:
        """Resume admitting (migration aborted, or door reopened)."""
        with self._lock:
            self._sealed = None

    @property
    def sealed(self) -> Optional[str]:
        return self._sealed

    def _depth_refusal(
        self, queue: str, now: Optional[float] = None
    ) -> Optional[Refusal]:
        if self._sealed is not None:
            return self._refuse(
                "queue_full",
                f"{queue} sealed: {self._sealed}",
                queue=queue,
                now=now,
            )
        if len(self._queues[queue]) >= self._depths[queue]:
            return self._refuse(
                "queue_full",
                f"{queue} queue at depth {self._depths[queue]}",
                queue=queue,
                now=now,
            )
        return None

    def submit_join(
        self,
        session_slot: int,
        agent_did: str,
        sigma_raw: float,
        trustworthy: bool = True,
        now: Optional[float] = None,
    ) -> Ticket | Refusal:
        """Stage a join into a live session.

        The overload valve fires HERE (the damper's window sees the
        attempt, then the shed gate decides), so a refused join never
        consumes a staging slot or an agent row. Accepted joins ride
        the state's native staging queue until the scheduler's next
        padded admission wave.
        """
        now = self._now(now)
        with self._lock:
            full = self._depth_refusal("join", now)
            if full is not None:
                return full
            from hypervisor_tpu_torch.state import _mkey

            did = self.state.agent_ids.intern(agent_did)
            key = _mkey(int(session_slot), did)
            if key in self.state._members or key in self.state._staged_members:
                return self._refuse(
                    "duplicate",
                    f"{agent_did} already member/staged in session "
                    f"{session_slot}",
                    queue="join",
                    now=now,
                )
            try:
                q = self.state.enqueue_join(
                    int(session_slot), agent_did, float(sigma_raw),
                    trustworthy=trustworthy, now=now,
                )
            except SybilShedRefusal as e:
                return self._refuse("sybil_damped", str(e), "join", now)
            except DegradedModeRefusal as e:
                return self._refuse("degraded", str(e), "join", now)
            if q < 0:
                return self._refuse(
                    "queue_full", "staging queue full", "join", now
                )
            ticket = Ticket(
                kind="join",
                submitted_at=now,
                deadline_s=self.config.join_deadline_s,
                payload={
                    "session_slot": int(session_slot),
                    "agent_did": agent_did,
                    "did": did,
                    "sigma_raw": float(sigma_raw),
                },
            )
            return self._accept("join", ticket)

    def submit_action(
        self,
        agent_slot: int,
        required_ring: int = 2,
        is_read_only: bool = False,
        has_consensus: bool = False,
        has_sre_witness: bool = False,
        now: Optional[float] = None,
    ) -> Ticket | Refusal:
        """Queue one gateway action for a STANDING membership row."""
        now = self._now(now)
        with self._lock:
            full = self._depth_refusal("action", now)
            if full is not None:
                return full
            ticket = Ticket(
                kind="action",
                submitted_at=now,
                deadline_s=self.config.action_deadline_s,
                payload={
                    "slot": int(agent_slot),
                    "required_ring": int(required_ring),
                    "is_read_only": bool(is_read_only),
                    "has_consensus": bool(has_consensus),
                    "has_sre_witness": bool(has_sre_witness),
                },
            )
            return self._accept("action", ticket)

    def submit_lifecycle(
        self,
        session_id: str,
        agent_did: str,
        sigma_raw: float,
        delta_bodies: Optional[np.ndarray] = None,  # u32[T, BODY_WORDS]
        trustworthy: bool = True,
        now: Optional[float] = None,
    ) -> Ticket | Refusal:
        """Queue one ephemeral full lifecycle (create + join + audit +
        terminate in ONE fused wave step — the PR 9 one-program path).

        Admission load, so the overload valve applies exactly as for
        joins: the damper window sees the attempt, then the shed gate
        decides with the same targeted/full-shed postures.
        """
        now = self._now(now)
        with self._lock:
            full = self._depth_refusal("lifecycle", now)
            if full is not None:
                return full
            damper = self.state.admission_damper
            if damper is not None:
                damper.note_join(self.state, float(sigma_raw), now)
            try:
                self.state._shed_gate(float(sigma_raw))
            except SybilShedRefusal as e:
                return self._refuse(
                    "sybil_damped", str(e), "lifecycle", now
                )
            except DegradedModeRefusal as e:
                return self._refuse("degraded", str(e), "lifecycle", now)
            t = self.config.lifecycle_turns
            from hypervisor_tpu_torch.ops.merkle import BODY_WORDS

            if delta_bodies is None:
                bodies = np.zeros((t, BODY_WORDS), np.uint32)
            else:
                bodies = np.asarray(delta_bodies, np.uint32)
                if bodies.shape != (t, BODY_WORDS):
                    return self._refuse(
                        "queue_full",
                        f"lifecycle bodies must be [{t}, {BODY_WORDS}] "
                        f"(got {bodies.shape}); lifecycle_turns is fixed "
                        "per deployment",
                    )
            ticket = Ticket(
                kind="lifecycle",
                submitted_at=now,
                deadline_s=self.config.lifecycle_deadline_s,
                payload={
                    "session_id": session_id,
                    "agent_did": agent_did,
                    "sigma_raw": float(sigma_raw),
                    "trustworthy": bool(trustworthy),
                    "bodies": bodies,
                },
            )
            return self._accept("lifecycle", ticket)

    def submit_terminate(
        self, session_slot: int, now: Optional[float] = None
    ) -> Ticket | Refusal:
        """Queue a session termination. NEVER shed by the valve —
        draining live work is what a degraded plane keeps doing — only
        bounded-queue backpressure applies."""
        now = self._now(now)
        with self._lock:
            full = self._depth_refusal("terminate", now)
            if full is not None:
                return full
            ticket = Ticket(
                kind="terminate",
                submitted_at=now,
                deadline_s=self.config.terminate_deadline_s,
                payload={"session_slot": int(session_slot)},
            )
            return self._accept("terminate", ticket)

    def submit_saga_step(
        self, saga_slot: int, ok: bool, now: Optional[float] = None
    ) -> Ticket | Refusal:
        """Queue one saga-step outcome for the next saga round. Like
        terminations, saga settles always flow (in-flight work)."""
        now = self._now(now)
        with self._lock:
            full = self._depth_refusal("saga", now)
            if full is not None:
                return full
            ticket = Ticket(
                kind="saga",
                submitted_at=now,
                deadline_s=self.config.saga_deadline_s,
                payload={"saga_slot": int(saga_slot), "ok": bool(ok)},
            )
            return self._accept("saga", ticket)

    # ── scheduler hooks ──────────────────────────────────────────────

    def park_slot(self, now: float) -> int:
        """The terminate-wave pad session (allocated on first use)."""
        if self._park_slot is None:
            from hypervisor_tpu_torch.models import SessionConfig

            self._park_slot = self.state.create_session(
                "serving:park",
                SessionConfig(max_participants=1),
                now=now,
            )
        return self._park_slot

    def resolve(
        self,
        ticket: Ticket,
        *,
        ok: bool,
        now: float,
        wall_s: float,
        status: Optional[int] = None,
        result: Any = None,
        newest_submit: Optional[float] = None,
        wave_record=None,
    ) -> None:
        """Close a ticket against the wave that served it: latency is
        the virtual queue wait plus the measured wall dispatch time.

        With `newest_submit` (the latest submit time in the dispatched
        wave), the latency decomposes into the critical path the
        attribution plane aggregates:

          pad_wait   = now − newest_submit   (the whole wave's tail
                       wait for a bucket fill that never came; 0 when
                       the bucket filled — dispatch fires on fill)
          queue_wait = (now − submitted) − pad_wait
          wave_wall  = wall_s

        which PARTITIONS `latency_s` exactly (the attribution-sum
        invariant). `wave_record` is the serving wave's host
        `tracing.WaveRecord` — its trace id joins the ticket to the
        wave's `/trace` span tree.
        """
        ticket.done = True
        # Lane statuses arrive as numpy bools off the wave result; the
        # ticket/TicketPath records are host-plane (JSON-clean) values.
        ok = bool(ok)
        ticket.ok = ok
        ticket.status = status
        ticket.result = result
        ticket.served_at = now
        queue_total = max(0.0, now - ticket.submitted_at)
        ticket.latency_s = queue_total + wall_s
        ticket.deadline_missed = ticket.latency_s > ticket.deadline_s
        pad = 0.0
        if newest_submit is not None:
            pad = min(max(0.0, now - newest_submit), queue_total)
        ticket.queue_wait_s = queue_total - pad
        ticket.pad_wait_s = pad
        ticket.wave_wall_s = wall_s
        if wave_record is not None:
            ticket.wave_seq = wave_record.wave_seq
            ticket.wave_trace_id = wave_record.trace.full_id
        self.served[ticket.kind] += 1
        m = self.state.metrics
        m.inc(metrics_plane.SERVING_SERVED[ticket.kind])
        m.observe_us(
            metrics_plane.SERVING_LATENCY[ticket.kind],
            ticket.latency_s * 1e6,
        )
        if ticket.deadline_missed:
            self.deadline_misses += 1
            m.inc(metrics_plane.SERVING_DEADLINE_MISSES)
        self.attribution.observe(
            TicketPath(
                kind=ticket.kind,
                trace_id=ticket.trace.full_id if ticket.trace else None,
                wave_seq=ticket.wave_seq,
                wave_trace_id=ticket.wave_trace_id,
                submitted_at=ticket.submitted_at,
                resolved_at=now,
                queue_wait_s=ticket.queue_wait_s,
                pad_wait_s=ticket.pad_wait_s,
                wave_wall_s=wall_s,
                latency_s=ticket.latency_s,
                deadline_s=ticket.deadline_s,
                deadline_missed=ticket.deadline_missed,
                ok=ok,
            )
        )
        self.slo.note(ticket.kind, now, good=not ticket.deadline_missed)

    def note_wave(
        self, queue: str, lanes: int, bucket: int,
        now: Optional[float] = None,
    ) -> None:
        """Book one dispatched wave's shape accounting (+ the observed
        drain rate when the scheduler supplies its virtual `now` — the
        live Retry-After input)."""
        self.waves[queue] += 1
        pads = max(0, bucket - lanes)
        self.padded_lanes += pads
        m = self.state.metrics
        m.inc(metrics_plane.SERVING_WAVES[queue])
        if pads:
            m.inc(metrics_plane.SERVING_PADDED_LANES, pads)
        fill = 100.0 * lanes / bucket if bucket else 100.0
        m.gauge_set(metrics_plane.SERVING_WAVE_FILL[queue], fill)
        self.last_wave[queue] = {
            "lanes": lanes,
            "bucket": bucket,
            "fill_pct": round(fill, 1),
        }
        if now is not None:
            self._note_drain(queue, lanes, now)

    def _note_drain(self, queue: str, lanes: int, now: float) -> None:
        """EWMA drain rate (requests / virtual second) per class.

        A `drain()` burst dispatches several waves at one `now`; their
        lanes accumulate and fold into the next sample with dt > 0
        (rate math on dt == 0 would divide by zero, and dropping the
        lanes would under-report the drain)."""
        last = self._drain_last_t[queue]
        self._drain_pending[queue] += lanes
        if last is None:
            self._drain_last_t[queue] = now
            return
        dt = now - last
        if dt <= 0.0:
            return
        sample = self._drain_pending[queue] / dt
        self._drain_pending[queue] = 0
        self._drain_last_t[queue] = now
        self._drain_waves[queue] += 1
        prev = self._drain_rate[queue]
        self._drain_rate[queue] = (
            sample if prev <= 0.0 else 0.7 * prev + 0.3 * sample
        )

    def refresh_depth_gauges(self) -> None:
        m = self.state.metrics
        for q, dq in self._queues.items():
            m.gauge_set(metrics_plane.SERVING_QUEUE_DEPTH[q], len(dq))

    # ── observability ────────────────────────────────────────────────

    def queue_depths(self) -> dict[str, int]:
        with self._lock:
            return {q: len(dq) for q, dq in self._queues.items()}

    def summary(self) -> dict:
        """The serving panel: `/debug/serving` + `health_summary`'s
        serving block (what `examples/hv_top.py` renders)."""
        with self._lock:
            offered = sum(self.enqueued.values()) + sum(self.shed.values())
            shed_total = sum(self.shed.values())
            return {
                "enabled": True,
                "buckets": list(self.config.buckets),
                "queues": {
                    q: {
                        "depth": len(dq),
                        "capacity": self._depths[q],
                        "enqueued": self.enqueued[q],
                        "served": self.served[q],
                        "waves": self.waves[q],
                        "deadline_s": self.config.deadline_for(q),
                        "last_wave": self.last_wave.get(q),
                    }
                    for q, dq in self._queues.items()
                },
                "shed": dict(self.shed),
                "shed_rate": (
                    round(shed_total / offered, 4) if offered else 0.0
                ),
                "deadline_misses": self.deadline_misses,
                "padded_lanes": self.padded_lanes,
                "retry_after_s": self.config.retry_after_s,
                # Live backpressure hints + burn states (the latency
                # observatory's glance row; full detail on /debug/slo).
                "retry_after_live_s": {
                    q: self.retry_after_for(q) for q in self._queues
                },
                "slo_states": {
                    q: self.slo.state_of(q) for q in self._queues
                },
            }


__all__ = ["FrontDoor", "Refusal", "ServingConfig", "Ticket"]
