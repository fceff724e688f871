"""Framework-agnostic API service: every endpoint as a plain async method.

Capability parity with reference `api/server.py` (21 endpoints in 6 tag
groups). The reference binds handlers directly to FastAPI; here the
handlers live in one `HypervisorService` so the same logic serves FastAPI
(when installed), the stdlib HTTP fallback (`api.server.serve`), and
direct in-process calls in tests. Errors raise `ApiError(status, detail)`
which each transport maps to its error shape.

The port's service: `device_stats.backend` is the state's torch device
type; `/debug/profile` opens a `torch.profiler` window
(`observability.profiling.capture_window`).
"""

from __future__ import annotations

from typing import Any, Optional

from hypervisor_tpu_torch import __version__
from hypervisor_tpu_torch.core import Hypervisor, ManagedSession
from hypervisor_tpu_torch.models import ActionDescriptor, ExecutionRing, SessionConfig
from hypervisor_tpu_torch.observability import EventType, HypervisorEventBus

from hypervisor_tpu_torch.api import models as M


class ApiError(Exception):
    def __init__(
        self,
        status: int,
        detail: str,
        retry_after_s: Optional[float] = None,
    ) -> None:
        super().__init__(detail)
        self.status = status
        self.detail = detail
        # Backpressure hint: transports surface this as the HTTP
        # Retry-After header (whole seconds, rounded up) on 429s.
        self.retry_after_s = retry_after_s


class PrometheusText(str):
    """Marker type: serve this handler result as Prometheus text
    exposition (`observability.metrics.PROMETHEUS_CONTENT_TYPE`), not
    JSON. Both transports special-case it."""


class NdjsonStream:
    """Marker type: stream these frames as newline-delimited JSON.

    `frames` is an iterable of JSON-serializable dicts; both transports
    write each frame as one line and flush between frames (the serving
    watch stream, `GET /api/v1/serving/stream`)."""

    content_type = "application/x-ndjson"

    def __init__(self, frames) -> None:
        self.frames = frames


class HypervisorService:
    """All endpoint handlers over one Hypervisor + event bus pair."""

    def __init__(
        self,
        hypervisor: Optional[Hypervisor] = None,
        event_bus: Optional[HypervisorEventBus] = None,
    ) -> None:
        self.bus = event_bus or HypervisorEventBus()
        self.hv = hypervisor or Hypervisor(event_bus=self.bus)

    # ── Health ───────────────────────────────────────────────────────

    async def health(self) -> dict[str, str]:
        return {"status": "ok", "version": __version__}

    async def stats(self) -> M.StatsResponse:
        sessions = self.hv._sessions.values()
        return M.StatsResponse(
            version=__version__,
            total_sessions=len(self.hv._sessions),
            active_sessions=len(self.hv.active_sessions),
            total_participants=sum(m.sso.participant_count for m in sessions),
            active_sagas=sum(len(m.saga.active_sagas) for m in sessions),
            total_vouches=self.hv.vouching.vouch_count,
            event_count=self.bus.event_count,
        )

    async def metrics(self) -> PrometheusText:
        """`GET /metrics`: Prometheus scrape of the device metrics plane.

        Refreshes the occupancy gauges on device, drains the plane with
        its single `device_get`, and renders text exposition — all
        outside any wave (`HypervisorState.metrics_snapshot`).
        """
        return PrometheusText(self.hv.state.metrics_prometheus())

    async def trace_session(
        self, session_id: str, format: Optional[str] = None
    ) -> dict:
        """`GET /trace/{session_id}`: the session's flight-recorder trace.

        Drains the trace plane (ONE device_get, outside every wave),
        reconstructs the waves that touched this session, joins host
        event-bus rows onto the spans via the shared device-key words,
        and exports Chrome `trace_event` JSON (default — load it in
        Perfetto / chrome://tracing) or OTLP-lite JSON (`?format=otlp`).
        """
        from hypervisor_tpu_torch.observability import tracing

        state = self.hv.state
        if not state.tracer.enabled:
            raise ApiError(503, "trace plane disabled (HV_TRACE=0)")
        slot = None
        managed = self.hv.get_session(session_id)
        if managed is not None:
            slot = managed.slot
        else:
            slot = state.session_slot_of(session_id)
        if slot is None:
            raise ApiError(404, f"Session {session_id} not found")
        spans = state.session_trace(slot)
        if not spans:
            raise ApiError(
                404,
                f"no recorded waves for session {session_id} (ring "
                "wrapped, wave unsampled, or no traffic yet)",
            )
        tracing.attach_bus_events(spans, self.bus, session_id=session_id)
        # Health events carry no session id (a straggler names only the
        # wave's trace); join them by trace word — only events matching
        # THIS session's waves attach.
        straggler_events = self.bus.query_by_type(EventType.WAVE_STRAGGLER)
        if straggler_events:
            tracing.attach_bus_events(spans, self.bus, events=straggler_events)
        if format == "otlp":
            return tracing.to_otlp(spans, state.tracer)
        if format not in (None, "", "chrome"):
            raise ApiError(400, f"unknown trace format {format!r}")
        return tracing.to_chrome_trace(spans, state.tracer)

    async def debug_flight(self) -> dict:
        """`GET /debug/flight`: flight-recorder status — ring occupancy,
        sampling knobs, and the most recent wave brackets with their
        causal trace ids (the replay keys for /trace/{session_id})."""
        return self.hv.state.flight_summary()

    async def debug_health(self) -> dict:
        """`GET /debug/health`: the runtime health plane in one poll —
        watchdog state (per-stage deadlines, recent stragglers), table
        occupancy with high-water marks, compile telemetry totals, and
        per-stage latency quantiles. One metrics drain (its single
        `device_get`), outside every wave."""
        return self.hv.state.health_summary()

    async def debug_memory(self) -> dict:
        """`GET /debug/memory`: HBM occupancy accounting — per-table
        bytes, capacities, live rows, high-water marks, occupancy, and
        any capacity warnings fired (`footprint()` protocol +
        drained live-row gauges)."""
        return self.hv.state.memory_summary()

    async def debug_resilience(self) -> dict:
        """`GET /debug/resilience`: the resilience plane in one poll —
        supervisor mode (normal/degraded) with the active shed policy,
        dispatch/retry/failure accounting, health-event pressure,
        recovery latency quantiles, WAL status, and the last
        watermarked checkpoint."""
        return self.hv.state.resilience_summary()

    async def debug_integrity(self) -> dict:
        """`GET /debug/integrity`: the state-integrity plane in one
        poll — sanitizer cadence and violation counts, last violation
        detail, repair/containment/restore accounting, Merkle scrub
        progress, and the invariant catalog."""
        return self.hv.state.integrity_summary()

    async def debug_compiles(self) -> dict:
        """`GET /debug/compiles`: compile telemetry for the watched
        jitted wave entry points — compile/recompile/donation-failure
        totals, per-program stats, and recent compile events naming
        the argument whose signature forced each recompile."""
        return self.hv.state.compile_summary()

    async def device_stats(self) -> M.DeviceStatsResponse:
        """Device-plane occupancy: the tables every facade call updates.
        `backend` is the torch device type the tables live on."""
        from hypervisor_tpu_torch.tables.state import AI32_DID

        dev = self.hv.state
        self.hv.sync_events_to_device()
        return M.DeviceStatsResponse(
            backend=dev.device.type,
            agent_rows_active=int((dev.agents.i32[:, AI32_DID] >= 0).sum()),
            agent_capacity=int(dev.agents.i32.shape[0]),
            session_rows=dev._next_session_slot,
            session_capacity=int(dev.sessions.i32.shape[0]),
            vouch_edges_active=int(dev.vouches.active.sum()),
            saga_rows=dev._next_saga_slot,
            delta_log_records=int(dev.delta_log.cursor),
            device_events=int(dev.event_log.cursor),
            elevations_active=int(dev.elevations.active.sum()),
        )

    # ── Sessions ─────────────────────────────────────────────────────

    async def create_session(self, req: M.CreateSessionRequest) -> M.CreateSessionResponse:
        config = SessionConfig(
            consistency_mode=req.consistency_mode,
            max_participants=req.max_participants,
            max_duration_seconds=req.max_duration_seconds,
            min_sigma_eff=req.min_sigma_eff,
            enable_audit=req.enable_audit,
            enable_blockchain_commitment=req.enable_blockchain_commitment,
        )
        managed = await self.hv.create_session(config=config, creator_did=req.creator_did)
        sso = managed.sso
        return M.CreateSessionResponse(
            session_id=sso.session_id,
            state=sso.state.value,
            consistency_mode=sso.consistency_mode.value,
            created_at=sso.created_at.isoformat(),
        )

    async def list_sessions(self, state: Optional[str] = None) -> list[M.SessionListItem]:
        sessions = list(self.hv._sessions.values())
        if state:
            sessions = [m for m in sessions if m.sso.state.value == state]
        return [
            M.SessionListItem(
                session_id=m.sso.session_id,
                state=m.sso.state.value,
                consistency_mode=m.sso.consistency_mode.value,
                participant_count=m.sso.participant_count,
                created_at=m.sso.created_at.isoformat(),
            )
            for m in sessions
        ]

    async def get_session(self, session_id: str) -> M.SessionDetailResponse:
        managed = self._managed(session_id)
        sso = managed.sso
        return M.SessionDetailResponse(
            session_id=sso.session_id,
            state=sso.state.value,
            consistency_mode=sso.consistency_mode.value,
            creator_did=sso.creator_did,
            participant_count=sso.participant_count,
            participants=[
                M.ParticipantInfo(
                    agent_did=p.agent_did,
                    ring=p.ring.value,
                    sigma_raw=p.sigma_raw,
                    sigma_eff=p.sigma_eff,
                    joined_at=p.joined_at.isoformat(),
                    is_active=p.is_active,
                )
                for p in sso.participants
            ],
            created_at=sso.created_at.isoformat(),
            terminated_at=sso.terminated_at.isoformat() if sso.terminated_at else None,
            sagas=[s.to_dict() for s in managed.saga._sagas.values()],
        )

    async def join_session(
        self, session_id: str, req: M.JoinSessionRequest
    ) -> M.JoinSessionResponse:
        from hypervisor_tpu_torch.resilience.policy import DegradedModeRefusal

        actions = [ActionDescriptor(**a) for a in req.actions] if req.actions else None
        try:
            ring = await self.hv.join_session(
                session_id=session_id,
                agent_did=req.agent_did,
                actions=actions,
                sigma_raw=req.sigma_raw,
            )
        except ValueError as e:
            raise ApiError(404, str(e)) from e
        except DegradedModeRefusal as e:
            # Overload shedding (full degraded shed or the sybil
            # damper's targeted floor) is backpressure, not a caller
            # error: 429 + Retry-After, never a 500/400.
            raise ApiError(
                429, str(e), retry_after_s=self._retry_after_s()
            ) from e
        except Exception as e:
            raise ApiError(400, str(e)) from e
        return M.JoinSessionResponse(
            agent_did=req.agent_did,
            session_id=session_id,
            assigned_ring=ring.value,
            ring_name=ring.name,
        )

    async def activate_session(self, session_id: str) -> dict[str, str]:
        try:
            await self.hv.activate_session(session_id)
        except ValueError as e:
            raise ApiError(404, str(e)) from e
        except Exception as e:
            raise ApiError(400, str(e)) from e
        return {"session_id": session_id, "state": "active"}

    async def terminate_session(self, session_id: str) -> dict[str, Any]:
        try:
            merkle_root = await self.hv.terminate_session(session_id)
        except ValueError as e:
            raise ApiError(404, str(e)) from e
        except Exception as e:
            raise ApiError(400, str(e)) from e
        return {
            "session_id": session_id,
            "state": "archived",
            "merkle_root": merkle_root,
        }

    # ── Rings ────────────────────────────────────────────────────────

    async def ring_distribution(self, session_id: str) -> M.RingDistributionResponse:
        managed = self._managed(session_id)
        distribution: dict[str, list[str]] = {}
        for p in managed.sso.participants:
            distribution.setdefault(p.ring.name, []).append(p.agent_did)
        return M.RingDistributionResponse(
            session_id=session_id, distribution=distribution
        )

    async def agent_ring(self, agent_did: str) -> M.AgentRingResponse:
        for managed in self.hv._sessions.values():
            for p in managed.sso.participants:
                if p.agent_did == agent_did and p.is_active:
                    return M.AgentRingResponse(
                        agent_did=agent_did,
                        ring=p.ring.value,
                        ring_name=p.ring.name,
                        session_id=managed.sso.session_id,
                    )
        raise ApiError(404, f"Agent {agent_did} not found in any session")

    async def action_check(
        self, session_id: str, req: M.ActionCheckRequest
    ) -> M.ActionCheckResponse:
        """The full per-action gateway (`Hypervisor.check_action`) —
        the stateful sibling of the stateless /rings/check, served as
        the N=1 case of the wave endpoint (same mapping everywhere)."""
        wave = await self.action_check_wave(
            session_id, M.ActionWaveRequest(requests=[req])
        )
        return wave.results[0]

    async def action_check_wave(
        self, session_id: str, req: M.ActionWaveRequest
    ) -> M.ActionWaveResponse:
        """A whole action wave through the fused gateway program
        (`Hypervisor.check_actions`): one device dispatch for N
        actions, verdicts in request order."""
        if self.hv.get_session(session_id) is None:
            raise ApiError(404, f"Session {session_id} not found")
        try:
            wave = [
                (
                    r.agent_did,
                    ActionDescriptor(**r.action),
                    r.has_consensus,
                    r.has_sre_witness,
                )
                for r in req.requests
            ]
        except (TypeError, ValueError) as e:
            # TypeError: unknown/missing fields; ValueError: the
            # __post_init__ reversibility coercion rejecting a bogus
            # enum value — both are caller errors, not conflicts.
            raise ApiError(422, f"bad action descriptor: {e}")
        try:
            results = await self.hv.check_actions(session_id, wave)
        except Exception as e:
            raise ApiError(409, str(e))
        return M.ActionWaveResponse(
            results=[self._action_response(r) for r in results]
        )

    @staticmethod
    def _action_response(result) -> M.ActionCheckResponse:
        return M.ActionCheckResponse(
            allowed=result.allowed,
            reason=result.reason,
            effective_ring=result.effective_ring.value,
            required_ring=result.required_ring.value,
            quarantined=result.quarantined,
            rate_limited=result.rate_limited,
            breaker_tripped=result.breaker_tripped,
            breach_severity=(
                result.breach_event.severity.value
                if result.breach_event is not None
                else None
            ),
        )

    async def agent_memberships(
        self, agent_did: str
    ) -> M.AgentMembershipsResponse:
        """Every session the agent is live in — one device row per
        (agent, session) membership, with that membership's ring/sigma
        and quarantine flag (session-scoped standing, round 3)."""
        rows = self.hv.state.agent_rows(agent_did)
        mask = self.hv.state.quarantined_mask()
        slot_to_id = {
            m.slot: sid for sid, m in self.hv._sessions.items()
        }
        memberships = [
            {
                "session_id": slot_to_id.get(
                    row["session"], f"slot:{row['session']}"
                ),
                "ring": row["ring"],
                "sigma_eff": row["sigma_eff"],
                "quarantined": bool(mask[row["slot"]]),
            }
            for row in rows
        ]
        return M.AgentMembershipsResponse(
            agent_did=agent_did, memberships=memberships
        )

    async def ring_check(self, req: M.RingCheckRequest) -> M.RingCheckResponse:
        result = self.hv.ring_enforcer.check(
            agent_ring=ExecutionRing(req.agent_ring),
            action=ActionDescriptor(**req.action),
            sigma_eff=req.sigma_eff,
            has_consensus=req.has_consensus,
            has_sre_witness=req.has_sre_witness,
        )
        return M.RingCheckResponse(
            allowed=result.allowed,
            required_ring=result.required_ring.value,
            agent_ring=result.agent_ring.value,
            sigma_eff=result.sigma_eff,
            reason=result.reason,
            requires_consensus=result.requires_consensus,
            requires_sre_witness=result.requires_sre_witness,
        )

    # ── Sagas ────────────────────────────────────────────────────────

    async def create_saga(self, session_id: str) -> M.CreateSagaResponse:
        managed = self._managed(session_id)
        saga = managed.saga.create_saga(session_id)
        return M.CreateSagaResponse(
            saga_id=saga.saga_id,
            session_id=saga.session_id,
            state=saga.state.value,
            created_at=saga.created_at.isoformat(),
        )

    async def list_sagas(self, session_id: str) -> list[M.SagaDetailResponse]:
        managed = self._managed(session_id)
        return [self._saga_detail(s) for s in managed.saga._sagas.values()]

    async def get_saga(self, saga_id: str) -> M.SagaDetailResponse:
        _, saga = self._find_saga(saga_id)
        return self._saga_detail(saga)

    async def add_saga_step(self, saga_id: str, req: M.AddStepRequest) -> M.AddStepResponse:
        managed, _ = self._find_saga(saga_id)
        try:
            step = managed.saga.add_step(
                saga_id=saga_id,
                action_id=req.action_id,
                agent_did=req.agent_did,
                execute_api=req.execute_api,
                undo_api=req.undo_api,
                timeout_seconds=req.timeout_seconds,
                max_retries=req.max_retries,
            )
        except Exception as e:
            raise ApiError(400, str(e)) from e
        return M.AddStepResponse(
            step_id=step.step_id,
            saga_id=saga_id,
            action_id=step.action_id,
            state=step.state.value,
        )

    async def execute_saga_step(self, saga_id: str, step_id: str) -> M.ExecuteStepResponse:
        managed, saga = self._find_saga(saga_id)

        async def noop_executor() -> dict[str, str]:
            return {"status": "executed_via_api"}

        try:
            await managed.saga.execute_step(saga_id, step_id, noop_executor)
        except Exception as e:
            raise ApiError(400, str(e)) from e
        for step in saga.steps:
            if step.step_id == step_id:
                return M.ExecuteStepResponse(
                    step_id=step_id,
                    saga_id=saga_id,
                    state=step.state.value,
                    error=step.error,
                )
        raise ApiError(404, f"Step {step_id} not found")

    # ── Liability ────────────────────────────────────────────────────

    async def create_vouch(self, session_id: str, req: M.CreateVouchRequest) -> M.VouchResponse:
        self._managed(session_id)
        try:
            record = self.hv.vouching.vouch(
                voucher_did=req.voucher_did,
                vouchee_did=req.vouchee_did,
                session_id=session_id,
                voucher_sigma=req.voucher_sigma,
                bond_pct=req.bond_pct,
            )
        except Exception as e:
            raise ApiError(400, str(e)) from e
        return self._vouch_response(record)

    async def list_vouches(self, session_id: str) -> list[M.VouchResponse]:
        self._managed(session_id)
        return [
            self._vouch_response(v)
            for v in self.hv.vouching.session_records(session_id)
        ]

    async def agent_liability(self, agent_did: str) -> M.LiabilityExposureResponse:
        given, received, exposure = [], [], 0.0
        for v in self.hv.vouching.agent_records(agent_did):
            vr = self._vouch_response(v)
            if v.voucher_did == agent_did:
                given.append(vr)
                if v.is_active and not v.is_expired:
                    exposure += v.bonded_amount
            if v.vouchee_did == agent_did:
                received.append(vr)
        return M.LiabilityExposureResponse(
            agent_did=agent_did,
            vouches_given=given,
            vouches_received=received,
            total_exposure=exposure,
        )

    # ── Events ───────────────────────────────────────────────────────

    async def query_events(
        self,
        event_type: Optional[str] = None,
        session_id: Optional[str] = None,
        agent_did: Optional[str] = None,
        limit: Optional[int] = None,
    ) -> list[M.EventResponse]:
        et = None
        if event_type:
            try:
                et = EventType(event_type)
            except ValueError as e:
                raise ApiError(400, f"Unknown event type: {event_type}") from e
        events = self.bus.query(
            event_type=et, session_id=session_id, agent_did=agent_did, limit=limit
        )
        return [
            M.EventResponse(
                event_id=e.event_id,
                event_type=e.event_type.value,
                timestamp=e.timestamp.isoformat(),
                session_id=e.session_id,
                agent_did=e.agent_did,
                causal_trace_id=e.causal_trace_id,
                payload=e.payload,
            )
            for e in events
        ]

    async def event_stats(self) -> M.EventStatsResponse:
        return M.EventStatsResponse(
            total_events=self.bus.event_count, by_type=self.bus.type_counts()
        )

    async def leave_session(
        self, session_id: str, req: M.LeaveSessionRequest
    ) -> dict[str, Any]:
        """Remove a participant from both planes (facade leave)."""
        if self.hv.get_session(session_id) is None:
            raise ApiError(404, f"Session {session_id} not found")
        try:
            await self.hv.leave_session(session_id, req.agent_did)
        except Exception as e:
            raise ApiError(409, str(e))
        return {"session_id": session_id, "agent_did": req.agent_did,
                "status": "left"}

    async def kill_agent(
        self, session_id: str, req: M.KillAgentRequest
    ) -> M.KillAgentResponse:
        """Graceful termination: saga-step handoff, then both-plane
        removal (`Hypervisor.kill_agent`)."""
        from hypervisor_tpu_torch.security.kill_switch import KillReason

        try:
            reason = KillReason(req.reason)
        except ValueError:
            raise ApiError(
                422,
                f"unknown kill reason {req.reason!r}; one of "
                f"{[r.value for r in KillReason]}",
            )
        if self.hv.get_session(session_id) is None:
            raise ApiError(404, f"Session {session_id} not found")
        try:
            result = await self.hv.kill_agent(
                session_id,
                req.agent_did,
                reason=reason,
                details=req.details,
                in_flight_steps=list(req.in_flight_steps or ()),
            )
        except Exception as e:
            raise ApiError(409, str(e))
        return M.KillAgentResponse(
            agent_did=req.agent_did,
            session_id=session_id,
            reason=result.reason.value,
            handoffs=len(result.handoffs),
            handed_off=result.handoff_success_count,
            compensation_triggered=result.compensation_triggered,
        )

    async def run_sweeps(self) -> M.SweepResponse:
        """One operator tick: breach, elevation, quarantine, expiry sweeps
        (docs/OPERATIONS.md 'Ticks the operator owns')."""
        state = self.hv.state
        now = state.now()
        severity, tripped = state.breach_sweep_tick(now)
        # Both elevation planes tick together (facade-wired grants).
        elevations_expired = self.hv.sweep_elevations()
        quarantine_released = state.quarantine_tick(now)
        sessions_expired = await self.hv.sweep_expired_sessions()
        return M.SweepResponse(
            breakers_tripped=int(tripped.sum()),
            elevations_expired=elevations_expired,
            quarantines_released=len(quarantine_released),
            sessions_expired=sessions_expired,
        )

    # ── security: quarantine (both planes) ───────────────────────────

    async def agent_quarantine(self, agent_did: str) -> M.QuarantineStatusResponse:
        """Read-only-isolation status: host record + device flag."""
        record = next(
            (
                r
                for r in self.hv.quarantine.active_quarantines
                if r.agent_did == agent_did
            ),
            None,
        )
        # One row per (agent, session): flagged if ANY membership is.
        mask = self.hv.state.quarantined_mask()
        device_flagged = any(
            mask[r["slot"]] for r in self.hv.state.agent_rows(agent_did)
        )
        if record is None:
            return M.QuarantineStatusResponse(
                agent_did=agent_did,
                quarantined=device_flagged,
                device_flagged=device_flagged,
            )
        return M.QuarantineStatusResponse(
            agent_did=agent_did,
            session_id=record.session_id,
            quarantined=True,
            reason=record.reason.value,
            details=record.details,
            remaining_seconds=record.remaining_seconds,
            device_flagged=device_flagged,
            forensic_keys=sorted(record.forensic_data),
        )

    async def list_quarantines(self) -> list[M.QuarantineListItem]:
        return [
            M.QuarantineListItem(
                agent_did=r.agent_did,
                session_id=r.session_id,
                reason=r.reason.value,
                remaining_seconds=r.remaining_seconds,
            )
            for r in self.hv.quarantine.active_quarantines
        ]

    # ── serving front door ───────────────────────────────────────────

    def _retry_after_s(self) -> float:
        serving = self.hv.state.serving
        if serving is not None:
            # LIVE hint (depth x observed drain rate, SLO-burn scaled),
            # not the static config constant — the class a facade join
            # rides is the join queue.
            return serving.retry_after_for("join")
        return 1.0

    async def debug_serving(self) -> dict:
        """`GET /debug/serving`: the serving plane in one poll —
        per-queue depth/backpressure, shed accounting by refusal kind,
        deadline misses, wave cadence and bucket fill."""
        return self.hv.state.serving_summary()

    async def debug_slo(self) -> dict:
        """`GET /debug/slo`: the latency observatory in one poll —
        per-class burn-rate states and objectives, the alert log (with
        its replay digest), the critical-path decomposition quantiles
        with exemplar coverage, live Retry-After hints, and the
        trace-joined wave-phase shares + recent ticket critical paths
        (the phase join drains the trace ring — one device_get, the
        same cost /trace pays)."""
        state = self.hv.state
        out = state.slo_summary()
        if out.get("enabled"):
            serving = state.serving
            out["phase_shares"] = serving.attribution.phase_shares(
                state.tracer
            )
            out["recent_paths"] = serving.attribution.recent_paths(16)
            out["exemplar_rows"] = serving.attribution.exemplars()[-16:]
        return out

    async def debug_tenants(self) -> dict:
        """`GET /debug/tenants`: the tenant-dense panel in one poll —
        per-tenant live rows / queue depth / shed rate / SLO burn
        state, pressure-ranked top-K, batched-wave cadence
        (`tenancy.TenantArena.summary`, joined with each tenant door's
        serving glance when a `TenantFrontDoor` is attached via
        `service.tenancy = front`). A non-tenant deployment answers
        `{"enabled": false}` — but a service whose OWN state is one
        tenant of an arena reports that arena's panel, so any tenant's
        transport doubles as the fleet view."""
        front = getattr(self, "tenancy", None)
        if front is not None:
            out = front.summary()
            out["enabled"] = True
            return out
        arena = getattr(self.hv.state, "_tenant_arena", None)
        if arena is not None:
            out = arena.summary()
            out["enabled"] = True
            out["via_tenant"] = getattr(
                self.hv.state, "_tenant_idx", None
            )
            return out
        return {"enabled": False}

    async def debug_roofline(self) -> dict:
        """`GET /debug/roofline`: the roofline observatory in one poll
        — per-program modeled bytes/FLOPs (every captured bucket), the
        modeled-vs-measured table with achieved-bandwidth fractions and
        MFU, the per-phase byte model joined with measured wave-phase
        shares (the phase join drains the trace ring — one device_get,
        the same cost /debug/slo pays), peak-HBM occupancy vs the
        footprint protocol, the headroom ranking naming the worst
        program, and the live distance-to-the-floor block."""
        return self.hv.state.roofline_summary()

    async def debug_autopilot(self) -> dict:
        """`GET /debug/autopilot`: the decision plane in one poll —
        last N ledger decisions (rule, knob delta, input-signal digest,
        outcome attribution, CausalTraceId), live knob values vs the
        static defaults, pre-warm compile accounting, and the
        replayable decisions digest. A deployment with no attached
        `autopilot.Autopilot` answers `{"enabled": false}` (hv_top's
        `--url` panel degrades to n/a against such servers)."""
        return self.hv.state.autopilot_summary()

    async def debug_fleet(self) -> dict:
        """`GET /debug/fleet`: the fleet observatory in one poll —
        per-worker lease state / occupancy / compile totals / series
        counts / floor distance, fleet rollup totals, the worst burn
        across workers, the merged-exposition series count, and the
        `FleetSnapshot` rule-input digest (+ the lease registry's
        replayable transition log when one is attached). A deployment
        with no attached fleet (`service.fleet = FleetObservatory(...)`)
        answers `{"enabled": false}` — hv_top's fleet panel degrades to
        n/a against such servers, pre-r18 servers 404 instead."""
        obs = getattr(self, "fleet", None)
        if obs is None:
            return {"enabled": False}
        out = obs.summary()
        out["enabled"] = True
        return out

    def _fleet_or_503(self):
        obs = getattr(self, "fleet", None)
        if obs is None:
            raise ApiError(
                503,
                "no fleet attached (service.fleet = "
                "fleet.FleetObservatory(workers, registry))",
            )
        return obs

    async def fleet_workers(self) -> dict:
        """`GET /fleet/workers`: worker id -> URL + lease state (the
        registry's live view; `unknown` with no registry attached)."""
        obs = self._fleet_or_503()
        states = (
            obs.registry.states() if obs.registry is not None else {}
        )
        return {
            "workers": {
                w: {"url": url, "state": states.get(w, "unknown")}
                for w, url in sorted(obs.workers.items())
            },
            "counts": (
                obs.registry.counts() if obs.registry is not None else None
            ),
        }

    async def fleet_metrics(self) -> PrometheusText:
        """`GET /fleet/metrics`: ONE merged Prometheus exposition for
        the whole fleet — every worker's `/metrics` scraped and
        re-stamped with `worker="<id>"` on EVERY series (tenant-labeled
        rows keep their tenant label: two labels, the PR 16 merge
        lifted one level)."""
        obs = self._fleet_or_503()
        merged, _snap = obs.drain()
        return PrometheusText(merged)

    async def fleet_slo(self) -> dict:
        """`GET /fleet/slo`: every worker's burn plane + the fleet
        worst-burn fold (worst tenant across workers rides inside each
        worker's own /debug/slo payload)."""
        return self._fleet_or_503().slo_rollup()

    async def fleet_trace(
        self, trace_id: str, format: Optional[str] = None
    ) -> dict:
        """`GET /fleet/trace/{trace_id}`: cross-process trace stitching
        — every worker's `/trace/{id}` fragment merged into ONE
        timeline with worker lanes (Chrome: pid per worker; OTLP:
        resource per worker). Workers without a recorded fragment are
        listed in `fleet.missing`, not errors."""
        if format not in (None, "", "chrome", "otlp"):
            raise ApiError(400, f"unknown trace format {format!r}")
        from hypervisor_tpu_torch.fleet.trace import stitch_fleet_trace

        obs = self._fleet_or_503()
        doc = stitch_fleet_trace(
            obs.workers, trace_id, fmt=format or "chrome",
            timeout_s=obs.timeout_s,
        )
        if not doc["fleet"]["workers"]:
            raise ApiError(
                404,
                f"no worker recorded trace {trace_id!r} "
                f"(missing: {doc['fleet']['missing']})",
            )
        return doc

    async def debug_incidents(self) -> dict:
        """`GET /debug/incidents`: the black-box recorder's index —
        capture/suppress/evict totals, the classes currently retained,
        and the newest bundle ids (identity fields only; the full
        bundle is one `GET /incidents/{id}` away). Pre-r19 servers 404
        this route — hv_top's incidents panel degrades to n/a."""
        return self.hv.state.incidents_summary()

    async def get_incident(self, incident_id: str) -> dict:
        """`GET /incidents/{incident_id}`: ONE content-addressed
        bundle — rule-input payload (the id hashes exactly this),
        trigger, and the context riders (history window, bus slice,
        trace fragment, ledger slice, WAL watermark + checkpoint id,
        knob/SLO snapshot). Evicted or unknown ids are 404s."""
        bundle = self.hv.state.incident_bundle(incident_id)
        if bundle is None:
            raise ApiError(404, f"incident {incident_id!r} not found")
        return bundle

    async def history_query(
        self,
        series: Optional[str] = None,
        start: Optional[float] = None,
        end: Optional[float] = None,
        tier: Optional[int] = None,
    ) -> dict:
        """`GET /history/query`: the retained-telemetry plane on the
        caller's clock. With `?series=` returns that series' points
        for the requested window and tier (0 = raw, 1/2 = 10x/100x
        downsampled aggregates); without, the plane summary + the
        live tier-boundary conservation verdict."""
        return self.hv.state.history_query(
            series=series, start=start, end=end, tier=int(tier or 0)
        )

    async def fleet_incidents(self) -> dict:
        """`GET /fleet/incidents`: every worker's incident index
        (scraped over the keep-alive pool, worker-labeled) merged with
        the observatory's own FLEET-scope bundles — the `fleet.
        worker_dead` captures carrying the dead worker's last scraped
        exposition + registry journal slice + stitched trace. Workers
        that cannot answer (dead, or pre-r19) report `unreachable`,
        not errors."""
        return self._fleet_or_503().incidents_rollup()

    async def fleet_ownership(self) -> dict:
        """`GET /fleet/ownership`: the journaled ownership map — which
        worker owns which tenant set at which fencing epoch, with the
        transition tail + digest (`fleet.failover.OwnershipMap`).
        503 until a failover plane is attached
        (`observatory.ownership = OwnershipMap(...)`)."""
        obs = self._fleet_or_503()
        ownership = getattr(obs, "ownership", None)
        if ownership is None:
            raise ApiError(
                503,
                "no ownership map attached (observatory.ownership = "
                "fleet.failover.OwnershipMap(seed))",
            )
        return ownership.summary()

    async def fleet_failover(self) -> dict:
        """`GET /fleet/failover`: the reassignment controller's view —
        managed workers (tenants, spare slots, epochs, fence floors)
        and the reassignment history
        (`fleet.failover.FailoverController`). 503 until attached
        (`observatory.failover = FailoverController(...)`)."""
        obs = self._fleet_or_503()
        controller = getattr(obs, "failover", None)
        if controller is None:
            raise ApiError(
                503,
                "no failover controller attached (observatory.failover "
                "= fleet.failover.FailoverController(ownership))",
            )
        return controller.summary()

    def _rebalance_or_503(self):
        obs = self._fleet_or_503()
        controller = getattr(obs, "rebalance", None)
        if controller is None:
            raise ApiError(
                503,
                "no rebalance controller attached "
                "(observatory.rebalance = fleet.rebalance."
                "RebalanceController(ownership, failover))",
            )
        return controller

    async def fleet_rebalance(self) -> dict:
        """`GET /fleet/rebalance`: the planned-migration view —
        in-flight migrations, committed/aborted history, and the
        current dry-run deficit plan
        (`fleet.rebalance.RebalanceController`). 503 until attached
        (`observatory.rebalance = RebalanceController(...)`)."""
        return self._rebalance_or_503().summary()

    async def fleet_rebalance_post(
        self, req: M.FleetRebalanceRequest
    ) -> dict:
        """`POST /fleet/rebalance`: dry-run (default) or execute. With
        `tenant` + `destination`, one specific migration; with
        neither, the deterministic deficit-aware plan drives it. Bad
        migrations (unknown worker, fenced destination, no spare
        slot) refuse with 409 and nothing moved."""
        controller = self._rebalance_or_503()
        from hypervisor_tpu_torch.fleet.rebalance import MigrationError

        now = float(req.now)
        specific = req.tenant is not None or req.destination is not None
        if specific and (
            req.tenant is None or req.destination is None
        ):
            raise ApiError(
                400,
                "a specific migration needs BOTH tenant and "
                "destination (neither = plan-driven)",
            )
        try:
            if not specific:
                if not req.execute:
                    return {
                        "executed": False,
                        "plan": controller.plan(now),
                    }
                return {"executed": True, **controller.execute(now)}
            if not req.execute:
                plan = controller.plan(now)
                return {
                    "executed": False,
                    "proposal": {
                        "tenant": int(req.tenant),
                        "dest": req.destination,
                    },
                    "plan": plan,
                }
            return {
                "executed": True,
                "result": controller.migrate(
                    req.tenant, req.destination, now
                ),
            }
        except MigrationError as e:
            raise ApiError(409, str(e))

    async def debug_profile(self, req: M.ProfileRequest) -> dict:
        """`POST /debug/profile`: an on-demand bounded `torch.profiler`
        capture window (a Chrome trace into `log_dir`).

        Wedge-proof by construction (`observability.profiling.
        capture_window`): the device plane is probed in a subprocess
        with a hard timeout first, and the window itself runs on a
        bounded worker thread — a wedged driver degrades to a typed
        refusal (503/409), never a hung serving thread."""
        import tempfile

        from hypervisor_tpu_torch.observability import profiling

        log_dir = req.log_dir or tempfile.mkdtemp(prefix="hv_profile_")
        result = profiling.capture_window(log_dir, req.duration_s)
        if result["status"] == "refused":
            status = 409 if result["reason"] in ("busy", "active") else 503
            raise ApiError(
                status,
                f"profile capture refused ({result['reason']}): "
                f"{result['detail']}",
            )
        return result

    async def join_wave(
        self, session_id: str, req: M.JoinWaveRequest
    ) -> M.JoinWaveResponse:
        """`POST /api/v1/sessions/{session_id}/join-wave`: a BATCH of
        joins through the serving front door, drained as shape-bucketed
        admission waves. Per-lane sheds come back as typed refusals
        with Retry-After hints (the whole wave never 429s — only the
        lanes the valve refused), and admitted lanes mirror onto the
        host SSO exactly like the single-join facade path.
        """
        import numpy as np

        managed = self._managed(session_id)
        if not isinstance(req.joins, list) or not req.joins:
            raise ApiError(422, "joins must be a non-empty list")
        fd = self.hv.attach_front_door()
        sched = self.hv.serving_scheduler
        state = self.hv.state
        now = state.now()
        staged: list[tuple[dict, object]] = []
        for lane in req.joins:
            if not isinstance(lane, dict) or "agent_did" not in lane:
                raise ApiError(422, "each join lane needs agent_did")
            sigma = float(lane.get("sigma_raw", 0.0))
            if not np.isfinite(sigma) or not 0.0 <= sigma <= 1.0:
                raise ApiError(
                    422,
                    f"sigma_raw must be finite in [0, 1]; got "
                    f"{lane.get('sigma_raw')!r}",
                )
            out = fd.submit_join(
                managed.slot, str(lane["agent_did"]), sigma, now=now
            )
            staged.append((lane, out))
        sched.drain(now=now)
        lanes = []
        for lane, out in staged:
            did = str(lane["agent_did"])
            if out.refused:
                lanes.append(
                    M.JoinWaveLane(
                        agent_did=did,
                        admitted=False,
                        refusal=out.to_dict(),
                        retry_after_s=out.retry_after_s,
                    )
                )
                continue
            ring_val = None
            if out.ok:
                row = state.agent_row(did, managed.slot)
                if row is not None:
                    ring_val = int(row["ring"])
                    # Mirror the host plane (the facade contract:
                    # device tables and SSO share one truth).
                    try:
                        managed.sso.join(
                            agent_did=did,
                            sigma_raw=float(lane.get("sigma_raw", 0.0)),
                            sigma_eff=float(row["sigma_eff"]),
                            ring=ExecutionRing(ring_val),
                        )
                    except Exception:  # pragma: no cover — device won
                        pass
                    self.hv._emit(
                        EventType.SESSION_JOINED,
                        session_id=session_id,
                        agent_did=did,
                        payload={
                            "ring": ring_val,
                            "sigma_eff": float(row["sigma_eff"]),
                            "via": "join_wave",
                        },
                    )
            lanes.append(
                M.JoinWaveLane(
                    agent_did=did,
                    admitted=bool(out.ok),
                    status=out.status,
                    ring=ring_val,
                    latency_ms=(
                        None if out.latency_s is None
                        else round(out.latency_s * 1e3, 3)
                    ),
                )
            )
        return M.JoinWaveResponse(
            session_id=session_id,
            lanes=[lane.model_dump() for lane in lanes],
            wave=fd.last_wave.get("join"),
        )

    async def serving_stream(
        self,
        frames: Optional[int] = None,
        interval: Optional[float] = None,
    ) -> NdjsonStream:
        """`GET /api/v1/serving/stream?frames=N&interval=S`: newline-
        delimited JSON frames of the serving panel — a poll-free watch
        feed for dashboards (both transports stream it)."""
        n = 5 if frames is None else max(1, min(int(frames), 10_000))
        pause = 0.0 if interval is None else max(0.0, float(interval))
        state = self.hv.state

        def gen():
            import time as _time

            for i in range(n):
                yield {
                    "frame": i,
                    "now_s": round(state.now(), 3),
                    "serving": state.serving_summary(),
                }
                if pause and i < n - 1:
                    _time.sleep(pause)

        return NdjsonStream(gen())

    # ── internals ────────────────────────────────────────────────────

    def _managed(self, session_id: str) -> ManagedSession:
        managed = self.hv.get_session(session_id)
        if managed is None:
            raise ApiError(404, f"Session {session_id} not found")
        return managed

    def _find_saga(self, saga_id: str):
        for managed in self.hv._sessions.values():
            saga = managed.saga.get_saga(saga_id)
            if saga is not None:
                return managed, saga
        raise ApiError(404, f"Saga {saga_id} not found")

    @staticmethod
    def _saga_detail(saga) -> M.SagaDetailResponse:
        return M.SagaDetailResponse(
            saga_id=saga.saga_id,
            session_id=saga.session_id,
            state=saga.state.value,
            created_at=saga.created_at.isoformat(),
            completed_at=saga.completed_at.isoformat() if saga.completed_at else None,
            error=saga.error,
            steps=[
                {
                    "step_id": s.step_id,
                    "action_id": s.action_id,
                    "agent_did": s.agent_did,
                    "state": s.state.value,
                    "error": s.error,
                }
                for s in saga.steps
            ],
        )

    @staticmethod
    def _vouch_response(v) -> M.VouchResponse:
        return M.VouchResponse(
            vouch_id=v.vouch_id,
            voucher_did=v.voucher_did,
            vouchee_did=v.vouchee_did,
            session_id=v.session_id,
            bonded_amount=v.bonded_amount,
            bonded_sigma_pct=v.bonded_sigma_pct,
            is_active=v.is_active,
        )
