"""Request/response schemas for the Hypervisor REST API.

Capability parity with reference `api/models.py` (24 models, same field
sets). Schemas are pydantic models when pydantic is installed; otherwise
they degrade to lightweight dataclass-like records with `model_dump()` —
the service layer (`api.service`) only relies on that method, so the API
works in the bare image.
"""

from __future__ import annotations

from typing import Optional

from hypervisor_tpu_torch.models import ConsistencyMode

try:
    from pydantic import BaseModel, Field

    _HAVE_PYDANTIC = True
except ImportError:  # pragma: no cover - pydantic is present in CI
    _HAVE_PYDANTIC = False

    def Field(default=..., description: str = ""):  # type: ignore[no-redef]
        return default

    class BaseModel:  # type: ignore[no-redef]
        """Minimal stand-in: kwargs -> attributes, model_dump()."""

        def __init__(self, **kw):
            ann = {}
            for klass in reversed(type(self).__mro__):
                ann.update(getattr(klass, "__annotations__", {}))
            for name in ann:
                if name in kw:
                    setattr(self, name, kw.pop(name))
                elif hasattr(type(self), name):
                    setattr(self, name, getattr(type(self), name))
                else:
                    raise TypeError(f"missing required field {name!r}")
            if kw:
                raise TypeError(f"unexpected fields {sorted(kw)}")

        def model_dump(self) -> dict:
            out = {}
            ann = {}
            for klass in reversed(type(self).__mro__):
                ann.update(getattr(klass, "__annotations__", {}))
            for name in ann:
                value = getattr(self, name)
                if isinstance(value, BaseModel):
                    value = value.model_dump()
                elif isinstance(value, list):
                    value = [
                        v.model_dump() if isinstance(v, BaseModel) else v for v in value
                    ]
                out[name] = value
            return out


# ── Sessions ─────────────────────────────────────────────────────────


class CreateSessionRequest(BaseModel):
    creator_did: str
    consistency_mode: ConsistencyMode = ConsistencyMode.EVENTUAL
    max_participants: int = 10
    max_duration_seconds: int = 3600
    min_sigma_eff: float = 0.60
    enable_audit: bool = True
    enable_blockchain_commitment: bool = False


class ParticipantInfo(BaseModel):
    agent_did: str
    ring: int
    sigma_raw: float
    sigma_eff: float
    joined_at: str
    is_active: bool


class CreateSessionResponse(BaseModel):
    session_id: str
    state: str
    consistency_mode: str
    created_at: str


class SessionListItem(BaseModel):
    session_id: str
    state: str
    consistency_mode: str
    participant_count: int
    created_at: str


class SessionDetailResponse(BaseModel):
    session_id: str
    state: str
    consistency_mode: str
    creator_did: str
    participant_count: int
    participants: list[ParticipantInfo]
    created_at: str
    terminated_at: Optional[str] = None
    sagas: list[dict] = []


class JoinSessionRequest(BaseModel):
    agent_did: str
    actions: Optional[list[dict]] = None
    sigma_raw: float = 0.0


class JoinSessionResponse(BaseModel):
    agent_did: str
    session_id: str
    assigned_ring: int
    ring_name: str


# ── Rings ────────────────────────────────────────────────────────────


class RingDistributionResponse(BaseModel):
    session_id: str
    distribution: dict[str, list[str]]


class AgentRingResponse(BaseModel):
    agent_did: str
    ring: int
    ring_name: str
    session_id: str


class RingCheckRequest(BaseModel):
    agent_ring: int
    action: dict
    sigma_eff: float
    has_consensus: bool = False
    has_sre_witness: bool = False


class RingCheckResponse(BaseModel):
    allowed: bool
    required_ring: int
    agent_ring: int
    sigma_eff: float
    reason: str
    requires_consensus: bool = False
    requires_sre_witness: bool = False


# ── Sagas ────────────────────────────────────────────────────────────


class CreateSagaResponse(BaseModel):
    saga_id: str
    session_id: str
    state: str
    created_at: str


class SagaDetailResponse(BaseModel):
    saga_id: str
    session_id: str
    state: str
    created_at: str
    completed_at: Optional[str] = None
    error: Optional[str] = None
    steps: list[dict] = []


class AddStepRequest(BaseModel):
    action_id: str
    agent_did: str
    execute_api: str
    undo_api: Optional[str] = None
    timeout_seconds: int = 300
    max_retries: int = 0


class AddStepResponse(BaseModel):
    step_id: str
    saga_id: str
    action_id: str
    state: str


class ExecuteStepResponse(BaseModel):
    step_id: str
    saga_id: str
    state: str
    error: Optional[str] = None


# ── Liability ────────────────────────────────────────────────────────


class CreateVouchRequest(BaseModel):
    voucher_did: str
    vouchee_did: str
    voucher_sigma: float
    bond_pct: Optional[float] = None
    expiry: Optional[str] = None


class VouchResponse(BaseModel):
    vouch_id: str
    voucher_did: str
    vouchee_did: str
    session_id: str
    bonded_amount: float
    bonded_sigma_pct: float
    is_active: bool


class LiabilityExposureResponse(BaseModel):
    agent_did: str
    vouches_given: list[VouchResponse]
    vouches_received: list[VouchResponse]
    total_exposure: float


# ── Events / stats ───────────────────────────────────────────────────


class EventResponse(BaseModel):
    event_id: str
    event_type: str
    timestamp: str
    session_id: Optional[str] = None
    agent_did: Optional[str] = None
    causal_trace_id: Optional[str] = None
    payload: dict = {}


class EventStatsResponse(BaseModel):
    total_events: int
    by_type: dict[str, int]


class StatsResponse(BaseModel):
    version: str
    total_sessions: int
    active_sessions: int
    total_participants: int
    active_sagas: int
    total_vouches: int
    event_count: int


class DeviceStatsResponse(BaseModel):
    """Occupancy of the HBM-resident device tables behind the facade."""

    backend: str
    agent_rows_active: int
    agent_capacity: int
    session_rows: int
    session_capacity: int
    vouch_edges_active: int
    saga_rows: int
    delta_log_records: int
    device_events: int
    elevations_active: int


class QuarantineStatusResponse(BaseModel):
    """One agent's read-only-isolation status across both planes."""

    agent_did: str
    session_id: Optional[str] = None
    quarantined: bool = False
    reason: Optional[str] = None
    details: str = ""
    remaining_seconds: float = 0.0
    device_flagged: bool = False
    forensic_keys: list = []


class AgentMembershipsResponse(BaseModel):
    """Every session an agent is live in — one device row per
    membership (round-3 model: session-scoped standing).

    Each membership is a dict {session_id: str, ring: int,
    sigma_eff: float, quarantined: bool} (kept untyped so the
    pydantic-free fallback transport serializes it unchanged).
    """

    agent_did: str
    memberships: list = []


class QuarantineListItem(BaseModel):
    agent_did: str
    session_id: str
    reason: str
    remaining_seconds: float


class LeaveSessionRequest(BaseModel):
    agent_did: str


class ActionCheckRequest(BaseModel):
    """One action through the full gateway (quarantine -> sudo ring ->
    enforcement -> rate bucket -> breach recording)."""

    agent_did: str
    action: dict  # ActionDescriptor fields
    has_consensus: bool = False
    has_sre_witness: bool = False


class ActionCheckResponse(BaseModel):
    allowed: bool
    reason: str
    effective_ring: int
    required_ring: int
    quarantined: bool = False
    rate_limited: bool = False
    breaker_tripped: bool = False
    breach_severity: Optional[str] = None


class ActionWaveRequest(BaseModel):
    """A WAVE of actions through the fused gateway program
    (`Hypervisor.check_actions`): settled in request order in ONE
    device dispatch — an early action's recording can trip the breaker
    that refuses a later one, and duplicate agents' bucket tokens
    settle sequentially."""

    requests: list[ActionCheckRequest]


class ActionWaveResponse(BaseModel):
    results: list[ActionCheckResponse]


class KillAgentRequest(BaseModel):
    agent_did: str
    reason: str = "manual"
    details: str = ""
    # In-flight step descriptors to rehome: [{step_id, saga_id}, ...].
    in_flight_steps: list = []


class KillAgentResponse(BaseModel):
    """One graceful termination's outcome.

    Substitute routing here is the RECORDED handoff decision; rewiring
    the steps onto the device saga table needs host executor callables
    (`runtime.saga_scheduler.apply_handoffs`), which HTTP clients cannot
    ship — programmatic callers pass scheduler/executors to
    `Hypervisor.kill_agent` directly.
    """

    agent_did: str
    session_id: str
    reason: str
    handoffs: int = 0
    handed_off: int = 0
    compensation_triggered: bool = False


class SweepResponse(BaseModel):
    """One operator tick's outcomes across every sweep."""

    breakers_tripped: int = 0
    elevations_expired: int = 0
    quarantines_released: int = 0
    sessions_expired: list = []


# ── Serving front door ───────────────────────────────────────────────


class JoinWaveRequest(BaseModel):
    """A batch of joins for one session, served as bucketed waves.

    Each lane is {"agent_did": ..., "sigma_raw": ...}; per-lane sheds
    come back as typed refusals in the response (never a 429 for the
    whole wave — backpressure is per lane)."""

    joins: list


class JoinWaveLane(BaseModel):
    agent_did: str
    admitted: bool = False
    status: Optional[int] = None
    ring: Optional[int] = None
    refusal: Optional[dict] = None
    retry_after_s: Optional[float] = None
    latency_ms: Optional[float] = None


class JoinWaveResponse(BaseModel):
    session_id: str
    lanes: list
    wave: Optional[dict] = None


# ── Roofline observatory ─────────────────────────────────────────────


class ProfileRequest(BaseModel):
    """`POST /debug/profile`: one bounded jax.profiler capture window.

    `duration_s` is clamped to [0.001, 10] server-side; `log_dir`
    defaults to a fresh temp directory (returned in the response)."""

    duration_s: float = 0.05
    log_dir: Optional[str] = None


# ── Fleet rebalance plane ────────────────────────────────────────────


class FleetRebalanceRequest(BaseModel):
    """`POST /fleet/rebalance`: dry-run or execute planned migrations.

    With `tenant` + `destination`, one specific migration; with
    neither, the deterministic deficit-aware plan drives it. `execute`
    false (the default) returns the plan without moving anything.
    `now` is the caller's clock (virtual time), defaulting to 0."""

    tenant: Optional[int] = None
    destination: Optional[str] = None
    execute: bool = False
    now: float = 0.0
