"""The fused governance wave over the state tables
(`hypervisor_tpu.ops.pipeline.governance_wave`, as bench.py calls it).

One wave of B joining agents and K sessions that live and die in it:

  1. vouched contributions toward each joining agent (`ops.liability`;
     a kernel summing in edge order on CUDA),
  2. admission onto the agent/session tables        -> kernel B4,
  3./5./6. the session FSM walk, one saga step per lane, terminate
     (bond release, participant deactivation, ARCHIVED walk) -> B5,
  4. audit: the delta chain (B2) and per-session Merkle roots (B3);
     with a DeltaLog riding along, B2's ring form appends the wave's
     records to its ring in the same launch (B6's work),

  7. with `gateway_args`, the action gateway on the post-terminate
     table (`ops.gateway.check_actions`),

then, with a metrics table riding along, the in-wave tallies, with a
TraceLog the wave's stamps, and

  8. with `epilogue_tables`, the epilogue over the post-wave tables: the
     occupancy gauges (`observability.metrics.update_gauges`) and, with
     `sanitize`, the invariant sanitizer (`integrity.invariants`).

CUDA tensors always go through the kernels, launched in that order on
the current stream with no host synchronisation inside the wave; CPU
tensors go through the kernels' plain versions. Phases 7 and 8 have no
kernel of their own (the reference has no Pallas form of them): they
are torch ops on the tables' device. The tables are updated IN PLACE
(the reference donates them to the jitted wave).

`tenant_governance_wave` is the same wave for T tenants at once (the
reference's `state._tenant_wave_fn`, its fused wave under `jax.vmap`):
every table stacked along a leading tenant axis, lanes [T, B] and
sessions [T, K], each tenant's sessions one contiguous range, no
gateway and no trace stamps. The kernels run in their tenant forms,
each launching as often for T tenants as the solo form does for one;
the tallies, the gauges and the sanitizer are torch ops over the
`[T, ...]` tensors. Tenant t's slice of every table, ring and metrics
row ends exactly as its own solo wave would leave it with
`unique_sessions=False` and that range.

`governance_pipeline` is the reference's headline unit
(`hypervisor_tpu.ops.pipeline.governance_pipeline`): S independent
session lanes run admission, the session FSM walk, the audit (the delta
chain, B2 on CUDA, and per-lane Merkle roots, B3 on CUDA), one saga step,
terminate and archive, over tensors and not the tables, then the four
consensus sums. It runs on the device its inputs lie on.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from hypervisor_tpu_torch.config import (
    DEFAULT_CONFIG,
    BreachConfig,
    HypervisorConfig,
    RateLimitConfig,
    TrustConfig,
)
from hypervisor_tpu_torch.integrity import invariants
from hypervisor_tpu_torch.kernels import mtu, wave
from hypervisor_tpu_torch.models import SessionState
from hypervisor_tpu_torch.observability import metrics as schema
from hypervisor_tpu_torch.observability import profiling, tracing
from hypervisor_tpu_torch.ops import admission as admission_ops
from hypervisor_tpu_torch.ops import gateway as gateway_ops
from hypervisor_tpu_torch.ops import liability as liability_ops
from hypervisor_tpu_torch.ops import merkle as merkle_ops
from hypervisor_tpu_torch.ops import rings as ring_ops
from hypervisor_tpu_torch.ops import saga_ops, session_fsm, tally
from hypervisor_tpu_torch.tables import metrics as metrics_ops
from hypervisor_tpu_torch.tables.logs import DeltaLog, TraceLog
from hypervisor_tpu_torch.tables.metrics import MetricsTable
from hypervisor_tpu_torch.tables.state import AgentTable, SessionTable, VouchTable


# Per-lane status codes for the batched pipeline (host may re-raise).
PIPE_OK = 0
PIPE_SIGMA_BELOW_MIN = 1
PIPE_INACTIVE = 2


class PipelineResult(NamedTuple):
    """One governance tick's outputs, all [S]-shaped (roots [S, 8])."""

    ring: torch.Tensor             # i8[S]  ring assigned at join
    sigma_eff: torch.Tensor        # f32[S]
    session_state: torch.Tensor    # i8[S]  == ARCHIVED for successful lanes
    saga_step_state: torch.Tensor  # i8[S]  == COMMITTED
    merkle_root: torch.Tensor      # int32[S, 8] u32 bits
    status: torch.Tensor           # i8[S]  PIPE_* codes
    consensus: torch.Tensor        # f32[4] global aggregates (see below)


# Session FSM codes (models.SessionState order).
S_CREATED, S_HANDSHAKING, S_ACTIVE, S_TERMINATING, S_ARCHIVED = range(5)


def governance_pipeline(
    sigma_raw: torch.Tensor,       # f32[S] joining agent's raw sigma
    trustworthy: torch.Tensor,     # bool[S] history-verification outcome
    min_sigma_eff: torch.Tensor,   # f32[S] per-session admission floor
    delta_bodies: torch.Tensor,    # int32[T, S, BODY_WORDS] u32 bits, binary delta records
    active: torch.Tensor,          # bool[S] lane mask
    trust: TrustConfig = DEFAULT_CONFIG.trust,
    use_pallas: bool | None = None,
    contribution: torch.Tensor | None = None,  # f32[S] bonded sigma per lane
    omega: torch.Tensor | float = 0.5,
) -> PipelineResult:
    """Run the full governance pipeline for S session lanes on the
    inputs' device.

    With `contribution` (each lane's bonded sigma from its vouchers),
    admission applies sigma_eff = min(sigma_raw + omega * contribution,
    1.0), the multiply and the add rounded apart. `use_pallas` is the
    reference's parameter and is not read: CUDA tensors always take the
    kernels (B2 for the chain, B3 for the roots), CPU tensors their plain
    versions.

    The four consensus values are f32 sums over the S lanes in XLA:CPU's
    reduction order (`ops.liability._row_sum_xla_order`), so they are the
    reference's bit for bit on every device.
    """
    f32_scalar = admission_ops.f32_scalar
    dev = sigma_raw.device
    s = sigma_raw.shape[0]
    t = delta_bodies.shape[0]

    # Constants are filled on the device: a host tensor copied to the card
    # would wait for the stream and serialise the host with the device.
    def i8(code: int) -> torch.Tensor:
        return torch.full((), code, dtype=torch.int8, device=dev)

    # ── 1. admission: vouched sigma -> ring; untrustworthy sandboxed ──
    if contribution is None:
        sigma_eff = sigma_raw
    else:
        sigma_eff = torch.minimum(
            sigma_raw + f32_scalar(omega, dev) * contribution, f32_scalar(1.0, dev)
        )
    no_consensus = torch.zeros((), dtype=torch.bool, device=dev)
    ring = ring_ops.compute_rings(sigma_eff, no_consensus, trust)
    ring = torch.where(trustworthy, ring, i8(3))
    # Non-sandbox joins must clear the session sigma floor.
    sigma_bad = (sigma_eff < min_sigma_eff) & (ring != 3)
    status = torch.where(
        ~active, i8(PIPE_INACTIVE),
        torch.where(sigma_bad, i8(PIPE_SIGMA_BELOW_MIN), i8(PIPE_OK)),
    )
    ok = status == PIPE_OK

    # ── 2. session FSM forward walk, legality-gated per step ─────────
    state = torch.full((s,), S_CREATED, dtype=torch.int8, device=dev)
    state, _ = session_fsm.apply_session_transitions(state, S_HANDSHAKING, ok)
    state, _ = session_fsm.apply_session_transitions(state, S_ACTIVE, ok)

    # ── 3. audit: chain-hash T deltas per lane (B2), then Merkle roots (B3)
    digests = merkle_ops.chain_digests(delta_bodies.contiguous())  # int32[T, S, 8]
    p = 1 << max(0, (t - 1).bit_length())
    leaves = torch.zeros((s, p, 8), dtype=torch.int32, device=dev)
    leaves[:, :t] = digests.transpose(0, 1)
    roots = merkle_ops.merkle_root_lanes(leaves, t)                # int32[S, 8]

    # ── 4. saga: one noop step through the retry ladder ──────────────
    step_state = torch.full((s,), saga_ops.STEP_PENDING, dtype=torch.int8, device=dev)
    step_state, _ = saga_ops.execute_attempt(
        step_state, ok, torch.zeros((s,), dtype=torch.int8, device=dev)
    )

    # ── 5. terminate + archive (legality-gated) ──────────────────────
    state, _ = session_fsm.apply_session_transitions(state, S_TERMINATING, ok)
    state, _ = session_fsm.apply_session_transitions(state, S_ARCHIVED, ok)

    # ── 6. consensus aggregates. Root word 0 is u32: widened, masked,
    # then rounded to f32 (nearest even), as the reference converts it.
    okf = ok.to(torch.float32)
    word0 = (roots[:, 0].to(torch.int64) & 0xFFFFFFFF).to(torch.float32)
    consensus = liability_ops._row_sum_xla_order(torch.stack([
        okf,                                # sessions completed
        sigma_eff * okf,                    # total sigma admitted
        ring.to(torch.float32) * okf,       # ring mass
        word0 * okf,                        # root checksum word
    ]))

    return PipelineResult(
        ring=ring,
        sigma_eff=sigma_eff,
        session_state=state,
        saga_step_state=step_state,
        merkle_root=roots,
        status=status,
        consensus=consensus,
    )


class WaveResult(NamedTuple):
    """One full-pipeline wave over the tables (updated in place)."""

    agents: AgentTable
    sessions: SessionTable
    vouches: VouchTable
    status: torch.Tensor           # i8[B] admission status per joining agent
    ring: torch.Tensor             # i8[B]
    sigma_eff: torch.Tensor        # f32[B] (includes vouched contributions)
    saga_step_state: torch.Tensor  # i8[B]
    merkle_root: torch.Tensor      # int32[K, 8] u32 bits, per wave session
    chain: torch.Tensor            # int32[T, K, 8] u32 bits, the delta chain
    fsm_error: torch.Tensor        # bool[K] illegal session walks
    released: torch.Tensor         # i32[] bonds released at terminate
    metrics: MetricsTable | None = None
    trace: TraceLog | None = None        # the ring the wave stamped, in place
    # The gateway's per-action lanes (agents=None: this result's agents
    # are the post-gateway table) and the sanitizer's masks (metrics=None:
    # this result's metrics carry its counts).
    gateway: gateway_ops.GatewayResult | None = None
    sanitizer: invariants.IntegrityResult | None = None
    delta_log: DeltaLog | None = None    # the ring the wave appended to, in place


class WaveBlocks(NamedTuple):
    """The wave's kernel-backed blocks. `chain_ring` is the delta chain
    with the DeltaLog append (B2's ring form), run when the ring rides;
    `chain` is the chain alone."""

    contribution: Callable
    admission: Callable
    fsm_saga: Callable
    chain: Callable
    chain_ring: Callable
    tree: Callable


#: The dispatching wrappers: kernels for CUDA tensors, plain for CPU.
KERNEL_BLOCKS = WaveBlocks(
    wave.contribution_toward, wave.admission_block, wave.fsm_saga_block, mtu.chain_digests,
    mtu.chain_digests_ring, mtu.tree_roots,
)
#: The plain PyTorch versions on any device (what the kernels are held against).
PLAIN_BLOCKS = WaveBlocks(
    wave.contribution_toward_plain, wave.admission_block_plain, wave.fsm_saga_block_plain,
    mtu.chain_digests_plain, mtu.chain_digests_ring_plain, mtu.tree_roots_plain,
)


class TenantWaveBlocks(NamedTuple):
    """The tenant forms of the wave's kernel-backed blocks (B3 takes the
    T x K lanes flat, so its solo form serves)."""

    contribution: Callable
    admission: Callable
    fsm_saga: Callable
    chain_ring: Callable
    tree: Callable


#: The tenant forms' dispatching wrappers: kernels for CUDA tensors.
TENANT_KERNEL_BLOCKS = TenantWaveBlocks(
    wave.contribution_toward_tenants, wave.admission_block_tenants, wave.fsm_saga_block_tenants,
    mtu.chain_digests_ring_tenants, mtu.tree_roots,
)
#: Their plain versions, each a loop of the solo plain version over the tenants.
TENANT_PLAIN_BLOCKS = TenantWaveBlocks(
    wave.contribution_toward_tenants_plain, wave.admission_block_tenants_plain,
    wave.fsm_saga_block_tenants_plain, mtu.chain_digests_ring_tenants_plain,
    mtu.tree_roots_plain,
)


class TenantWaveResult(NamedTuple):
    """One batched tenant wave over the stacked tables (updated in place);
    each lane column carries a leading tenant axis."""

    agents: AgentTable
    sessions: SessionTable
    vouches: VouchTable
    status: torch.Tensor           # i8[T, B]
    ring: torch.Tensor             # i8[T, B]
    sigma_eff: torch.Tensor        # f32[T, B]
    saga_step_state: torch.Tensor  # i8[T, B]
    merkle_root: torch.Tensor      # int32[T, K, 8]
    chain: torch.Tensor            # int32[T, turns, K, 8]
    fsm_error: torch.Tensor        # bool[T, K]
    released: torch.Tensor         # i32[T]
    metrics: MetricsTable
    delta_log: DeltaLog
    sanitizer: invariants.IntegrityResult | None = None  # masks [T, rows], counts [T]


def governance_wave(
    agents: AgentTable,
    sessions: SessionTable,
    vouches: VouchTable,
    slot: torch.Tensor,           # i32[B] preallocated agent rows
    did: torch.Tensor,            # i32[B]
    session_slot: torch.Tensor,   # i32[B] target session per joining agent
    sigma_raw: torch.Tensor,      # f32[B]
    trustworthy: torch.Tensor,    # bool[B]
    duplicate: torch.Tensor,      # bool[B]
    wave_sessions: torch.Tensor,  # i32[K] sessions that live and die this wave
    delta_bodies: torch.Tensor,   # int32[T, K, 16] u32 bits
    now: float,
    omega: float = 0.5,
    trust: TrustConfig = DEFAULT_CONFIG.trust,
    ring_bursts=None,
    wave_range: tuple[int, int] | None = None,
    unique_sessions: bool = False,
    metrics: MetricsTable | None = None,
    *,
    trace: TraceLog | None = None,
    trace_ctx: tracing.TraceContext | None = None,
    delta_log: DeltaLog | None = None,
    delta_cursor: int | None = None,
    lanes_valid: torch.Tensor | None = None,
    n_sessions_valid: int | None = None,
    elevations=None,
    gateway_args=None,
    breach: BreachConfig = DEFAULT_CONFIG.breach,
    rate_limit: RateLimitConfig = DEFAULT_CONFIG.rate_limit,
    epilogue_tables=None,
    sanitize: bool = False,
    config: HypervisorConfig = DEFAULT_CONFIG,
) -> WaveResult:
    """The full governance pipeline as one wave over the tables.

    `wave_range` (lo, hi) is the caller's host-verified assertion that
    `wave_sessions` is arange(lo, hi), so the fsm/saga kernel tests
    membership by range; without it, by a bitmap of `wave_sessions`.
    `unique_sessions` is the host-verified assertion that no two
    seat-consuming lanes share a session (admission is then one launch). With `metrics`, the wave's counters and the wave-size
    histogram are booked in place.

    With `delta_log`, the wave's audit records (lane-major bodies and
    chain digests, turns 0..T-1) append onto the ring in place, from
    B2's ring form; `delta_cursor` is the caller's host mirror of its
    cursor, which the kernel takes as an argument. With `trace` and
    `trace_ctx`, the root begin/end pair and a begin/end pair per
    `tracing.WAVE_CHILD_STAGES` phase land as one batch.

    Bucket padding: `lanes_valid` (bool[B]) marks the real join lanes
    (pad lanes ride duplicate=True and are refused) and keeps pad lanes
    out of the admission and saga tallies; `n_sessions_valid` (an int)
    counts the real session lanes, a prefix, so only their
    n_sessions_valid * T records append.

    Phase 7: `gateway_args` = (slot, required_ring, is_read_only,
    has_consensus, has_sre_witness, host_tripped, valid), [A] columns
    padded with valid=False lanes, runs the action gateway with
    `elevations`, `breach` and `rate_limit` on the post-terminate agents;
    its lanes return on `WaveResult.gateway`. Phase 8: `epilogue_tables`
    = (sagas, event_log), read only, refreshes the occupancy gauges over
    the post-wave tables (it needs `metrics`; pass `elevations` for their
    row), and `sanitize` adds the invariant sanitizer (thresholds from
    `config`), its masks on `WaveResult.sanitizer`, its counts on
    `metrics`.

    The indices are trusted: on CUDA the kernels neither bound-check
    `slot`, `session_slot` and `wave_sessions` nor check that admitted
    lanes hold distinct agent slots. `HypervisorState.stage_wave` checks
    both on the host; a caller that builds the lanes itself must too.
    """
    return run_wave(
        KERNEL_BLOCKS, agents, sessions, vouches, slot, did, session_slot, sigma_raw,
        trustworthy, duplicate, wave_sessions, delta_bodies, now, omega, trust,
        ring_bursts, wave_range, unique_sessions, metrics, trace=trace, trace_ctx=trace_ctx,
        delta_log=delta_log, delta_cursor=delta_cursor, lanes_valid=lanes_valid,
        n_sessions_valid=n_sessions_valid, elevations=elevations, gateway_args=gateway_args,
        breach=breach, rate_limit=rate_limit, epilogue_tables=epilogue_tables,
        sanitize=sanitize, config=config,
    )


def run_wave(
    blocks: WaveBlocks,
    agents, sessions, vouches, slot, did, session_slot, sigma_raw, trustworthy,
    duplicate, wave_sessions, delta_bodies, now, omega=0.5,
    trust: TrustConfig = DEFAULT_CONFIG.trust, ring_bursts=None, wave_range=None,
    unique_sessions: bool = False, metrics: MetricsTable | None = None, *,
    trace=None, trace_ctx=None, delta_log=None, delta_cursor=None, lanes_valid=None,
    n_sessions_valid=None, elevations=None, gateway_args=None,
    breach: BreachConfig = DEFAULT_CONFIG.breach,
    rate_limit: RateLimitConfig = DEFAULT_CONFIG.rate_limit, epilogue_tables=None,
    sanitize: bool = False, config: HypervisorConfig = DEFAULT_CONFIG,
) -> WaveResult:
    """`governance_wave` through the given blocks: `KERNEL_BLOCKS` is the
    wave itself, `PLAIN_BLOCKS` the same wave through the kernels' plain
    versions on whatever device the tensors are on."""
    if trace is not None and trace_ctx is None:
        raise ValueError("a stamped wave needs trace_ctx")
    if delta_log is not None and delta_cursor is None:
        raise ValueError("the ring append needs delta_cursor, the host mirror of its cursor")
    dev = slot.device
    b = slot.shape[0]
    now_f = admission_ops.f32_scalar(now, dev)

    # Each phase runs in a `stage_scope`: a profiler range `hv.<stage>`,
    # which also attributes its ops to the phase in a roofline count.
    # 1. vouched contributions, scoped to the session each slot joins now.
    with profiling.stage_scope("admission_wave"):
        slot_idx = slot.to(torch.int64)
        target_session = torch.full((agents.i32.shape[0],), -2, dtype=torch.int32, device=dev)
        target_session[slot_idx] = session_slot
        contribution = blocks.contribution(vouches, target_session, now_f)[slot_idx]

        # 2. admission (B4).
        status, ring, sigma_eff = blocks.admission(
            agents, sessions, slot, did, session_slot, sigma_raw, contribution, omega,
            trustworthy, duplicate, now, ring_bursts, trust, unique_sessions,
        )
        ok = status == admission_ops.ADMIT_OK
    if metrics is not None:
        admission_ops.tally_admission(metrics, ok, b, lanes_valid)

    # 3./5./6. session walk, saga step, terminate (B5).
    with profiling.stage_scope("session_fsm"):
        step_state, wave_state, fsm_err, released = blocks.fsm_saga(
            agents, sessions, vouches, wave_sessions, ok, now, wave_range
        )

    # 4. audit: the delta chain (B2; with the ring riding, B2's ring form
    # also appends the live records), Merkle roots over the T leaves (B3).
    t, k = delta_bodies.shape[0], wave_sessions.shape[0]
    with profiling.stage_scope("delta_chain"):
        seeds = torch.zeros((k, 8), dtype=torch.int32, device=dev)
        if delta_log is not None and t > 0:
            n_live = k * t if n_sessions_valid is None else int(n_sessions_valid) * t
            chain = blocks.chain_ring(delta_bodies, seeds, delta_log, wave_sessions,
                                      delta_cursor, n_live)
        else:
            chain = blocks.chain(delta_bodies, seeds)
        p = 1 << max(0, (t - 1).bit_length())
        leaves = torch.zeros((k, p, 8), dtype=torch.int32, device=dev)
        leaves[:, :t] = chain.transpose(0, 1)
        roots = blocks.tree(leaves, torch.full((k,), t, dtype=torch.int32, device=dev))

    # 7. the action gateway, on the post-terminate agents.
    gw_lanes = None
    if gateway_args is not None:
        *act, act_valid = gateway_args
        with profiling.stage_scope("gateway_wave"):
            gw = gateway_ops.check_actions(
                agents, elevations, *act, now_f, valid=act_valid, breach=breach,
                rate_limit=rate_limit, trust=trust, metrics=metrics,
            )
        gw_lanes = gw._replace(agents=None, metrics=None)

    if metrics is not None:
        archived = (wave_state == SessionState.ARCHIVED.code) & ~fsm_err
        committed_col = step_state == saga_ops.STEP_COMMITTED
        failed_col = step_state == saga_ops.STEP_FAILED
        if lanes_valid is not None:
            # Pad lanes are refused joins whose saga step would count as failed.
            committed_col = committed_col & lanes_valid
            failed_col = failed_col & lanes_valid
        committed, failed = tally.count_true(committed_col, failed_col)
        metrics_ops.counter_add_many(
            metrics,
            (
                schema.WAVE_TICKS.index,
                schema.SAGA_STEPS_COMMITTED.index,
                schema.SAGA_STEPS_FAILED.index,
                schema.SESSIONS_ARCHIVED.index,
                schema.BONDS_RELEASED.index,
            ),
            (1, committed, failed, tally.count_true(archived)[0], released),
        )
    if trace is not None:
        widths = {"admission_wave": b, "session_fsm": k, "delta_chain": t, "saga_round": b,
                  "terminate_wave": k}
        stamps = tracing.WaveStamps(trace_ctx, "governance_wave")
        stamps.begin("governance_wave", lane=b)
        for stage in tracing.WAVE_CHILD_STAGES["governance_wave"]:
            stamps.begin(stage, lane=widths[stage])
            stamps.end(stage, lane=widths[stage])
        stamps.end("governance_wave", lane=b)
        stamps.commit(trace)

    # 8. the epilogue over the post-wave tables: gauges, then the sanitizer.
    sanitizer = None
    if epilogue_tables is not None and metrics is not None:
        ep_sagas, ep_event_log = epilogue_tables
        with profiling.stage_scope("epilogue"):
            schema.update_gauges(metrics, agents, sessions, vouches, ep_sagas, elevations,
                                 delta_log, ep_event_log, trace)
            if sanitize:
                bursts = (DEFAULT_CONFIG.rate_limit.ring_bursts if ring_bursts is None
                          else ring_bursts)
                sanitizer = invariants.check_invariants(
                    agents, sessions, vouches, ep_sagas, elevations, delta_log, ep_event_log,
                    trace, bursts, metrics=metrics, config=config,
                )._replace(metrics=None)
    return WaveResult(
        agents=agents, sessions=sessions, vouches=vouches, status=status, ring=ring,
        sigma_eff=sigma_eff, saga_step_state=step_state, merkle_root=roots, chain=chain,
        fsm_error=fsm_err, released=released, metrics=metrics, trace=trace,
        gateway=gw_lanes, sanitizer=sanitizer, delta_log=delta_log,
    )


def tenant_governance_wave(*args, **kwargs) -> TenantWaveResult:
    """The batched tenant wave through the kernels' tenant forms
    (`run_tenant_wave` with `TENANT_KERNEL_BLOCKS`)."""
    return run_tenant_wave(TENANT_KERNEL_BLOCKS, *args, **kwargs)


def run_tenant_wave(
    blocks: TenantWaveBlocks,
    agents: AgentTable,           # every table stacked [T, ...]
    sessions: SessionTable,
    vouches: VouchTable,
    metrics: MetricsTable,
    delta_log: DeltaLog,
    sagas,
    event_log,
    elevations,
    slot: torch.Tensor,           # i32[T, B] each tenant's claimed agent rows
    did: torch.Tensor,            # i32[T, B]
    session_slot: torch.Tensor,   # i32[T, B]
    sigma_raw: torch.Tensor,      # f32[T, B]
    trustworthy: torch.Tensor,    # bool[T, B]
    duplicate: torch.Tensor,      # bool[T, B]
    wave_sessions: torch.Tensor,  # i32[T, K], tenant t's = arange(range_lo[t], range_hi[t])
    delta_bodies: torch.Tensor,   # int32[T, turns, K, 16] u32 bits
    range_lo,                     # [T] host ints
    range_hi,
    lanes_valid: torch.Tensor,    # bool[T, B]
    n_sessions_valid,             # [T] host ints: each tenant's real sessions, a prefix
    now: float,
    omega: float = 0.5,
    ring_bursts=None,
    *,
    delta_cursors,                # [T] host mirrors of each tenant's DeltaLog cursor
    trust: TrustConfig = DEFAULT_CONFIG.trust,
    sanitize: bool = False,
    config: HypervisorConfig = DEFAULT_CONFIG,
) -> TenantWaveResult:
    """T tenants' governance waves as one wave over their stacked tables,
    IN PLACE: per tenant, `run_wave` with `wave_range=(range_lo[t],
    range_hi[t])`, `unique_sessions=False`, `lanes_valid`,
    `n_sessions_valid`, the DeltaLog riding at the tenant's cursor, the
    epilogue over its sagas and event log and no trace ring or gateway."""
    dev = slot.device
    t_count, b = slot.shape
    k = wave_sessions.shape[1]
    turns = delta_bodies.shape[1]
    now_f = admission_ops.f32_scalar(now, dev)

    # 1./2. contributions toward each tenant's joining rows, admission.
    with profiling.stage_scope("admission_wave"):
        slot_idx = slot.to(torch.int64)
        target_session = torch.full((t_count, agents.i32.shape[1]), -2, dtype=torch.int32,
                                    device=dev)
        target_session.scatter_(1, slot_idx, session_slot)
        contribution = torch.gather(blocks.contribution(vouches, target_session, now_f), 1,
                                    slot_idx)
        status, ring, sigma_eff = blocks.admission(
            agents, sessions, slot, did, session_slot, sigma_raw, contribution, omega,
            trustworthy, duplicate, now, ring_bursts, trust,
        )
        ok = status == admission_ops.ADMIT_OK
    admission_ops.tally_admission(metrics, ok, b, lanes_valid)

    # 3./5./6. each tenant's session walk, saga step, terminate.
    with profiling.stage_scope("session_fsm"):
        step_state, wave_state, fsm_err, released = blocks.fsm_saga(
            agents, sessions, vouches, wave_sessions, ok, now, range_lo, range_hi,
        )

    # 4. audit: every tenant's chains and ring appends, then the roots of
    # all T x K lanes.
    with profiling.stage_scope("delta_chain"):
        seeds = torch.zeros((t_count, k, 8), dtype=torch.int32, device=dev)
        n_live = [int(n) * turns for n in n_sessions_valid]
        chain = blocks.chain_ring(delta_bodies.transpose(0, 1).contiguous(), seeds, delta_log,
                                  wave_sessions, delta_cursors, n_live)
        p = 1 << max(0, (turns - 1).bit_length())
        leaves = torch.zeros((t_count * k, p, 8), dtype=torch.int32, device=dev)
        leaves[:, :turns] = chain.permute(1, 2, 0, 3).reshape(t_count * k, turns, 8)
        roots = blocks.tree(
            leaves, torch.full((t_count * k,), turns, dtype=torch.int32, device=dev)
        ).reshape(t_count, k, 8)

    archived = (wave_state == SessionState.ARCHIVED.code) & ~fsm_err
    committed, failed = tally.count_true(
        (step_state == saga_ops.STEP_COMMITTED) & lanes_valid,
        (step_state == saga_ops.STEP_FAILED) & lanes_valid,
    )
    metrics_ops.counter_add_many(
        metrics,
        (
            schema.WAVE_TICKS.index,
            schema.SAGA_STEPS_COMMITTED.index,
            schema.SAGA_STEPS_FAILED.index,
            schema.SESSIONS_ARCHIVED.index,
            schema.BONDS_RELEASED.index,
        ),
        (1, committed, failed, tally.count_true(archived)[0], released),
    )

    # 8. the epilogue over every tenant's post-wave tables.
    sanitizer = None
    with profiling.stage_scope("epilogue"):
        schema.update_gauges(metrics, agents, sessions, vouches, sagas, elevations, delta_log,
                             event_log, None)
        if sanitize:
            bursts = DEFAULT_CONFIG.rate_limit.ring_bursts if ring_bursts is None else ring_bursts
            sanitizer = invariants.check_invariants(
                agents, sessions, vouches, sagas, elevations, delta_log, event_log, None,
                bursts, metrics=metrics, config=config,
            )._replace(metrics=None)
    return TenantWaveResult(
        agents=agents, sessions=sessions, vouches=vouches, status=status, ring=ring,
        sigma_eff=sigma_eff, saga_step_state=step_state, merkle_root=roots,
        chain=chain.transpose(0, 1), fsm_error=fsm_err, released=released, metrics=metrics,
        delta_log=delta_log, sanitizer=sanitizer,
    )


def tenant_sessions_create(
    sessions: SessionTable,       # stacked [T, S]
    rows: torch.Tensor,           # i32[T, K] each tenant's new session rows
    sids: torch.Tensor,           # i32[T, K]
    valid: torch.Tensor,          # bool[T, K] the real lanes (tenants create ragged counts)
    state_code: int,
    mode_code: int,
    max_participants: int,
    min_sigma_eff: float,
    enable_audit: bool,
) -> SessionTable:
    """Initialise every tenant's freshly allocated session rows IN PLACE,
    one write for the whole arena (the reference's
    `state._tenant_sessions_create_fn`): each valid lane's row gets the
    solo `create_sessions_batch`'s columns; invalid lanes write nothing."""
    from hypervisor_tpu_torch.tables.state import (
        SF32_MIN_SIGMA, SI32_MAX_PARTICIPANTS, SI32_MODE, SI32_SID, SI32_STATE,
    )

    s_cap = sessions.i32.shape[1]
    flat = (torch.arange(rows.shape[0], dtype=torch.int64, device=rows.device)[:, None] * s_cap
            + rows.to(torch.int64))[valid]
    i32 = sessions.i32.view(-1, sessions.i32.shape[-1])
    i32[flat, SI32_SID] = sids[valid]
    i32[flat, SI32_STATE] = int(state_code)
    i32[flat, SI32_MODE] = int(mode_code)
    i32[flat, SI32_MAX_PARTICIPANTS] = int(max_participants)
    sessions.f32.view(-1, sessions.f32.shape[-1])[flat, SF32_MIN_SIGMA] = float(
        np.float32(min_sigma_eff))
    sessions.enable_audit.view(-1)[flat] = bool(enable_audit)
    return sessions
