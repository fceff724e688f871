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
"""

from __future__ import annotations

from typing import Callable, NamedTuple

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
from hypervisor_tpu_torch.ops import saga_ops, tally
from hypervisor_tpu_torch.tables import metrics as metrics_ops
from hypervisor_tpu_torch.tables.logs import DeltaLog, TraceLog
from hypervisor_tpu_torch.tables.metrics import MetricsTable
from hypervisor_tpu_torch.tables.state import AgentTable, SessionTable, VouchTable


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
    liability_ops.contribution_toward, wave.admission_block_plain, wave.fsm_saga_block_plain,
    mtu.chain_digests_plain, mtu.chain_digests_ring_plain, mtu.tree_roots_plain,
)


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
