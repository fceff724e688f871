"""The invariant sanitizer (`hypervisor_tpu.integrity.invariants`): the
system's own rules, re-checked on the device over every table, ring and
log, the sampled half of the governance wave's epilogue.

It checks that sigma lies in [0, 1]; rings lie in 0..3 and a privileged
ring has the sigma that earns it; token buckets hold a sane level; flag
words use only the defined bits; memberships name a real session; edges
name real agents with sane bonds, and no voucher has more than
ESCROW_CAP of sigma locked across its active bonds; session, saga and
elevation codes are in range; ring cursors are sane, and each session's
surviving DeltaLog turns are a contiguous, duplicate-free run.

The result is a violation bitmask per row of each table (u32 bits held
in int32, the package's convention) and two counts, booked into the
metrics table without a host transfer. Tables stacked over tenants
(`[T, ...]`, the tenant wave's epilogue) check per tenant in the same
ops: masks [T, rows], counts [T]. `repair_*` are the deterministic
fixes for the repairable classes (clamp, recompute, mask, deactivate,
quarantine the row); the restore classes need a checkpoint.

No kernel of its own, as in the reference, with one exception: the
escrow is a sum of f32 bonds per voucher, which the reference adds in
edge order. A CUDA scatter-add sums in no fixed order, so the escrow
goes through the vouched contribution's kernel (`kernels.wave.
contribution_toward`), which folds each key's values in edge order: here
keyed by voucher, every edge in one scope.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hypervisor_tpu_torch.config import DEFAULT_CONFIG, HypervisorConfig
from hypervisor_tpu_torch.observability import metrics as schema
from hypervisor_tpu_torch.ops import rate_limit as rate_ops
from hypervisor_tpu_torch.ops import rings as ring_ops
from hypervisor_tpu_torch.ops import security_ops, tally
from hypervisor_tpu_torch.tables import metrics as metrics_ops
from hypervisor_tpu_torch.tables.metrics import MetricsTable
from hypervisor_tpu_torch.tables.state import FLAG_ACTIVE, KNOWN_FLAGS_MASK, VouchTable
from hypervisor_tpu_torch.tables.struct import replace

# ── the violation bits, per table, and their repair class ────────────
#   repair  — a deterministic fix in place (clamp, recompute, mask)
#   contain — the row, edge or grant is neutralised (quarantine, deactivate)
#   restore — only a checkpoint can be trusted

A_SIGMA_RANGE = 1 << 0    # repair: clamp to [0, 1]
A_RING_RANGE = 1 << 1     # repair: recompute from sigma_eff
A_RING_SIGMA = 1 << 2     # repair: recompute from sigma_eff
A_RL_TOKENS = 1 << 3      # repair: clamp to [0, burst(ring)]
A_FLAGS = 1 << 4          # repair: mask to KNOWN_FLAGS_MASK
A_SESSION_REF = 1 << 5    # contain: quarantine the row

S_STATE_CODE = 1 << 0     # restore
S_MODE_CODE = 1 << 1      # restore
S_NPART = 1 << 2          # repair: clamp to [0, max_participants]
S_TIME = 1 << 3           # restore

V_ENDPOINT = 1 << 0       # contain: deactivate the edge
V_BOND = 1 << 1           # contain: deactivate the edge
V_ESCROW = 1 << 2         # restore (conservation break)

G_STATE = 1 << 0          # restore
G_CURSOR = 1 << 1         # restore
G_NSTEPS = 1 << 2         # restore
G_STEP_STATE = 1 << 3     # restore

E_RANGE = 1 << 0          # contain: deactivate the grant

L_CURSOR = 1 << 0         # restore
L_DELTA_ROW = 1 << 1      # restore (a live row's session or turn out of range)
L_TURN_CHAIN = 1 << 2     # restore (a session's turns not contiguous)

#: Escrow conservation cap: sigma lies in [0, 1], so one voucher can never
#: have more than about 1.0 of sigma locked across its active bonds.
ESCROW_CAP = 1.0 + 1e-4

#: Code ranges of the session FSM, the consistency modes, the saga FSM
#: and the step states.
N_SESSION_STATES = 5
N_CONSISTENCY_MODES = 2
N_SAGA_STATES = 5
N_STEP_STATES = 7

REPAIRABLE_AGENT_BITS = A_SIGMA_RANGE | A_RING_RANGE | A_RING_SIGMA | A_RL_TOKENS | A_FLAGS
CONTAIN_AGENT_BITS = A_SESSION_REF
REPAIRABLE_SESSION_BITS = S_NPART
CONTAIN_VOUCH_BITS = V_ENDPOINT | V_BOND

#: (table, check, class, bit), one entry per violation bit.
CATALOG: tuple[tuple[str, str, str, int], ...] = (
    ("agents", "sigma_range", "repair", A_SIGMA_RANGE),
    ("agents", "ring_range", "repair", A_RING_RANGE),
    ("agents", "ring_sigma", "repair", A_RING_SIGMA),
    ("agents", "rl_tokens", "repair", A_RL_TOKENS),
    ("agents", "flags", "repair", A_FLAGS),
    ("agents", "session_ref", "contain", A_SESSION_REF),
    ("sessions", "state_code", "restore", S_STATE_CODE),
    ("sessions", "mode_code", "restore", S_MODE_CODE),
    ("sessions", "n_participants", "repair", S_NPART),
    ("sessions", "timestamps", "restore", S_TIME),
    ("vouches", "endpoint", "contain", V_ENDPOINT),
    ("vouches", "bond", "contain", V_BOND),
    ("vouches", "escrow_conservation", "restore", V_ESCROW),
    ("sagas", "state_code", "restore", G_STATE),
    ("sagas", "cursor", "restore", G_CURSOR),
    ("sagas", "n_steps", "restore", G_NSTEPS),
    ("sagas", "step_state", "restore", G_STEP_STATE),
    ("elevations", "range", "contain", E_RANGE),
    ("logs", "cursor", "restore", L_CURSOR),
    ("logs", "delta_row", "restore", L_DELTA_ROW),
    ("logs", "turn_chain", "restore", L_TURN_CHAIN),
)


class IntegrityResult(NamedTuple):
    """One sanitizer pass: per-row violation bitmasks (u32 bits as int32)
    and the global counts, all on the device."""

    agent_mask: torch.Tensor    # [N]
    session_mask: torch.Tensor  # [S]
    vouch_mask: torch.Tensor    # [E]
    saga_mask: torch.Tensor     # [G]
    elev_mask: torch.Tensor     # [M]
    log_mask: torch.Tensor      # [3]: delta log, event log, trace log
    total: torch.Tensor         # i32[] violating rows, all tables
    unrepairable: torch.Tensor  # i32[] rows that need a checkpoint restore
    metrics: MetricsTable | None


def _f32(x) -> float:
    return float(np.float32(x))


def _bits(cond: torch.Tensor, bit: int) -> torch.Tensor:
    """int32 `bit` where cond holds, else 0."""
    return cond.to(torch.int32) * bit


def _max_burst(ring_bursts):
    if isinstance(ring_bursts, torch.Tensor):
        return ring_bursts.to(torch.float32).max()
    return max(_f32(b) for b in ring_bursts)


def _check_agents(agents, n_sessions: int, ring_bursts, trust) -> tuple:
    """(mask [N], restore-class rows bool[N]: none)."""
    allocated = agents.did >= 0
    active = allocated & ((agents.flags & FLAG_ACTIVE) != 0)
    raw, eff = agents.sigma_raw, agents.sigma_eff
    sigma_bad = allocated & ~(
        torch.isfinite(raw) & torch.isfinite(eff) & (raw >= 0.0) & (raw <= 1.0)
        & (eff >= 0.0) & (eff <= 1.0))
    ring = agents.ring.to(torch.int32)
    ring_bad = (ring < 0) | (ring > 3)
    # A privileged ring (0/1) on an active row needs at least the ring-2 bar.
    priv_bad = active & ~ring_bad & (ring <= 1) & (eff < _f32(trust.ring2_threshold))
    tokens = agents.rl_tokens
    tokens_bad = allocated & ~(
        torch.isfinite(tokens) & (tokens >= 0.0) & (tokens <= _max_burst(ring_bursts)))
    flags_bad = (agents.flags & ~KNOWN_FLAGS_MASK) != 0
    sess_bad = active & ((agents.session < -1) | (agents.session >= n_sessions))
    mask = (_bits(sigma_bad, A_SIGMA_RANGE) | _bits(ring_bad, A_RING_RANGE)
            | _bits(priv_bad, A_RING_SIGMA) | _bits(tokens_bad, A_RL_TOKENS)
            | _bits(flags_bad, A_FLAGS) | _bits(sess_bad, A_SESSION_REF))
    return mask, torch.zeros_like(sess_bad)


def _check_sessions(sessions) -> tuple:
    live = sessions.sid >= 0
    state, mode, npart = sessions.state, sessions.mode, sessions.n_participants
    state_bad = live & ((state < 0) | (state >= N_SESSION_STATES))
    mode_bad = live & ((mode < 0) | (mode >= N_CONSISTENCY_MODES))
    npart_bad = live & ((npart < 0) | (npart > sessions.max_participants))
    time_bad = live & ~(torch.isfinite(sessions.created_at) & (sessions.max_duration >= 0.0))
    mask = (_bits(state_bad, S_STATE_CODE) | _bits(mode_bad, S_MODE_CODE)
            | _bits(npart_bad, S_NPART) | _bits(time_bad, S_TIME))
    return mask, state_bad | mode_bad | time_bad


def _escrow(vouches: VouchTable, counted: torch.Tensor, bonds: torch.Tensor, n_agents: int):
    """f32[N]: the counted edges' bonds summed per voucher in edge order
    (the contribution kernel's fold, every edge in one scope); f32[T, N]
    through its tenant form for stacked tables."""
    from hypervisor_tpu_torch.kernels import wave as wave_kernels

    dev = bonds.device
    lead = bonds.shape[:-1]
    keyed = VouchTable(
        voucher=vouches.voucher, vouchee=vouches.voucher.clamp(0, n_agents - 1),
        session=torch.zeros(bonds.shape, dtype=torch.int32, device=dev),
        bond_pct=vouches.bond_pct, bond=bonds, active=counted,
        expiry=torch.full(bonds.shape, float("inf"), dtype=torch.float32, device=dev),
    )
    scope = torch.zeros(lead + (n_agents,), dtype=torch.int32, device=dev)
    if lead:
        return wave_kernels.contribution_toward_tenants(keyed, scope, 0.0)
    return wave_kernels.contribution_toward(keyed, scope, 0.0)


def _check_vouches(vouches, n_agents: int) -> tuple:
    active = vouches.active
    voucher, vouchee = vouches.voucher, vouches.vouchee
    endpoint_bad = active & ((voucher < 0) | (voucher >= n_agents) | (vouchee < 0)
                             | (vouchee >= n_agents))
    bond = vouches.bond
    bond_bad = active & ~(torch.isfinite(bond) & (bond >= 0.0) & (vouches.bond_pct >= 0.0)
                          & (vouches.bond_pct <= 1.0))
    # Conservation: a voucher's escrow (its active bonds) stays under the
    # cap. Edges already flagged for a bad endpoint stay out of it.
    counted = active & ~endpoint_bad
    bonds = torch.where(counted, torch.nan_to_num(bond, nan=0.0, posinf=_f32(3.4e38), neginf=0.0),
                        torch.zeros((), dtype=torch.float32, device=bond.device))
    escrow = _escrow(vouches, counted, bonds, n_agents)
    safe = voucher.clamp(0, n_agents - 1).to(torch.int64)
    escrow_bad = counted & (torch.gather(escrow, -1, safe) > _f32(ESCROW_CAP))
    mask = _bits(endpoint_bad, V_ENDPOINT) | _bits(bond_bad, V_BOND) | _bits(escrow_bad, V_ESCROW)
    return mask, escrow_bad


def _check_sagas(sagas) -> tuple:
    live = sagas.session >= 0
    max_steps = sagas.step_state.shape[-1]
    state_bad = live & ((sagas.saga_state < 0) | (sagas.saga_state >= N_SAGA_STATES))
    cursor_bad = live & ((sagas.cursor < 0) | (sagas.cursor > max_steps))
    nsteps_bad = live & ((sagas.n_steps < 0) | (sagas.n_steps > max_steps))
    step = sagas.step_state
    step_bad = live & ((step < 0) | (step >= N_STEP_STATES)).any(dim=-1)
    mask = (_bits(state_bad, G_STATE) | _bits(cursor_bad, G_CURSOR)
            | _bits(nsteps_bad, G_NSTEPS) | _bits(step_bad, G_STEP_STATE))
    return mask, state_bad | cursor_bad | nsteps_bad | step_bad


def _check_elevations(elevations, n_agents: int) -> tuple:
    ring = elevations.granted_ring.to(torch.int32)
    agent = elevations.agent
    bad = elevations.active & ((agent < 0) | (agent >= n_agents) | (ring < 0) | (ring > 3))
    return _bits(bad, E_RANGE), torch.zeros_like(bad)


def _check_delta_ring(delta_log, n_sessions: int) -> torch.Tensor:
    """int32[] L_* bits for the DeltaLog ring (int32[T] for T stacked rings).

    Within the live rows each session's surviving turns are a contiguous,
    duplicate-free run (appends stamp increasing turns and a wrap evicts
    only the oldest rows). Contiguity over [min, max] with the right count
    and the exact arithmetic-series sum pin all three: a rewritten,
    duplicated or vanished turn breaks at least one."""
    capacity = delta_log.body.shape[-2]
    cursor = delta_log.cursor
    dev = cursor.device
    lead = cursor.shape
    bits = _bits(cursor < 0, L_CURSOR)
    live = (torch.arange(capacity, dtype=torch.int32, device=dev)
            < torch.clamp(cursor, 0, capacity)[..., None])
    sess, turn = delta_log.session, delta_log.turn
    tracked = live & (sess >= 0)
    row_bad = live & ((sess < -1) | (sess >= n_sessions) | (tracked & (turn < 0)))
    bits = bits | _bits(tally.count_true_1d(row_bad) > 0, L_DELTA_ROW)

    # Each tenant's sessions take their own rows of one flat table.
    tenants = int(np.prod(lead, dtype=np.int64))
    offset = (torch.arange(tenants, dtype=torch.int64, device=dev) * n_sessions).reshape(
        lead + (1,))
    safe = (sess.clamp(0, n_sessions - 1).to(torch.int64) + offset).reshape(-1)
    big = 2**30
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    neg_big = torch.full((), -big, dtype=torch.int32, device=dev)
    # Integer sums (exact in any order) and maxima: min(x) = -max(-x).
    sums = torch.zeros((tenants * n_sessions, 2), dtype=torch.int32, device=dev).index_add_(
        0, safe, torch.stack([tracked.to(torch.int32), torch.where(tracked, turn, zero)],
                             dim=-1).reshape(-1, 2))
    count, tsum = sums[:, 0], sums[:, 1]
    exts = torch.full((tenants * n_sessions, 2), -big, dtype=torch.int32,
                      device=dev).scatter_reduce_(
        0, safe[:, None].expand(safe.shape[0], 2),
        torch.stack([torch.where(tracked, turn, neg_big), torch.where(tracked, -turn, neg_big)],
                    dim=-1).reshape(-1, 2),
        "amax")
    tmax, tmin = exts[:, 0], -exts[:, 1]
    present = count > 0
    contiguous = count == (tmax - tmin + 1)
    series = 2 * tsum == (tmin + tmax) * count
    chain_bad = (present & ~(contiguous & series)).reshape(lead + (n_sessions,))
    return bits | _bits(tally.count_true_1d(chain_bad) > 0, L_TURN_CHAIN)


def _cursor_bits(log) -> torch.Tensor:
    return _bits(log.cursor < 0, L_CURSOR)


def check_invariants(
    agents, sessions, vouches, sagas, elevations, delta_log, event_log, trace_log,
    ring_bursts, metrics: MetricsTable | None = None,
    config: HypervisorConfig = DEFAULT_CONFIG,
) -> IntegrityResult:
    """Re-check every invariant over the tables, rings and logs; with
    `metrics`, book the pass IN PLACE. No host transfer."""
    n_agents = agents.did.shape[-1]
    n_sessions = sessions.sid.shape[-1]
    agent_mask, agent_restore = _check_agents(agents, n_sessions, ring_bursts, config.trust)
    session_mask, session_restore = _check_sessions(sessions)
    vouch_mask, vouch_restore = _check_vouches(vouches, n_agents)
    saga_mask, saga_restore = _check_sagas(sagas)
    elev_mask, _ = _check_elevations(elevations, n_agents)
    dev = agent_mask.device
    trace_bits = (_cursor_bits(trace_log) if trace_log is not None
                  else torch.zeros(agent_mask.shape[:-1], dtype=torch.int32, device=dev))
    log_mask = torch.stack([_check_delta_ring(delta_log, n_sessions), _cursor_bits(event_log),
                            trace_bits], dim=-1)
    total = tally.count_true_1d(torch.cat([
        agent_mask != 0, session_mask != 0, vouch_mask != 0, saga_mask != 0, elev_mask != 0,
        log_mask != 0], dim=-1))
    unrepairable = tally.count_true_1d(torch.cat([
        agent_restore, session_restore, vouch_restore, saga_restore, log_mask != 0], dim=-1))
    if metrics is not None:
        book_sanitizer_metrics(metrics, total, unrepairable)
    return IntegrityResult(
        agent_mask=agent_mask, session_mask=session_mask, vouch_mask=vouch_mask,
        saga_mask=saga_mask, elev_mask=elev_mask, log_mask=log_mask, total=total,
        unrepairable=unrepairable, metrics=metrics,
    )


def book_sanitizer_metrics(metrics: MetricsTable, total, unrepairable) -> None:
    """Book one sanitizer pass, IN PLACE: a check and its violating rows
    on the counters, the violating and restore-class rows on the gauges."""
    metrics_ops.counter_add_many(
        metrics, (schema.INTEGRITY_CHECKS.index, schema.INTEGRITY_VIOLATIONS.index), (1, total))
    metrics_ops.gauge_set_many(
        metrics,
        (schema.INTEGRITY_VIOLATION_ROWS.index, schema.INTEGRITY_UNREPAIRABLE_ROWS.index),
        (total, unrepairable),
    )


# ── deterministic repairs (the ladder's first rung) ──────────────────


def repair_agents(agents, mask: torch.Tensor, ring_bursts, now, quarantine_duration,
                  config: HypervisorConfig = DEFAULT_CONFIG):
    """A copy of the agents with every repairable violation fixed: sigma
    clamped first, rings recomputed from the clamped sigma, flags masked,
    tokens clamped to the repaired ring's burst; contained rows
    (A_SESSION_REF) enter quarantine (`security_ops.quarantine_enter`)."""
    def clamp01(x):
        return torch.clamp(torch.nan_to_num(x, nan=0.0, posinf=1.0, neginf=0.0), 0.0, 1.0)

    sigma_bad = (mask & A_SIGMA_RANGE) != 0
    sigma_raw = torch.where(sigma_bad, clamp01(agents.sigma_raw), agents.sigma_raw)
    sigma_eff = torch.where(sigma_bad, clamp01(agents.sigma_eff), agents.sigma_eff)
    ring_bad = (mask & (A_RING_RANGE | A_RING_SIGMA)) != 0
    ring = torch.where(ring_bad, ring_ops.compute_rings(sigma_eff, False, config.trust),
                       agents.ring).to(torch.int8)
    flags_bad = (mask & A_FLAGS) != 0
    flags = torch.where(flags_bad, agents.flags & KNOWN_FLAGS_MASK, agents.flags)
    tokens_bad = (mask & A_RL_TOKENS) != 0
    if isinstance(ring_bursts, torch.Tensor):
        burst = ring_bursts.to(torch.float32)[ring.to(torch.int64).clamp(0, 3)]
    else:
        burst = rate_ops.per_ring(ring, ring_bursts)
    tokens = torch.where(
        tokens_bad,
        torch.minimum(torch.clamp(torch.nan_to_num(agents.rl_tokens, nan=0.0, posinf=0.0,
                                                   neginf=0.0), min=0.0), burst),
        agents.rl_tokens)
    repaired = replace(agents, sigma_raw=sigma_raw, sigma_eff=sigma_eff, flags=flags,
                       rl_tokens=tokens, ring=ring)
    return security_ops.quarantine_enter(repaired, (mask & A_SESSION_REF) != 0, now,
                                         quarantine_duration)


def repair_sessions(sessions, mask: torch.Tensor):
    """A copy with participant counts clamped (the one repairable class)."""
    bad = (mask & S_NPART) != 0
    npart = sessions.n_participants
    clamped = torch.minimum(torch.clamp(npart, min=0), sessions.max_participants)
    return replace(sessions, n_participants=torch.where(bad, clamped, npart))


def repair_vouches(vouches, mask: torch.Tensor):
    """A copy with the edges of corrupt endpoints or bonds deactivated."""
    bad = (mask & CONTAIN_VOUCH_BITS) != 0
    return replace(vouches, active=vouches.active & ~bad)


def repair_elevations(elevations, mask: torch.Tensor):
    """A copy with the grants of corrupt holders or rings retired."""
    bad = (mask & E_RANGE) != 0
    return replace(elevations, active=elevations.active & ~bad,
                   agent=torch.where(bad, torch.full_like(elevations.agent, -1), elevations.agent))
