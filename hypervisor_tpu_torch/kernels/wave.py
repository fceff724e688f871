"""The wave's table kernels for Hopper: admission (B4) and the FSM + saga
+ terminate walk (B5), and B6's plain version (its kernel is B2's ring
form, `kernels.mtu.chain_digests_ring`).

B4 `admission_block` replaces `hypervisor_tpu/kernels/wave_pallas.py`
`admission_block_pallas`. It is bound by memory traffic: a few dozen
integer operations per lane against ~30 bytes of lane inputs, a
gathered session row and, per admitted lane, a 117-byte agent row
written at a random slot, so its time is launches and latency. On the
unique-sessions layout (the host checked that no two seat-consuming
lanes share a session) it is one launch: each lane checks capacity
against its own read of its session's count and writes it back.
Otherwise two: a per-lane pass settles each lane up to the capacity
check and snapshots the seat counts, so every check sees pre-wave
counts; then a block per tile of lanes ranks each lane among the
earlier lanes of its session (a shared-memory hash table of the tile's
sessions, into which every earlier tile's requests are counted) and
writes. Each admitted lane writes its own row, the f32 half as two
16-byte stores. Unlike the TPU kernel it takes any lane count (no
power-of-two bitonic network, no VMEM caps). Without a contribution
(`contribution=None`: the join queue's `HypervisorState.flush_joins`)
sigma_eff is sigma_raw bit for bit, as the reference's `admit_batch`
keeps it: no clamp to 1, -0.0 stays -0.0.

B5 `fsm_saga_block` replaces `hypervisor_tpu/kernels/wave_pallas.py`
`fsm_saga_block_pallas`, also bound by memory traffic (it streams the
vouch edges and the agents' session column once). One launch whose
blocks each take one role: the session walk, the saga steps, the bond
release (one atomic per warp for the count) or the participant
deactivation, so the walk's dependent gathers run beside the streams.
Membership is the range [lo, hi) when the caller asserts the wave's
sessions are arange(lo, hi) (`wave_range`); otherwise each edge and
agent block builds the wave's sessions as a bitmap of the session
table in shared memory, so any layout runs in the same single launch.

B6, the DeltaLog ring append (`hypervisor_tpu/kernels/wave_pallas.py`
`ring_append_pallas`), runs as the epilogue of B2's ring form
(`kernels.mtu.chain_digests_ring`), which already holds every body and
digest the append writes; `ring_append_plain` below is B6's plain
version, the second half of the ring form's.

`contribution_toward` replaces the scatter-add of
`hypervisor_tpu/ops/liability.py` `contribution_toward` (an XLA scatter
in the reference, no Pallas kernel). `index_add_` on CUDA sums with
atomics in no fixed order, so a vouchee with several live scoped edges
could get other f32 bits than the reference's edge-order sum, and the
free edges all add +0.0 to slot 0 under contention. Here one C call
runs five launches with the scoped test on the device and no sort of
the table: each live scoped edge counts itself into its vouchee's bucket
(integer atomics), one block scans the counts into offsets, each edge
writes its index into its bucket, and each vouchee orders its bucket by
edge index and folds its bonds in that order (a thread for up to 32
edges, a block that sorts a larger bucket). Edges that add nothing touch
no output. Bound by memory traffic; at the wave's size by launch latency.

The tenant forms (`contribution_toward_tenants`, `admission_block_tenants`,
`fsm_saga_block_tenants`) take T tenants' tables stacked along a leading
axis (`tables.struct.stack`) and their lanes as [T, ...] columns, and
launch as many times for T tenants as the solo form does for one: the
reference batches its wave over tenants with `jax.vmap`, whose Pallas
batching rule puts the tenant axis on each kernel's grid. B5's reads its
tenant from the grid (one row of blocks a tenant, `blockIdx.y`), the
others from the element's flat index, and each offsets its rows by the
tenant's table; their plain versions loop over the tenants' views
(`tables.struct.tenant_view`) through the solo plain versions.

All compile with --fmad=false, so sigma + omega * c rounds like the
reference. Sources: `csrc/wave.cu`. The plain versions below are what
CPU tensors run and what the kernels are held against on the card.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from hypervisor_tpu_torch.config import DEFAULT_CONFIG, TrustConfig
from hypervisor_tpu_torch.kernels import _build, work
from hypervisor_tpu_torch.kernels.mtu import _check_operand, _require, _route, _wrote
from hypervisor_tpu_torch.models import SessionState
from hypervisor_tpu_torch.ops import admission as admission_ops
from hypervisor_tpu_torch.ops import liability as liability_ops
from hypervisor_tpu_torch.ops import saga_ops, session_fsm
from hypervisor_tpu_torch.ops import terminate as terminate_ops
from hypervisor_tpu_torch.tables.logs import DeltaLog
from hypervisor_tpu_torch.tables.struct import tenant_view
from hypervisor_tpu_torch.tables.state import (
    AF32_WIDTH,
    AI32_SESSION,
    AI32_WIDTH,
    SF32_TERMINATED_AT,
    SF32_WIDTH,
    SI32_NPART,
    SI32_STATE,
    SI32_WIDTH,
    AgentTable,
    SessionTable,
    VouchTable,
)

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint

_ACTIVE = SessionState.ACTIVE.code
_TERMINATING = SessionState.TERMINATING.code
_ARCHIVED = SessionState.ARCHIVED.code


def _host_f32(x) -> float:
    """A scalar operand as the float32 value the kernel receives."""
    return float(np.float32(float(x)))


def _bursts(bursts) -> list[float]:
    if bursts is None:
        bursts = DEFAULT_CONFIG.rate_limit.ring_bursts
    if isinstance(bursts, torch.Tensor):
        bursts = bursts.tolist()
    _require(len(bursts) == 4, "ring_bursts: 4 values")
    return [_host_f32(b) for b in bursts]


# ── the vouched contribution ─────────────────────────────────────────


def contribution_toward(
    vouches: VouchTable,
    target_session_of_slot: torch.Tensor,  # i32[N] session each slot is joining
    now,
) -> torch.Tensor:
    """f32[N] bonded sigma toward each agent slot, scoped to the session
    it is joining, summed in edge order. CUDA tensors launch the kernels
    (`now` may be a device scalar, read on the device); CPU tensors take
    the plain `ops.liability.contribution_toward`."""
    if not _route(vouches.bond):
        return liability_ops.contribution_toward(vouches, target_session_of_slot, now)
    dev = vouches.bond.device
    n, e = target_session_of_slot.shape[0], vouches.bond.shape[0]
    cols = [  # (tensor, name, dtype, length)
        (vouches.vouchee, "vouches.vouchee", torch.int32, e),
        (vouches.session, "vouches.session", torch.int32, e),
        (vouches.active, "vouches.active", torch.bool, e),
        (vouches.expiry, "vouches.expiry", torch.float32, e),
        (vouches.bond, "vouches.bond", torch.float32, e),
        (target_session_of_slot, "target_session_of_slot", torch.int32, n),
    ]
    for t, name, dtype, length in cols:
        _check_operand(t, name, dtype, dev)
        _require(tuple(t.shape) == (length,), f"{name}: expected shape ({length},)")
    now_t = admission_ops.f32_scalar(now, dev)
    # int32 scratch: the counts (zeroed), then offsets, the large-bucket
    # list, each edge's place and the buckets.
    scratch = torch.zeros((n + n + 1 + n + 2 * e,), dtype=torch.int32, device=dev)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    fn = _build.entry("wave", "hv_contribution", [_P] * 9 + [_I, _I, _P])
    err = fn(*(col[0].data_ptr() for col in cols), now_t.data_ptr(), scratch.data_ptr(),
             out.data_ptr(), e, n, torch.cuda.current_stream(dev).cuda_stream)
    _build.check("wave", err, "contribution_toward")
    contribution_toward.launches += 1
    work.note_launch("contribution_toward", edges=e, agents=n)
    return out


contribution_toward.launches = 0


def contribution_toward_tenants_plain(vouches: VouchTable, target_session_of_slot, now):
    """Plain version of the contribution's tenant form: the solo plain
    version on each tenant's view, stacked -> f32[T, N]."""
    return torch.stack([
        liability_ops.contribution_toward(tenant_view(vouches, t), target_session_of_slot[t], now)
        for t in range(target_session_of_slot.shape[0])
    ])


def contribution_toward_tenants(
    vouches: VouchTable,                   # stacked [T, E]
    target_session_of_slot: torch.Tensor,  # i32[T, N]
    now,
) -> torch.Tensor:
    """The contribution's tenant form: f32[T, N], each tenant's edges
    toward its own slots, summed in edge order, in the solo form's five
    launches. CPU tensors take `contribution_toward_tenants_plain`."""
    if not _route(vouches.bond):
        return contribution_toward_tenants_plain(vouches, target_session_of_slot, now)
    dev = vouches.bond.device
    t_count, n = target_session_of_slot.shape
    e = vouches.bond.shape[1]
    cols = [  # (tensor, name, dtype, shape)
        (vouches.vouchee, "vouches.vouchee", torch.int32, (t_count, e)),
        (vouches.session, "vouches.session", torch.int32, (t_count, e)),
        (vouches.active, "vouches.active", torch.bool, (t_count, e)),
        (vouches.expiry, "vouches.expiry", torch.float32, (t_count, e)),
        (vouches.bond, "vouches.bond", torch.float32, (t_count, e)),
        (target_session_of_slot, "target_session_of_slot", torch.int32, (t_count, n)),
    ]
    for t, name, dtype, shape in cols:
        _check_operand(t, name, dtype, dev)
        _require(tuple(t.shape) == shape, f"{name}: expected shape {shape}")
    now_t = admission_ops.f32_scalar(now, dev)
    nt, et = t_count * n, t_count * e
    scratch = torch.zeros((nt + nt + 1 + nt + 2 * et,), dtype=torch.int32, device=dev)
    out = torch.empty((t_count, n), dtype=torch.float32, device=dev)
    fn = _build.entry("wave", "hv_contribution_tenants", [_P] * 9 + [_I, _I, _I, _P])
    err = fn(*(col[0].data_ptr() for col in cols), now_t.data_ptr(), scratch.data_ptr(),
             out.data_ptr(), t_count, e, n, torch.cuda.current_stream(dev).cuda_stream)
    _build.check("wave", err, "contribution_toward_tenants")
    contribution_toward_tenants.launches += 1
    work.note_launch("contribution_toward_tenants", edges=et, agents=nt)
    return out


contribution_toward_tenants.launches = 0


# ── B4: admission ────────────────────────────────────────────────────


def admission_block_plain(
    agents, sessions, slot, did, session_slot, sigma_raw, contribution, omega,
    trustworthy, duplicate, now, bursts=None, trust: TrustConfig = DEFAULT_CONFIG.trust,
    unique_sessions: bool = False,
):
    """Plain version of B4 (`ops.admission.admit_batch`):
    updates the tables in place, returns (status i8[B], ring i8[B],
    sigma_eff f32[B])."""
    r = admission_ops.admit_batch(
        agents, sessions, slot, did, session_slot, sigma_raw, trustworthy,
        duplicate, now, trust, contribution=contribution, omega=omega,
        ring_bursts=bursts, unique_sessions=unique_sessions,
    )
    return r.status, r.ring, r.sigma_eff


def admission_block(
    agents: AgentTable,
    sessions: SessionTable,
    slot: torch.Tensor,          # i32[B] agent rows (unique among admitted lanes)
    did: torch.Tensor,           # i32[B]
    session_slot: torch.Tensor,  # i32[B]
    sigma_raw: torch.Tensor,     # f32[B]
    contribution: torch.Tensor | None,  # f32[B], or None: no contribution
    omega,
    trustworthy: torch.Tensor,   # bool[B]
    duplicate: torch.Tensor,     # bool[B]
    now,
    bursts=None,
    trust: TrustConfig = DEFAULT_CONFIG.trust,
    unique_sessions: bool = False,
):
    """B4: the admission phase, updating agents.f32/i32/ring and the
    sessions' participant counts IN PLACE. Returns (status, ring,
    sigma_eff). With `contribution` None (the join queue's wave) sigma_eff
    is sigma_raw bit for bit, unclamped, and `omega` is unused. The
    caller guarantees slot and session indices are in range (the kernel
    does not bound-check them)."""
    if not _route(slot):
        return admission_block_plain(
            agents, sessions, slot, did, session_slot, sigma_raw, contribution,
            omega, trustworthy, duplicate, now, bursts, trust, unique_sessions,
        )
    dev = slot.device
    b = slot.shape[0]
    n = agents.ring.shape[0]
    _require(tuple(agents.f32.shape) == (n, AF32_WIDTH), "agents.f32: [N, 8]")
    _require(tuple(agents.i32.shape) == (n, AI32_WIDTH), "agents.i32: [N, 21]")
    sc = sessions.i32.shape[0]
    _require(tuple(sessions.i32.shape) == (sc, SI32_WIDTH), "sessions.i32: [S, 5]")
    _require(tuple(sessions.f32.shape) == (sc, SF32_WIDTH), "sessions.f32: [S, 4]")
    operands = [
        (agents.f32, "agents.f32", torch.float32), (agents.i32, "agents.i32", torch.int32),
        (agents.ring, "agents.ring", torch.int8), (sessions.i32, "sessions.i32", torch.int32),
        (sessions.f32, "sessions.f32", torch.float32), (slot, "slot", torch.int32),
        (did, "did", torch.int32), (session_slot, "session_slot", torch.int32),
        (sigma_raw, "sigma_raw", torch.float32), (trustworthy, "trustworthy", torch.bool),
        (duplicate, "duplicate", torch.bool),
    ]
    if contribution is not None:
        operands.append((contribution, "contribution", torch.float32))
    for t, name, dtype in operands:
        _check_operand(t, name, dtype, dev)
    for t, name, _ in operands[5:]:
        _require(tuple(t.shape) == (b,), f"{name}: [B]")
    status = torch.empty((b,), dtype=torch.int8, device=dev)
    ring = torch.empty((b,), dtype=torch.int8, device=dev)
    sigma_eff = torch.empty((b,), dtype=torch.float32, device=dev)
    _check_operand(agents.f32, "agents.f32", torch.float32, dev, 16)
    # The two-pass form's scratch: each lane's session key and seat snapshot.
    scratch = torch.empty((0 if unique_sessions else 3 * b,), dtype=torch.int32, device=dev)
    fn = _build.entry(
        "wave", "hv_admission_block",
        [_P] * 12 + [_F] * 7 + [_I] * 2 + [_P] * 6,
    )
    err = fn(
        agents.f32.data_ptr(), agents.i32.data_ptr(), agents.ring.data_ptr(),
        sessions.i32.data_ptr(), sessions.f32.data_ptr(),
        slot.data_ptr(), did.data_ptr(), session_slot.data_ptr(),
        sigma_raw.data_ptr(), None if contribution is None else contribution.data_ptr(),
        trustworthy.data_ptr(), duplicate.data_ptr(),
        _host_f32(omega), _host_f32(now), _host_f32(trust.ring2_threshold),
        *_bursts(bursts),
        int(bool(unique_sessions)), b,
        status.data_ptr(), ring.data_ptr(), sigma_eff.data_ptr(),
        scratch.data_ptr(), scratch.data_ptr() + 4 * b,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("wave", err, "admission_block")
    _wrote(agents.f32, agents.i32, agents.ring, sessions.i32)
    admission_block.launches += 1
    if work.counting():
        with work.paused():
            admitted = int((status == admission_ops.ADMIT_OK).sum())
            sessions_hit = int(torch.unique(session_slot).numel())
        work.note_launch("admission_block", lanes=b, admitted=admitted,
                         contribution=contribution is not None, sessions=sessions_hit)
    return status, ring, sigma_eff


admission_block.launches = 0


def admission_block_tenants_plain(
    agents, sessions, slot, did, session_slot, sigma_raw, contribution, omega, trustworthy,
    duplicate, now, bursts=None, trust: TrustConfig = DEFAULT_CONFIG.trust,
):
    """Plain version of B4's tenant form: the solo plain version (its
    ranked form) on each tenant's views and lanes, stacked."""
    outs = [
        admission_block_plain(
            tenant_view(agents, t), tenant_view(sessions, t), slot[t], did[t], session_slot[t],
            sigma_raw[t], None if contribution is None else contribution[t], omega,
            trustworthy[t], duplicate[t], now, bursts, trust, False,
        )
        for t in range(slot.shape[0])
    ]
    return tuple(torch.stack(col) for col in zip(*outs))


def admission_block_tenants(
    agents: AgentTable,          # stacked [T, N]
    sessions: SessionTable,      # stacked [T, S]
    slot: torch.Tensor,          # i32[T, B] each tenant's agent rows
    did: torch.Tensor,           # i32[T, B]
    session_slot: torch.Tensor,  # i32[T, B] each tenant's own session rows
    sigma_raw: torch.Tensor,     # f32[T, B]
    contribution: torch.Tensor | None,  # f32[T, B]
    omega,
    trustworthy: torch.Tensor,   # bool[T, B]
    duplicate: torch.Tensor,     # bool[T, B]
    now,
    bursts=None,
    trust: TrustConfig = DEFAULT_CONFIG.trust,
):
    """B4's tenant form: T tenants' admission waves, each on its own
    slice of the stacked tables, IN PLACE, always the ranked (two-launch)
    form: the lanes of one tenant may share a session. Returns (status
    i8[T, B], ring i8[T, B], sigma_eff f32[T, B]). CPU tensors take
    `admission_block_tenants_plain`."""
    if not _route(slot):
        return admission_block_tenants_plain(
            agents, sessions, slot, did, session_slot, sigma_raw, contribution, omega,
            trustworthy, duplicate, now, bursts, trust,
        )
    dev = slot.device
    t_count, b = slot.shape
    n, sc = agents.ring.shape[1], sessions.i32.shape[1]
    _require(tuple(agents.f32.shape) == (t_count, n, AF32_WIDTH), "agents.f32: [T, N, 8]")
    _require(tuple(agents.i32.shape) == (t_count, n, AI32_WIDTH), "agents.i32: [T, N, 21]")
    _require(tuple(sessions.i32.shape) == (t_count, sc, SI32_WIDTH), "sessions.i32: [T, S, 5]")
    _require(tuple(sessions.f32.shape) == (t_count, sc, SF32_WIDTH), "sessions.f32: [T, S, 4]")
    operands = [
        (agents.f32, "agents.f32", torch.float32), (agents.i32, "agents.i32", torch.int32),
        (agents.ring, "agents.ring", torch.int8), (sessions.i32, "sessions.i32", torch.int32),
        (sessions.f32, "sessions.f32", torch.float32), (slot, "slot", torch.int32),
        (did, "did", torch.int32), (session_slot, "session_slot", torch.int32),
        (sigma_raw, "sigma_raw", torch.float32), (trustworthy, "trustworthy", torch.bool),
        (duplicate, "duplicate", torch.bool),
    ]
    if contribution is not None:
        operands.append((contribution, "contribution", torch.float32))
    for t, name, dtype in operands:
        _check_operand(t, name, dtype, dev)
    for t, name, _ in operands[5:]:
        _require(tuple(t.shape) == (t_count, b), f"{name}: [T, B]")
    _check_operand(agents.f32, "agents.f32", torch.float32, dev, 16)
    status = torch.empty((t_count, b), dtype=torch.int8, device=dev)
    ring = torch.empty((t_count, b), dtype=torch.int8, device=dev)
    sigma_eff = torch.empty((t_count, b), dtype=torch.float32, device=dev)
    lanes = t_count * b
    scratch = torch.empty((3 * lanes,), dtype=torch.int32, device=dev)
    fn = _build.entry(
        "wave", "hv_admission_block_tenants",
        [_P] * 12 + [_F] * 7 + [_I] * 4 + [_P] * 6,
    )
    err = fn(
        agents.f32.data_ptr(), agents.i32.data_ptr(), agents.ring.data_ptr(),
        sessions.i32.data_ptr(), sessions.f32.data_ptr(),
        slot.data_ptr(), did.data_ptr(), session_slot.data_ptr(),
        sigma_raw.data_ptr(), None if contribution is None else contribution.data_ptr(),
        trustworthy.data_ptr(), duplicate.data_ptr(),
        _host_f32(omega), _host_f32(now), _host_f32(trust.ring2_threshold),
        *_bursts(bursts),
        t_count, b, n, sc,
        status.data_ptr(), ring.data_ptr(), sigma_eff.data_ptr(),
        scratch.data_ptr(), scratch.data_ptr() + 4 * lanes,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("wave", err, "admission_block_tenants")
    _wrote(agents.f32, agents.i32, agents.ring, sessions.i32)
    admission_block_tenants.launches += 1
    if work.counting():
        with work.paused():
            admitted = int((status == admission_ops.ADMIT_OK).sum())
        work.note_launch("admission_block_tenants", lanes=lanes, admitted=admitted,
                         contribution=contribution is not None)
    return status, ring, sigma_eff


admission_block_tenants.launches = 0


# ── B5: fsm + saga + terminate ───────────────────────────────────────


def fsm_saga_block_plain(agents, sessions, vouches, k_sessions, ok, now, wave_range=None):
    """Plain version of B5: the session walk ACTIVE -> TERMINATING ->
    ARCHIVED on populated sessions, one saga step per lane, and
    `ops.terminate.release_session_scope`, all IN PLACE. Returns
    (step_state i8[B], wave_state i8[K], fsm_error bool[K], released
    i32[])."""
    k_idx = k_sessions.to(torch.int64)
    rows_i32 = sessions.i32[k_idx]
    rows_f32 = sessions.f32[k_idx]
    wave_state = rows_i32[:, SI32_STATE].to(torch.int8)
    has_members = rows_i32[:, SI32_NPART] > 0
    wave_state, err_a = session_fsm.apply_session_transitions(wave_state, _ACTIVE, has_members)
    step_state, _ = saga_ops.execute_attempt(
        torch.full(ok.shape, saga_ops.STEP_PENDING, dtype=torch.int8, device=ok.device),
        ok,
        torch.zeros(ok.shape, dtype=torch.int8, device=ok.device),
    )
    in_wave = None
    if wave_range is None:
        in_wave = torch.zeros((sessions.i32.shape[0],), dtype=torch.bool, device=ok.device)
        in_wave[k_idx.clamp(min=0)] = True
    released = terminate_ops.release_session_scope(agents, vouches, in_wave, wave_range)
    wave_state, err_t = session_fsm.apply_session_transitions(wave_state, _TERMINATING, has_members)
    wave_state, err_z = session_fsm.apply_session_transitions(wave_state, _ARCHIVED, has_members)
    sessions.i32[k_idx, SI32_STATE] = wave_state.to(torch.int32)
    sessions.f32[k_idx, SF32_TERMINATED_AT] = torch.where(
        has_members, admission_ops.f32_scalar(now, ok.device), rows_f32[:, SF32_TERMINATED_AT]
    )
    return step_state, wave_state, err_a | err_t | err_z, released


#: The most shared memory one block of B5 can take for the membership
#: bitmap (an H100's 227 KB): 1,859,584 session slots.
FSM_MASK_MAX_BYTES = 232_448


def fsm_saga_block(
    agents: AgentTable,
    sessions: SessionTable,
    vouches: VouchTable,
    k_sessions: torch.Tensor,  # i32[K] the wave's sessions, any layout
    ok: torch.Tensor,          # bool[B] admission outcomes
    now,
    wave_range: tuple[int, int] | None = None,
):
    """B5: the wave's FSM walk, saga step and terminate, updating
    sessions.i32/f32, vouches.active and the agents' flags IN PLACE.
    `wave_range` (lo, hi) is the caller's host-verified assertion that
    `k_sessions` is arange(lo, hi): the kernel then tests membership by
    range. Without it the kernel tests a bitmap of `k_sessions` over the
    session table, built in each block's shared memory."""
    if not _route(ok):
        return fsm_saga_block_plain(agents, sessions, vouches, k_sessions, ok, now, wave_range)
    dev = ok.device
    lo, hi = (int(x) for x in wave_range) if wave_range is not None else (0, 0)
    k, b = k_sessions.shape[0], ok.shape[0]
    e, n = vouches.session.shape[0], agents.i32.shape[0]
    s_cap = sessions.i32.shape[0]
    _require(tuple(agents.i32.shape) == (n, AI32_WIDTH), "agents.i32: [N, 21]")
    _require(sessions.i32.shape[1] == SI32_WIDTH and sessions.f32.shape[1] == SF32_WIDTH,
             "sessions: i32[S, 5], f32[S, 4]")
    _require(wave_range is not None or (s_cap + 31) // 32 * 4 <= FSM_MASK_MAX_BYTES,
             f"the membership bitmap of {s_cap} sessions exceeds a block's shared memory")
    for t, name, dtype in [
        (agents.i32, "agents.i32", torch.int32), (sessions.i32, "sessions.i32", torch.int32),
        (sessions.f32, "sessions.f32", torch.float32),
        (vouches.session, "vouches.session", torch.int32),
        (vouches.active, "vouches.active", torch.bool),
        (k_sessions, "k_sessions", torch.int32), (ok, "ok", torch.bool),
    ]:
        _check_operand(t, name, dtype, dev)
    step = torch.empty((b,), dtype=torch.int8, device=dev)
    wstate = torch.empty((k,), dtype=torch.int8, device=dev)
    err = torch.empty((k,), dtype=torch.bool, device=dev)
    released = torch.zeros((), dtype=torch.int32, device=dev)
    bits_lo, bits_hi, n_rows, n_cols = session_fsm.TRANSITION_BITS
    fn = _build.entry(
        "wave", "hv_fsm_saga_block",
        [_P] * 7 + [_F, _I, _I, _I, _I, _U, _U] + [_I] * 9 + [_P] * 5,
    )
    rc = fn(
        agents.i32.data_ptr(), sessions.i32.data_ptr(), sessions.f32.data_ptr(),
        vouches.session.data_ptr(), vouches.active.data_ptr(),
        k_sessions.data_ptr(), ok.data_ptr(),
        _host_f32(now), lo, hi, int(wave_range is None), s_cap,
        bits_lo, bits_hi, n_rows, n_cols,
        _ACTIVE, _TERMINATING, _ARCHIVED, k, b, e, n,
        step.data_ptr(), wstate.data_ptr(), err.data_ptr(), released.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("wave", rc, "fsm_saga_block")
    _wrote(agents.i32, sessions.i32, sessions.f32, vouches.active)
    fsm_saga_block.launches += 1
    if work.counting():
        with work.paused():
            hits = int(torch.isin(agents.i32[:, AI32_SESSION], k_sessions).sum())
            vouched = int(released)
        work.note_launch("fsm_saga_block", sessions=k, lanes=b, edges=e, vouched=vouched,
                         agents=n, agent_hits=hits)
    return step, wstate, err, released


fsm_saga_block.launches = 0


def fsm_saga_block_tenants_plain(agents, sessions, vouches, k_sessions, ok, now, lo, hi):
    """Plain version of B5's tenant form: the solo plain version on each
    tenant's views in its range form, stacked (`released` i32[T])."""
    outs = [
        fsm_saga_block_plain(
            tenant_view(agents, t), tenant_view(sessions, t), tenant_view(vouches, t),
            k_sessions[t], ok[t], now, (int(lo[t]), int(hi[t])),
        )
        for t in range(ok.shape[0])
    ]
    return tuple(torch.stack(col) for col in zip(*outs))


def fsm_saga_block_tenants(
    agents: AgentTable,        # stacked [T, N]
    sessions: SessionTable,    # stacked [T, S]
    vouches: VouchTable,       # stacked [T, E]
    k_sessions: torch.Tensor,  # i32[T, K] each tenant's wave sessions, arange(lo, hi)
    ok: torch.Tensor,          # bool[T, B] admission outcomes
    now,
    lo: Sequence[int],         # [T] host: each tenant's wave range
    hi: Sequence[int],
):
    """B5's tenant form: T tenants' FSM walks, saga steps and terminates
    in one launch, IN PLACE, each tenant's wave the range [lo[t], hi[t])
    (the caller checked that k_sessions[t] is that range). Returns
    (step_state i8[T, B], wave_state i8[T, K], fsm_error bool[T, K],
    released i32[T]). CPU tensors take `fsm_saga_block_tenants_plain`."""
    if not _route(ok):
        return fsm_saga_block_tenants_plain(agents, sessions, vouches, k_sessions, ok, now,
                                            lo, hi)
    dev = ok.device
    t_count, b = ok.shape
    k = k_sessions.shape[1]
    e, n = vouches.session.shape[1], agents.i32.shape[1]
    s_cap = sessions.i32.shape[1]
    _require(len(lo) == t_count and len(hi) == t_count, "lo, hi: one range a tenant")
    _require(tuple(agents.i32.shape) == (t_count, n, AI32_WIDTH), "agents.i32: [T, N, 21]")
    _require(tuple(sessions.i32.shape) == (t_count, s_cap, SI32_WIDTH)
             and tuple(sessions.f32.shape) == (t_count, s_cap, SF32_WIDTH),
             "sessions: i32[T, S, 5], f32[T, S, 4]")
    _require(tuple(k_sessions.shape) == (t_count, k), "k_sessions: [T, K]")
    for t, name, dtype in [
        (agents.i32, "agents.i32", torch.int32), (sessions.i32, "sessions.i32", torch.int32),
        (sessions.f32, "sessions.f32", torch.float32),
        (vouches.session, "vouches.session", torch.int32),
        (vouches.active, "vouches.active", torch.bool),
        (k_sessions, "k_sessions", torch.int32), (ok, "ok", torch.bool),
    ]:
        _check_operand(t, name, dtype, dev)
    # The ranges cross as one pinned, non-blocking copy: the launch is not
    # held behind a host-synchronous one.
    ranges = torch.tensor([list(lo), list(hi)], dtype=torch.int32).pin_memory().to(
        dev, non_blocking=True)
    step = torch.empty((t_count, b), dtype=torch.int8, device=dev)
    wstate = torch.empty((t_count, k), dtype=torch.int8, device=dev)
    err = torch.empty((t_count, k), dtype=torch.bool, device=dev)
    released = torch.zeros((t_count,), dtype=torch.int32, device=dev)
    bits_lo, bits_hi, n_rows, n_cols = session_fsm.TRANSITION_BITS
    fn = _build.entry(
        "wave", "hv_fsm_saga_block_tenants",
        [_P] * 9 + [_F, _U, _U, _I, _I] + [_I] * 9 + [_P] * 5,
    )
    rc = fn(
        agents.i32.data_ptr(), sessions.i32.data_ptr(), sessions.f32.data_ptr(),
        vouches.session.data_ptr(), vouches.active.data_ptr(),
        k_sessions.data_ptr(), ok.data_ptr(), ranges[0].data_ptr(), ranges[1].data_ptr(),
        _host_f32(now), bits_lo, bits_hi, n_rows, n_cols,
        _ACTIVE, _TERMINATING, _ARCHIVED, t_count, k, b, e, n, s_cap,
        step.data_ptr(), wstate.data_ptr(), err.data_ptr(), released.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("wave", rc, "fsm_saga_block_tenants")
    _wrote(agents.i32, sessions.i32, sessions.f32, vouches.active)
    fsm_saga_block_tenants.launches += 1
    if work.counting():
        with work.paused():
            in_range = ((agents.session >= ranges[0][:, None])
                        & (agents.session < ranges[1][:, None]))
            hits = int(in_range.sum())
            vouched = int(released.sum())
        work.note_launch("fsm_saga_block_tenants", sessions=t_count * k, lanes=t_count * b,
                         edges=t_count * e, vouched=vouched, agents=t_count * n,
                         agent_hits=hits)
    return step, wstate, err, released


fsm_saga_block_tenants.launches = 0


# ── B6: the DeltaLog ring append ─────────────────────────────────────


def ring_append_plain(
    delta_log: DeltaLog, delta_bodies, chain, wave_sessions, cursor: int, n_live: int
) -> None:
    """Plain version of B6: `DeltaLog.append_batch_prefix` of the wave's
    lane-major rows (bodies, digests, sessions repeated T times, turns
    0..T-1 tiled K times), IN PLACE. `cursor` (the host mirror the ring
    form's kernel takes) is not read: the ring's own cursor, which it
    mirrors, places the rows."""
    t, k, _ = delta_bodies.shape
    dev = delta_bodies.device
    delta_log.append_batch_prefix(
        delta_bodies.transpose(0, 1).reshape(k * t, delta_bodies.shape[2]),
        chain.transpose(0, 1).reshape(k * t, 8),
        wave_sessions.repeat_interleave(t),
        torch.arange(t, dtype=torch.int32, device=dev).repeat(k),
        n_live,
    )
