"""Multi-device governance ticks over a single-controller mesh
(`hypervisor_tpu.parallel.collectives`).

The distributed communication backend (the reference's host engine has
none):

 - STRONG mode: every batched tick ends in a `psum` of the session
   aggregates over the mesh agent axis, a consensus barrier: every shard
   sees the same global state before the tick commits.
 - EVENTUAL mode: shards update their part locally; `reconcile` runs the
   same allreduce *between* ticks, trading freshness for zero in-tick
   communication.

The reference writes each program as one `shard_map` body. Here one
process drives every shard, as the reference's one process drives every
device: a body becomes per-shard phases (a loop over the shards, each on
its own device) joined by explicit collectives over the shards' parts:
`psum` and a tiled `all_gather` (shard-major concatenation); the
chain's one-hop `ppermute` is a `.to` of the last digests.
A collective brings each part to the reducing shard's device with `.to`
(a no-op on a virtual mesh) and adds in one fixed order: rank order
within each replica group, from zero, one add at a time, which is the
order XLA:CPU's all-reduce adds in over the reference's virtual devices.
Integer sums do not depend on it; the f32 ones (the vouched contribution,
the consensus sums, the reconcile's sigma mass) are the reference's bit
for bit because of it.

Each shard's work is the same code the single-device path runs: the
contribution's kernel, B2 and B3 launch once per shard on CUDA tensors
(their plain versions on CPU tensors); the rest are torch ops. Sharded
tables are split by rows (`parallel.sharding`): on a virtual mesh the
parts are views, so the tables are updated IN PLACE (as the
single-device wave updates them); a part on another device than its
table is written back. Replicated values (the SessionTable, sigma, the
ElevationTable) keep one copy, on the caller's device, which every
shard reads.

The f32 `sigma_raw + omega * contribution` of the sharded admission is
one fused multiply-add, rounded once, as the reference's compiled
program computes it (`_fma_f32`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from hypervisor_tpu_torch.config import DEFAULT_CONFIG, TrustConfig
from hypervisor_tpu_torch.models import SessionState
from hypervisor_tpu_torch.observability import profiling
from hypervisor_tpu_torch.ops import admission as admission_ops
from hypervisor_tpu_torch.ops import liability as liability_ops
from hypervisor_tpu_torch.ops import rings as ring_ops
from hypervisor_tpu_torch.ops.admission import f32_scalar
from hypervisor_tpu_torch.ops.pipeline import PipelineResult, governance_pipeline
from hypervisor_tpu_torch.parallel.mesh import AGENT_AXIS, DCN_AXIS, Mesh
from hypervisor_tpu_torch.parallel.sharding import (
    gather_rows,
    shard_table,
    split_rows,
    write_back,
)
from hypervisor_tpu_torch.tables.state import (
    SF32_MIN_SIGMA,
    SF32_TERMINATED_AT,
    SI32_MAX_PARTICIPANTS,
    SI32_NPART,
    SI32_STATE,
)
from hypervisor_tpu_torch.tables.struct import tensors

# ── collectives over the shards' parts ───────────────────────────────


def _groups(mesh: Mesh, axes) -> list[list[int]]:
    """The replica groups of a collective over `axes` (one axis name or a
    tuple): shards that share their coordinates on every other axis, each
    group in rank order (the named axes' coordinates, mesh axis order,
    row-major), as flat shard indices."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    reduced = sorted(mesh.axis_names.index(a) for a in names)
    kept = [i for i in range(mesh.devices.ndim) if i not in reduced]
    idx = np.arange(mesh.devices.size).reshape(mesh.devices.shape)
    size = int(np.prod([mesh.devices.shape[i] for i in reduced]))
    return idx.transpose(kept + reduced).reshape(-1, size).tolist()


def psum(parts: list[torch.Tensor], mesh: Mesh, axes=AGENT_AXIS) -> list[torch.Tensor]:
    """Allreduce-sum the shards' parts over `axes`. Each group adds its
    members' parts on its first member's device, in rank order from
    zero; every member gets the group's sum on its own device (one
    tensor shared by the members on one device: read it, do not write)."""
    out: list = [None] * len(parts)
    for group in _groups(mesh, axes):
        dev = parts[group[0]].device
        acc = torch.zeros_like(parts[group[0]])
        for i in group:
            acc = acc + parts[i].to(dev)
        for i in group:
            out[i] = acc.to(parts[i].device)
    return out


def all_gather(parts: list[torch.Tensor], mesh: Mesh, axis=AGENT_AXIS) -> list[torch.Tensor]:
    """Tiled all-gather: each member gets its group's parts concatenated
    along dim 0 in rank order (shard-major), on its own device."""
    out: list = [None] * len(parts)
    for group in _groups(mesh, axis):
        dev = parts[group[0]].device
        cat = torch.cat([parts[i].to(dev) for i in group])
        for i in group:
            out[i] = cat.to(parts[i].device)
    return out


def _linear_shard_index(d: int) -> int:
    """Shard d's index into the GLOBAL slice-major row layout: the flat
    index, on a 1-D mesh and on a (dcn, agents) grid (dcn * per_slice +
    agents). Every body that localizes global slots (`_wave_admission`,
    the fused wave's gateway phase, `sharded_gateway`) uses this one
    helper, so a layout change lands everywhere at once."""
    return d


def _replica(table, device):
    """A replicated table as one shard reads it: its columns on `device`
    (the same tensors where they already live there)."""
    return dataclasses.replace(table, **{k: v.to(device) for k, v in tensors(table).items()})


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a * b + c rounded once (a fused multiply-add). In float64 the
    product of two f32 values is exact; the sum is rounded to odd (TwoSum
    gives its error, and an inexact even result steps one ulp toward the
    exact value) before its one rounding to f32, so it is never rounded
    twice."""
    a64, b64, c64 = (x.to(torch.float64) for x in torch.broadcast_tensors(a, b, c))
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _scatter_add_in_order(n: int, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """f32[n] sums of `val` at `idx`, each index's values added in lane
    order from zero, on any device: one round per occurrence rank, each
    round a scatter of distinct indices (exact and deterministic)."""
    out = torch.zeros((n,), dtype=val.dtype, device=val.device)
    if idx.numel() == 0:
        return out
    rank = admission_ops.rank_within_session(idx)
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        out.index_add_(0, idx[sel], val[sel])
    return out


def _lanes(mesh: Mesh, *cols) -> list[list[torch.Tensor]]:
    """Each [B]-leading column split over the shards (None passes)."""
    return [None if c is None else split_rows(c, mesh) for c in cols]


# ── lane ticks ───────────────────────────────────────────────────────


def strong_tick(mesh: Mesh, with_vouching: bool = False):
    """The multi-device governance tick (STRONG consistency).

    Returns fn(sigma_raw, trustworthy, min_sigma_eff, delta_bodies,
    active[, contribution]) with every [S]-leading input sharded over the
    mesh (delta_bodies [T, S, W] on its S axis); with_vouching adds the
    per-lane bonded-sigma input so admission applies the joint-liability
    formula. Each shard runs `ops.pipeline.governance_pipeline` on its
    lanes (B2 and B3 on CUDA); the returned `consensus` vector is psum'd
    so every shard agrees. Lane outputs come back whole, on the inputs'
    device."""

    def tick(sigma_raw, trustworthy, min_sigma_eff, delta_bodies, active, *contribution):
        home = sigma_raw.device
        results = _pipeline_shards(mesh, sigma_raw, trustworthy, min_sigma_eff, delta_bodies,
                                   active, contribution[0] if contribution else None)
        consensus = psum([r.consensus for r in results], mesh)[0].to(home)
        return _gather_pipeline(results, home)._replace(consensus=consensus)

    return tick


def _pipeline_shards(mesh, sigma_raw, trustworthy, min_sigma_eff, delta_bodies, active,
                     contribution=None) -> list[PipelineResult]:
    sig, tr, mn, act, con = _lanes(mesh, sigma_raw, trustworthy, min_sigma_eff, active,
                                   contribution)
    bodies = split_rows(delta_bodies, mesh, dim=1)
    return [
        governance_pipeline(sig[d], tr[d], mn[d], bodies[d], act[d],
                            contribution=None if con is None else con[d])
        for d in range(mesh.devices.size)
    ]


def _gather_pipeline(results: list[PipelineResult], home) -> PipelineResult:
    """The shards' lane outputs concatenated (consensus: the per-shard
    partials, shard-major)."""
    return PipelineResult(*(gather_rows([getattr(r, f) for r in results], home)
                            for f in PipelineResult._fields))


def eventual_tick(mesh: Mesh):
    """EVENTUAL mode: local-only tick, no in-tick collective; `consensus`
    holds the shards' partial aggregates ([4 * D], shard-major)."""

    def tick(sigma_raw, trustworthy, min_sigma_eff, delta_bodies, active):
        return _gather_pipeline(
            _pipeline_shards(mesh, sigma_raw, trustworthy, min_sigma_eff, delta_bodies, active),
            sigma_raw.device)

    return tick


def reconcile(mesh: Mesh):
    """Between-tick reconciliation for EVENTUAL mode: allreduce partials
    (a [D * m, ...] array, m rows per shard) into their [m, ...] sum."""

    def _sum(partials):
        return psum(split_rows(partials, mesh), mesh)[0].to(partials.device)

    return _sum


def sharded_chain(mesh: Mesh):
    """Sequence-parallel Merkle chaining: a delta chain longer than one
    device's memory, pipelined across the mesh.

    The TURN axis is sharded: shard d holds turns [d*T/D, (d+1)*T/D) of
    every lane and chains its block (B2 on CUDA), seeded with the last
    digests of shard d - 1, which a `ppermute` hands on. The shards run
    one after another, as the chain is sequential: D launches of B2.

    Returns fn(bodies [T, L, 16], seed [L, 8]) -> digests [T, L, 8]."""
    from hypervisor_tpu_torch.ops import merkle as merkle_ops

    n_shards = mesh.devices.size

    def run(bodies, seed):
        parts = split_rows(bodies, mesh, dim=0)
        carry = seed.to(parts[0].device).contiguous()
        out = []
        for d in range(n_shards):
            digests = merkle_ops.chain_digests(parts[d], carry)
            out.append(digests)
            if d + 1 < n_shards:
                # The ring hop d -> d + 1 of the last digests.
                carry = digests[-1].to(parts[d + 1].device).contiguous()
        return gather_rows(out, bodies.device)

    return run


# ── cross-shard admission ────────────────────────────────────────────


def sharded_admission(
    mesh: Mesh,
    trust: TrustConfig = DEFAULT_CONFIG.trust,
    rate=DEFAULT_CONFIG.rate_limit,
):
    """Cross-shard STRONG-mode admission: correct when a session spans
    shards.

    The agent table and the wave are sharded over the mesh; the session
    table is replicated. Capacity and sigma_eff checks that the
    single-device wave resolves locally become collectives here:

      * vouched sigma_eff: every shard sums its OWN vouch-edge shard's
        bonded contributions into an [N]-vector (the contribution's
        kernel on CUDA), then a `psum` yields each joining agent's global
        contribution,
      * capacity: session ids and pass masks are `all_gather`ed so every
        shard computes the same global admission ranking (wave order =
        shard-major),
      * the session-table update is an allreduce of the ACTUAL table
        delta: per-session admit counts are psum'd and applied once to
        the replicated table.

    Slot contract: wave element i carries a GLOBAL agent-table row that
    lives on i's shard.

    Returns fn(agents, sessions, vouches, slot, did, session_slot,
    sigma_raw, trustworthy, duplicate, now, omega) -> (agents, sessions,
    status, ring, sigma_eff); the tables are updated in place.
    """

    def step(agents, sessions, vouches, slot, did, session_slot, sigma_raw, trustworthy,
             duplicate, now, omega):
        home = agents.f32.device
        a_parts, v_parts = shard_table(agents, mesh), shard_table(vouches, mesh)
        lanes = _lanes(mesh, slot, did, session_slot, sigma_raw, trustworthy, duplicate)
        out = _wave_admission(mesh, a_parts, sessions, v_parts, *lanes, now, omega, trust, rate)
        write_back(agents, a_parts)
        status, ring, sigma_eff = (gather_rows(x, home) for x in out[:3])
        return agents, sessions, status, ring, sigma_eff

    return step


def _wave_admission(
    mesh, agents, sessions, vouches, slot, did, session_slot, sigma_raw, trustworthy,
    duplicate, now, omega, trust, rate=DEFAULT_CONFIG.rate_limit, mode_dispatch: bool = False,
    unique_sessions: bool = False, row_axes=AGENT_AXIS, force_eventual: bool = False,
    fold_extra=None,
):
    """The cross-shard admission body shared by `sharded_admission` and
    `sharded_governance_wave`, so the two cannot drift. `agents` and
    `vouches` are the shards' table parts, the lane arguments per-shard
    lists, `sessions` the replicated table (updated in place on its
    device). See `sharded_admission` for the collective design.

    Returns (status, ring, sigma_eff) as per-shard lists, then with
    `mode_dispatch` (view_counts [S_cap], ev_counts_local per shard), then
    with `fold_extra` (per-shard i32[S_cap] vectors the caller wants
    allreduced anyway: the fused wave's terminate mask, riding the
    session-count psum as one more stacked row) their sum.

    `row_axes` names the mesh axes agent/vouch ROWS shard over: AGENT_AXIS
    on a 1-D mesh; (DCN_AXIS, AGENT_AXIS) on a multislice mesh, where the
    row-map/contribution psums reduce over both axes while view
    arithmetic stays slice-local. `force_eventual` defers EVERY replica
    commit to the between-tick reconcile (the multislice contract).

    `unique_sessions` (host-verified): no two seat-consuming lanes share
    a session, so every rank is 0 and the capacity check needs neither
    the rank arithmetic nor its two all_gathers.

    With `mode_dispatch` the session `mode` column decides which commit
    each admit delta rides: STRONG sessions' counts fold into the
    replicated table in-wave; EVENTUAL sessions' counts return as
    per-shard partials for the caller's between-wave fold. The wave's own
    dataflow (capacity ranks, activation checks) always sees the global
    view (view_counts)."""
    n_shards = mesh.devices.size
    devs = list(mesh.devices.flat)
    home = sessions.i32.device
    rows_per_shard = agents[0].ring.shape[0]
    n_global = rows_per_shard * n_shards
    s_cap = sessions.i32.shape[0]
    b_local = slot[0].shape[0]
    shard_of = [_linear_shard_index(d) for d in range(n_shards)]

    # ── vouched contributions: segmented psum over edge shards ────
    # Each shard marks only its own wave elements; psum merges the
    # shards' sparse marks into the full slot -> session map (+2 bias
    # makes unset rows contribute zero).
    marks = []
    for d in range(n_shards):
        m = torch.zeros((n_global,), dtype=torch.int32, device=devs[d])
        m[slot[d].to(torch.int64)] = session_slot[d] + 2
        marks.append(m)
    target = psum(marks, mesh, row_axes)
    from hypervisor_tpu_torch.kernels import wave as wave_kernels

    local_contrib = [
        wave_kernels.contribution_toward(vouches[d], target[d] - 2, f32_scalar(now, devs[d]))
        for d in range(n_shards)
    ]
    contribution = psum(local_contrib, mesh, row_axes)

    status, ring, sigma_eff, passed_other = [], [], [], []
    for d in range(n_shards):
        dev = devs[d]
        contrib = contribution[d][slot[d].to(torch.int64)]
        se = torch.minimum(_fma_f32(f32_scalar(omega, dev), contrib, sigma_raw[d]),
                           torch.ones((), dtype=torch.float32, device=dev))
        # ── globally consistent pre-checks (packed row gathers) ───
        ss = session_slot[d].to(torch.int64)
        sess_i32 = sessions.i32.to(dev)[ss]
        sess_state = sess_i32[:, SI32_STATE]
        sess_min = sessions.f32.to(dev)[ss][:, SF32_MIN_SIGMA]
        r = ring_ops.compute_rings(se, False, trust)
        r = torch.where(trustworthy[d], r, torch.full((), 3, dtype=torch.int8, device=dev))
        bad_state = ((sess_state != SessionState.HANDSHAKING.code)
                     & (sess_state != SessionState.ACTIVE.code))
        sigma_low = (se < sess_min) & (r != 3)
        st = torch.full((b_local,), admission_ops.ADMIT_OK, dtype=torch.int8, device=dev)
        for cond, code in ((bad_state, admission_ops.ADMIT_BAD_STATE),
                           (duplicate[d], admission_ops.ADMIT_DUPLICATE),
                           (sigma_low, admission_ops.ADMIT_SIGMA_LOW)):
            st = torch.where((st == admission_ops.ADMIT_OK) & cond,
                             torch.full((), code, dtype=torch.int8, device=dev), st)
        status.append(st)
        ring.append(r)
        sigma_eff.append(se)
        passed_other.append(st == admission_ops.ADMIT_OK)

    # ── global capacity ranking (all_gather) ──────────────────────
    if not unique_sessions:
        gsess = all_gather(session_slot, mesh, AGENT_AXIS)
        gpass = all_gather(passed_other, mesh, AGENT_AXIS)
    bursts = [float(np.float32(x)) for x in rate.ring_bursts]
    ok = []
    for d in range(n_shards):
        dev = devs[d]
        if unique_sessions:
            rank = torch.zeros((b_local,), dtype=torch.int32, device=dev)
        else:
            mine = shard_of[d] * b_local + torch.arange(b_local, dtype=torch.int32, device=dev)
            j = torch.arange(gsess[d].shape[0], dtype=torch.int32, device=dev)
            rank = ((j[None, :] < mine[:, None])
                    & (gsess[d][None, :] == session_slot[d][:, None])
                    & gpass[d][None, :]).sum(dim=1).to(torch.int32)
        ss = session_slot[d].to(torch.int64)
        sess_i32 = sessions.i32.to(dev)[ss]
        over = passed_other[d] & ((sess_i32[:, SI32_NPART] + rank)
                                  >= sess_i32[:, SI32_MAX_PARTICIPANTS])
        status[d] = torch.where((status[d] == admission_ops.ADMIT_OK) & over,
                                torch.full((), admission_ops.ADMIT_CAPACITY, dtype=torch.int8,
                                           device=dev), status[d])
        ok_d = status[d] == admission_ops.ADMIT_OK
        ok.append(ok_d)

        # ── local agent-shard writes, at each element's real row ──
        # (distinct by the slot contract), the old row kept where refused.
        write = slot[d].to(torch.int64) - shard_of[d] * rows_per_shard
        f32_rows, i32_rows = admission_ops.admit_row_blocks(
            did[d], session_slot[d], sigma_raw[d], sigma_eff[d], now, ring[d],
            torch.tensor(bursts, dtype=torch.float32, device=dev))
        a = agents[d]
        a.f32[write] = torch.where(ok_d[:, None], f32_rows, a.f32[write])
        a.i32[write] = torch.where(ok_d[:, None], i32_rows, a.i32[write])
        a.ring[write] = torch.where(ok_d, ring[d], a.ring[write])

    # ── replicated session table: allreduce the ACTUAL delta ──────
    def seat_counts(d, mask):
        return torch.zeros((s_cap,), dtype=torch.int32, device=devs[d]).index_add_(
            0, session_slot[d].clamp(min=0).to(torch.int64), mask.to(torch.int32))

    local_add = [seat_counts(d, ok[d]) for d in range(n_shards)]
    if fold_extra is not None and force_eventual:
        raise ValueError("fold_extra is not supported with force_eventual")
    lanes_out = (status, ring, sigma_eff)
    if not mode_dispatch:
        if fold_extra is None:
            global_add = psum(local_add, mesh, AGENT_AXIS)[0].to(home)
            extra_out = ()
        else:
            folded = psum([torch.stack([local_add[d], fold_extra[d]]) for d in range(n_shards)],
                          mesh, AGENT_AXIS)[0].to(home)
            global_add = folded[0]
            extra_out = (folded[1],)
        sessions.i32[:, SI32_NPART] += global_add
        return lanes_out + extra_out
    # Mode-dispatched commit: one psum carries both the full view (the
    # wave's internal arithmetic) and the STRONG-only slice (the replica
    # commit); the difference is the EVENTUAL partial this shard hands
    # back for the between-wave reconcile.
    if force_eventual:
        # The VIEW is still global (a session's FSM lane may live on
        # another slice than its joiner); the COMMIT defers.
        view_add = psum(local_add, mesh, row_axes)[0].to(home)
        view_counts = sessions.n_participants + view_add
        return lanes_out + (view_counts, local_add)
    strong_elem = [
        sessions.mode.to(devs[d])[session_slot[d].clamp(min=0).to(torch.int64)] == 0
        for d in range(n_shards)
    ]
    local_strong = [seat_counts(d, ok[d] & strong_elem[d]) for d in range(n_shards)]
    rows = [[local_add[d], local_strong[d]] + ([fold_extra[d]] if fold_extra is not None else [])
            for d in range(n_shards)]
    both = psum([torch.stack(r) for r in rows], mesh, AGENT_AXIS)[0].to(home)
    view_counts = sessions.n_participants + both[0]
    sessions.i32[:, SI32_NPART] += both[1]
    ev_counts_local = [local_add[d] - local_strong[d] for d in range(n_shards)]
    extra_out = (both[2],) if fold_extra is not None else ()
    return lanes_out + (view_counts, ev_counts_local) + extra_out


# ── mixed-consistency ticks and their reconciles ─────────────────────


def mode_tick(mesh: Mesh):
    """One governance tick over MIXED-consistency lanes: the session
    `mode` column decides which barrier each lane's table delta rides.

    STRONG lanes' per-session participant deltas are psum'd and folded
    into the replicated SessionTable IN-tick (the consensus barrier);
    EVENTUAL lanes' deltas come back as per-shard partials with zero
    in-tick communication, folded between ticks by `reconcile_sessions`
    (the facade's `ConsistencyRuntime.reconcile`).

    Returns fn(sessions, lane_session, strong_mask, sigma_raw,
    trustworthy, min_sigma_eff, delta_bodies, active) -> (PipelineResult,
    sessions (updated in place), eventual_count_partials [D, S_cap],
    eventual_sigma_partials [D, S_cap]) with every [S]-leading lane input
    sharded and `sessions` replicated.
    """
    from hypervisor_tpu_torch.ops.liability import _row_sum_xla_order

    def tick(sessions, lane_session, strong_mask, sigma_raw, trustworthy, min_sigma_eff,
             delta_bodies, active):
        home = sigma_raw.device
        s_cap = sessions.i32.shape[0]
        results = _pipeline_shards(mesh, sigma_raw, trustworthy, min_sigma_eff, delta_bodies,
                                   active)
        ls, strong, act = _lanes(mesh, lane_session, strong_mask, active)
        strong_counts, consensus, ev_counts, ev_sigma = [], [], [], []
        for d, res in enumerate(results):
            dev = res.status.device
            ok = (res.status == 0) & act[d]
            idx = ls[d].clamp(min=0).to(torch.int64)
            okc = ok.to(torch.int32)
            oks = torch.where(ok, res.sigma_eff, torch.zeros((), device=dev))

            def counts(mask):
                return torch.zeros((s_cap,), dtype=torch.int32, device=dev).index_add_(
                    0, idx, torch.where(mask, okc, 0))

            strong_counts.append(counts(strong[d]))
            # The consensus vector rides the in-tick barrier for STRONG
            # lanes only; its local sums in XLA:CPU's reduction order.
            okf = (ok & strong[d]).to(torch.float32)
            word0 = (res.merkle_root[:, 0].to(torch.int64) & 0xFFFFFFFF).to(torch.float32)
            consensus.append(_row_sum_xla_order(torch.stack([
                okf, res.sigma_eff * okf, res.ring.to(torch.float32) * okf, word0 * okf])))
            ev_counts.append(counts(~strong[d])[None])
            ev_sigma.append(_scatter_add_in_order(
                s_cap, idx, torch.where(strong[d], torch.zeros((), device=dev), oks))[None])
        sessions.i32[:, SI32_NPART] += psum(strong_counts, mesh)[0].to(sessions.i32.device)
        result = _gather_pipeline(results, home)._replace(
            consensus=psum(consensus, mesh)[0].to(home))
        return result, sessions, gather_rows(ev_counts, home), gather_rows(ev_sigma, home)

    return tick


def _local_row_sum(part: torch.Tensor) -> torch.Tensor:
    """A shard's [m, S] block summed over its m rows: exact for integers,
    in XLA:CPU's reduction order for f32."""
    from hypervisor_tpu_torch.ops.liability import _row_sum_xla_order

    if part.dtype.is_floating_point:
        return _row_sum_xla_order(part.transpose(0, 1))
    return part.sum(dim=0, dtype=part.dtype)


def reconcile_sessions(mesh: Mesh):
    """EVENTUAL-mode reconciliation of the ACTUAL session-table deltas.

    Between batched ticks this allreduces the shards' [S] delta vectors
    and folds them into the replicated table, so every shard converges on
    one SessionTable without an in-tick barrier.

    Returns fn(sessions, count_deltas [D*m, S], sigma_deltas [D*m, S]) ->
    (sessions (updated in place), total_counts [S], total_sigma [S]);
    delta rows are sharded over the mesh (m rows a shard: several ticks
    of deltas may stack). Participant counts fold into the table; the
    sigma mass is returned for the caller's trust accounting.
    """

    def merge(sessions, count_deltas, sigma_deltas):
        home = sessions.i32.device
        total_counts = psum([_local_row_sum(p) for p in split_rows(count_deltas, mesh)],
                            mesh)[0].to(home)
        total_sigma = psum([_local_row_sum(p) for p in split_rows(sigma_deltas, mesh)],
                           mesh)[0].to(home)
        sessions.i32[:, SI32_NPART] += total_counts
        return sessions, total_counts, total_sigma

    return merge


def multislice_reconcile(mesh: Mesh):
    """Cross-slice EVENTUAL reconciliation over a 2-D (dcn, agents) mesh.

    Within a slice, STRONG-mode ticks psum over the agent axis; across
    slices consistency is always EVENTUAL: each slice accumulates its
    session-table deltas and this folds them over the DCN axis between
    batched ticks.

    Returns fn(sessions, count_deltas [n_slices, per_slice, S]) ->
    (sessions (updated in place), total_counts [S]): deltas reduce over
    BOTH axes (the intra-slice partials first, then slices over DCN).
    """

    def merge(sessions, count_deltas):
        home = sessions.i32.device
        flat = count_deltas.reshape(-1, *count_deltas.shape[2:])
        local = [p.sum(dim=0, dtype=p.dtype) for p in split_rows(flat, mesh)]
        within = psum(local, mesh, AGENT_AXIS)
        total = psum(within, mesh, DCN_AXIS)[0].to(home)
        sessions.i32[:, SI32_NPART] += total
        return sessions, total

    return merge


def sigma_allreduce_stats(sigma_eff: torch.Tensor, n_agents: int) -> torch.Tensor:
    """Single-device helper: [sum, mean, max] of sigma for stats endpoints.
    As the reference's compiled program: the sum in XLA:CPU's reduction
    order, the mean a multiply by the f32 reciprocal of `n_agents` (XLA
    rewrites the division by a constant so)."""
    from hypervisor_tpu_torch.ops.liability import _row_sum_xla_order

    total = _row_sum_xla_order(sigma_eff.to(torch.float32)[None])[0]
    recip = f32_scalar(np.float32(1.0) / np.float32(n_agents), total.device)
    return torch.stack([total, total * recip, sigma_eff.max().to(torch.float32)])


def sharded_slash(mesh: Mesh, trust: TrustConfig = DEFAULT_CONFIG.trust):
    """Cross-shard slash cascade: the liability graph sharded over the
    mesh.

    The VouchTable's edge axis shards over the mesh (each shard holds its
    block of the edge list); agent sigma and the seed mask are
    replicated. The cascade is `ops.liability.slash_cascade(allreduce=)`:
    its per-voucher counts and next-wave seeding combine per-shard
    partials with a `psum`, so a voucher whose slashed vouchees' edges
    live on DIFFERENT shards is clipped once with the global k, and a
    wiped voucher seeds the next wave even when its own vouchers' edges
    sit on another shard.

    Returns fn(vouch, sigma, seeds, session_slot, risk_weight, now) ->
    SlashWaveResult; the inputs are not written (the result's vouch
    table carries a new `active` column, whole)."""

    def step(vouch, sigma, seeds, session_slot, risk_weight, now):
        res = liability_ops.slash_cascade(
            shard_table(vouch, mesh), sigma, seeds, session_slot, risk_weight, now,
            trust=trust, allreduce=lambda parts: psum(parts, mesh)[0],
        )
        active = gather_rows([v.active for v in res.vouch], vouch.active.device)
        return res._replace(vouch=dataclasses.replace(vouch, active=active))

    return step


# ── the fused governance wave, sharded ───────────────────────────────


class EventualPartials(NamedTuple):
    """EVENTUAL sessions' deferred replica updates from one mode-
    dispatched governance wave: per-shard [D, S_cap] partials, folded
    between waves by `reconcile_wave_sessions`. Each wave session lives
    on exactly one shard, so the cross-shard sum of masked overwrites
    reconstructs the exact update (the in-wave STRONG fold's trick)."""

    counts: torch.Tensor      # i32[D, S_cap] participant-count deltas
    owned: torch.Tensor       # i32[D, S_cap] >0 where this shard owns the lane
    state: torch.Tensor       # i32[D, S_cap] masked FSM-state overwrites
    terminated: torch.Tensor  # f32[D, S_cap] masked terminated_at overwrites


class GatewayLanes(NamedTuple):
    """Per-action outputs of a sharded gateway wave ([B] lanes).

    `ops.gateway.GatewayResult` minus the table (the table flows back
    through the wave's own agents output)."""

    verdict: torch.Tensor       # i8[B]
    ring_status: torch.Tensor   # i8[B]
    eff_ring: torch.Tensor      # i8[B]
    sigma_eff: torch.Tensor     # f32[B]
    severity: torch.Tensor      # i8[B]
    anomaly_rate: torch.Tensor  # f32[B]
    window_calls: torch.Tensor  # i32[B]
    tripped: torch.Tensor       # bool[B]


def _gateway_lanes(result) -> GatewayLanes:
    return GatewayLanes(
        verdict=result.verdict,
        ring_status=result.ring_status,
        eff_ring=result.eff_ring,
        sigma_eff=result.sigma_eff,
        severity=result.severity,
        anomaly_rate=result.anomaly_rate,
        window_calls=result.window_calls,
        tripped=result.tripped,
    )


def _gateway_shards(mesh, a_parts, elevations, cols, valid, now, breach, rate,
                    trust) -> GatewayLanes:
    """Phase 7 / the sharded gateway: `ops.gateway.check_actions` on each
    shard's agent rows (in place) with the replicated elevations; lanes
    whole, on the elevations' device."""
    from hypervisor_tpu_torch.ops import gateway as gateway_ops

    col_parts = _lanes(mesh, *cols, valid)
    lanes = []
    for d, a in enumerate(a_parts):
        dev = a.ring.device
        base = _linear_shard_index(d) * a.ring.shape[0]
        gw = gateway_ops.check_actions(
            a, _replica(elevations, dev), *(c[d] for c in col_parts[:6]), now,
            valid=col_parts[6][d], agent_base=base, breach=breach, rate_limit=rate, trust=trust,
        )
        lanes.append(_gateway_lanes(gw))
    home = elevations.agent.device
    return GatewayLanes(*(gather_rows([getattr(x, f) for x in lanes], home)
                          for f in GatewayLanes._fields))


def sharded_governance_wave(
    mesh: Mesh,
    trust: TrustConfig = DEFAULT_CONFIG.trust,
    rate=DEFAULT_CONFIG.rate_limit,
    with_gateway: bool = False,
    breach=DEFAULT_CONFIG.breach,
    mode_dispatch: bool = False,
    contiguous_waves: bool = False,
    unique_sessions: bool = False,
    use_pallas: bool | None = None,
    multislice: bool = False,
):
    """The fused full-governance wave, sharded end to end: the multi-
    device twin of `ops.pipeline.governance_wave`. AgentTable rows and
    VouchTable edges shard over the mesh, the SessionTable is replicated
    and updated only through psum'd deltas. Phases and their collectives:

      1-2. vouched admission: `_wave_admission` (the body
           `sharded_admission` runs): contribution psum, all_gather
           capacity ranking, psum'd session-count delta,
      3.   session FSM HANDSHAKING -> ACTIVE on each shard's K/D wave
           lanes, folded into the replica via a psum'd state delta,
      4.   audit: the chain (B2) and Merkle roots (B3) on each shard's
           lanes (no collective),
      5.   one saga step per joining agent,
      6.   terminate: the in_wave mask is psum-merged (riding the
           admission count psum) so EVERY shard releases its own
           edge/agent blocks for ALL wave sessions; released counts psum
           to the global total; the ARCHIVED walk folds in like phase 3.
           With `contiguous_waves` the mask and its psum disappear: the
           step takes two replicated scalars (wave_lo, wave_hi) right
           after `omega`, asserting the global wave is the contiguous
           slot block [lo, hi).

    Contracts: wave length B and session count K divisible by the mesh
    size; wave element i's agent slot lives on shard i // (B/D); wave
    session j is hashed on shard j // (K/D). Returns the same
    `WaveResult` as the single-device wave; the agent, session and vouch
    tables are updated in place.

    `with_gateway=True` appends phase 7: the per-action gateway
    (`ops.gateway.check_actions` under the `sharded_gateway` placement
    contract) over standing memberships on the post-terminate table. The
    step then takes (..., elevations, act_slot, act_required,
    act_read_only, act_consensus, act_witness, act_host_tripped,
    act_valid) and returns (WaveResult, GatewayLanes).

    `mode_dispatch=True` executes the session `mode` column: STRONG
    sessions' replica updates fold in-wave; EVENTUAL sessions' come back
    as `EventualPartials` (appended last), folded between waves by
    `reconcile_wave_sessions`, after which the table is bit-identical to
    the all-STRONG wave's.

    `multislice=True` (a (dcn, agents) mesh): every replica commit defers
    to `multislice_reconcile_wave`; it requires mode_dispatch,
    contiguous_waves and unique_sessions. `use_pallas` is the reference's
    kernel switch and is not read: CUDA tensors take the kernels.
    """
    from hypervisor_tpu_torch.ops import merkle as merkle_ops
    from hypervisor_tpu_torch.ops import saga_ops, session_fsm
    from hypervisor_tpu_torch.ops import terminate as terminate_ops
    from hypervisor_tpu_torch.ops.pipeline import WaveResult

    if multislice and not (mode_dispatch and contiguous_waves and unique_sessions):
        raise ValueError(
            "multislice wave requires mode_dispatch=True, "
            "contiguous_waves=True, unique_sessions=True"
        )
    row_axes = (DCN_AXIS, AGENT_AXIS) if multislice else AGENT_AXIS
    n_shards = mesh.devices.size
    devs = list(mesh.devices.flat)

    def step(agents, sessions, vouches, slot, did, session_slot, sigma_raw, trustworthy,
             duplicate, wave_sessions, delta_bodies, now, omega, *rest):
        if contiguous_waves:
            wave_lo, wave_hi = int(rest[0]), int(rest[1])
            gw_args = rest[2:]
        else:
            gw_args = rest
        home = agents.f32.device
        s_cap = sessions.i32.shape[0]
        a_parts, v_parts = shard_table(agents, mesh), shard_table(vouches, mesh)
        lanes = _lanes(mesh, slot, did, session_slot, sigma_raw, trustworthy, duplicate)
        ws = split_rows(wave_sessions, mesh)
        bodies = split_rows(delta_bodies, mesh, dim=1)

        # Each phase runs over every shard inside one span
        # (`profiling.stage_scope`): the flight recorder's child times.
        # ── 1-2. cross-shard vouched admission ────────────────────
        with profiling.stage_scope("admission_wave"):
            fold_extra = None
            if not contiguous_waves:
                fold_extra = []
                for d in range(n_shards):
                    m = torch.zeros((s_cap,), dtype=torch.int32, device=devs[d])
                    m[ws[d].clamp(min=0).to(torch.int64)] = 1
                    fold_extra.append(m)
            admitted = _wave_admission(
                mesh, a_parts, sessions, v_parts, *lanes, now, omega, trust, rate,
                mode_dispatch=mode_dispatch, unique_sessions=unique_sessions,
                row_axes=row_axes, force_eventual=multislice, fold_extra=fold_extra,
            )
            status, ring, sigma_eff = admitted[:3]
            rest_out = admitted[3:]
            if mode_dispatch:
                view_counts, ev_counts_local = rest_out[:2]
                rest_out = rest_out[2:]
            else:
                view_counts = sessions.n_participants
            in_wave = (rest_out[0] > 0) if fold_extra is not None else None
            ok = [s == admission_ops.ADMIT_OK for s in status]

        t = delta_bodies.shape[0]
        p = 1 << max(0, (t - 1).bit_length())
        state_col = sessions.state
        term_col = sessions.terminated_at
        mode_col = sessions.mode
        per = [dict(wsi=ws[d].to(torch.int64)) for d in range(n_shards)]
        # ── 3. FSM walk on each shard's wave lanes ────────────────
        with profiling.stage_scope("session_fsm"):
            for d, sh in enumerate(per):
                dev, wsi = devs[d], sh["wsi"]
                sh["has_members"] = view_counts.to(dev)[wsi] > 0
                sh["wave_state"], sh["err_a"] = session_fsm.apply_session_transitions(
                    state_col.to(dev)[wsi].to(torch.int8), SessionState.ACTIVE.code,
                    sh["has_members"])
        # ── 4. audit: chain (B2) + Merkle roots (B3) ──────────────
        with profiling.stage_scope("delta_chain"):
            for d, sh in enumerate(per):
                chain = merkle_ops.chain_digests(bodies[d])
                leaves = torch.zeros((sh["wsi"].shape[0], p, 8), dtype=torch.int32,
                                     device=devs[d])
                leaves[:, :t] = chain.transpose(0, 1)
                sh["chain"], sh["roots"] = chain, merkle_ops.merkle_root_lanes(leaves, t)
        # ── 5. one saga step per joining agent ────────────────────
        with profiling.stage_scope("saga_round"):
            for d, sh in enumerate(per):
                b_local = ok[d].shape[0]
                sh["step_state"], _ = saga_ops.execute_attempt(
                    torch.full((b_local,), saga_ops.STEP_PENDING, dtype=torch.int8,
                               device=devs[d]),
                    ok[d], torch.zeros((b_local,), dtype=torch.int8, device=devs[d]))
        # ── 6. terminate: global wave, local block release, then the
        # replica's fold ───────────────────────────────────────────
        with profiling.stage_scope("terminate_wave"):
            for d, sh in enumerate(per):
                dev, wsi, has_members = devs[d], sh["wsi"], sh["has_members"]
                if contiguous_waves:
                    sh["released"] = terminate_ops.release_session_scope(
                        a_parts[d], v_parts[d], None, wave_range=(wave_lo, wave_hi))
                else:
                    sh["released"] = terminate_ops.release_session_scope(
                        a_parts[d], v_parts[d], in_wave.to(dev))
                wave_state, err_t = session_fsm.apply_session_transitions(
                    sh["wave_state"], SessionState.TERMINATING.code, has_members)
                wave_state, err_z = session_fsm.apply_session_transitions(
                    wave_state, SessionState.ARCHIVED.code, has_members)
                if multislice:
                    strong_lane = torch.zeros(wsi.shape, dtype=torch.bool, device=dev)
                elif mode_dispatch:
                    strong_lane = mode_col.to(dev)[wsi.clamp(min=0)] == 0
                else:
                    strong_lane = torch.ones(wsi.shape, dtype=torch.bool, device=dev)
                sh.update(wsi=wsi.clamp(min=0), wave_state=wave_state,
                          fsm_error=sh["err_a"] | err_t | err_z, strong=strong_lane,
                          lane_term=torch.where(has_members, f32_scalar(now, dev),
                                                term_col.to(dev)[wsi]))

            def lane_fold(sh, mask):
                """Masked scatters of this shard's lanes: (owned, state,
                terminated_at) over the session rows."""
                dev = mask.device

                def scatter(dtype, val):
                    return torch.zeros((s_cap,), dtype=dtype, device=dev).index_add_(
                        0, sh["wsi"], torch.where(mask, val, torch.zeros((), dtype=dtype,
                                                                         device=dev)))

                return (scatter(torch.int32, torch.ones((), dtype=torch.int32, device=dev)),
                        scatter(torch.int32, sh["wave_state"].to(torch.int32)),
                        scatter(torch.float32, sh["lane_term"]))

            if multislice:
                # Every commit defers to the DCN reconcile, so the released
                # total rides its own cross-shard reduction.
                released = psum([sh["released"] for sh in per], mesh, row_axes)[0].to(home)
            else:
                # ONE psum carries the whole post-terminate fold: the three
                # FSM replica rows and the released-bond total, stacked as
                # f32 [4, S] (small integers, exact; term values are
                # single-owner sums, exact under zero padding).
                payload = []
                for sh in per:
                    owned_s, state_s, term_s = lane_fold(sh, sh["strong"])
                    rel = torch.zeros((s_cap,), dtype=torch.float32, device=owned_s.device)
                    rel[0] = sh["released"].to(torch.float32)
                    payload.append(torch.stack([owned_s.to(torch.float32),
                                                state_s.to(torch.float32), term_s, rel]))
                folded = psum(payload, mesh, AGENT_AXIS)[0].to(sessions.i32.device)
                owned = folded[0] > 0
                sessions.i32[:, SI32_STATE] = torch.where(
                    owned, folded[1].to(torch.int32), sessions.state.to(torch.int32)
                ).to(torch.int8).to(torch.int32)
                sessions.f32[:, SF32_TERMINATED_AT] = torch.where(
                    owned, folded[2], sessions.terminated_at)
                released = folded[3, 0].to(torch.int32).to(home)
            if mode_dispatch:
                ev = [lane_fold(sh, ~sh["strong"]) for sh in per]
                partials = EventualPartials(
                    counts=gather_rows([c[None] for c in ev_counts_local], home),
                    owned=gather_rows([e[0][None] for e in ev], home),
                    state=gather_rows([e[1][None] for e in ev], home),
                    terminated=gather_rows([e[2][None] for e in ev], home),
                )

        if with_gateway:
            # ── 7. action gateway over standing memberships, on the
            # post-terminate table; shard-local by the placement contract.
            elevations, *act = gw_args
            gw_lanes = _gateway_shards(mesh, a_parts, elevations, act[:6], act[6], now,
                                       breach, rate, trust)
        write_back(agents, a_parts)
        write_back(vouches, v_parts)
        wave_result = WaveResult(
            agents=agents, sessions=sessions, vouches=vouches,
            status=gather_rows(status, home), ring=gather_rows(ring, home),
            sigma_eff=gather_rows(sigma_eff, home),
            saga_step_state=gather_rows([sh["step_state"] for sh in per], home),
            merkle_root=gather_rows([sh["roots"] for sh in per], home),
            chain=gather_rows([sh["chain"] for sh in per], home, dim=1),
            fsm_error=gather_rows([sh["fsm_error"] for sh in per], home),
            released=released,
        )
        if with_gateway:
            if mode_dispatch:
                return wave_result, gw_lanes, partials
            return wave_result, gw_lanes
        if mode_dispatch:
            return wave_result, partials
        return wave_result

    return step


def reconcile_wave_sessions(mesh: Mesh, row_axes=AGENT_AXIS):
    """Fold one wave's `EventualPartials` into the replicated
    SessionTable: the between-wave EVENTUAL commit. After this fold the
    table is bit-identical to what the all-STRONG wave would have
    committed in-wave.

    Returns fn(sessions, counts [D, S], owned [D, S], state [D, S],
    terminated [D, S]) -> sessions (updated in place); partial rows are
    sharded over `row_axes`. Fold ONE wave's partials per call:
    `state`/`terminated` are masked OVERWRITES, and summing two waves
    that own the same recycled session lane would corrupt both (only
    `counts` sums across waves) - the state bridge loops pending waves
    in order (`reconcile_session_partials`).
    """

    def merge(sessions, counts, owned, state, terminated):
        home = sessions.i32.device

        def total(rows):
            return psum([_local_row_sum(p) for p in split_rows(rows, mesh)], mesh,
                        row_axes)[0].to(home)

        total_counts = total(counts)
        owned_g = total(owned) > 0
        state_g = total(state)
        term_g = total(terminated)
        sessions.i32[:, SI32_NPART] += total_counts
        sessions.i32[:, SI32_STATE] = torch.where(
            owned_g, state_g, sessions.state.to(torch.int32)).to(torch.int8).to(torch.int32)
        sessions.f32[:, SF32_TERMINATED_AT] = torch.where(owned_g, term_g,
                                                          sessions.terminated_at)
        return sessions

    return merge


def multislice_reconcile_wave(mesh: Mesh):
    """`reconcile_wave_sessions` over a 2-D (dcn, agents) mesh: fold one
    multislice wave's `EventualPartials` over BOTH axes, the one
    inter-slice commit per tick. Same masked-overwrite semantics and the
    same one-wave-per-call rule as the 1-D fold (shared body)."""
    return reconcile_wave_sessions(mesh, row_axes=(DCN_AXIS, AGENT_AXIS))


# ── sharded action gateway ───────────────────────────────────────────


def sharded_gateway(
    mesh: Mesh,
    breach=DEFAULT_CONFIG.breach,
    rate=DEFAULT_CONFIG.rate_limit,
    trust: TrustConfig = DEFAULT_CONFIG.trust,
):
    """The per-action gateway (`ops.gateway.check_actions`) over a mesh:
    agent rows shard over the mesh, the ElevationTable is replicated (each
    shard keeps the grants landing on its rows), and the action wave
    shards over its own length.

    Placement contract: action element i's GLOBAL agent slot lives on
    shard i // (B/D). Every action of one membership then lands on ONE
    shard, so the in-wave sequential dependences (breaker prefix, rate
    settle) stay shard-local and the gateway needs NO collective. Lanes
    that pad a ragged wave arrive `valid=False`
    (`HypervisorState.check_actions_wave(mesh=...)` builds the layout).

    Returns fn(agents, elevations, slot, required_ring, is_read_only,
    has_consensus, has_sre_witness, host_tripped, valid, now) ->
    (AgentTable (updated in place), GatewayLanes). On a 2-D (dcn, agents)
    mesh the rows shard over the flattened grid, still collective-free.
    """

    def step(agents, elevations, slot, required_ring, is_read_only, has_consensus,
             has_sre_witness, host_tripped, valid, now):
        a_parts = shard_table(agents, mesh)
        lanes = _gateway_shards(
            mesh, a_parts, elevations,
            (slot, required_ring, is_read_only, has_consensus, has_sre_witness, host_tripped),
            valid, now, breach, rate, trust)
        write_back(agents, a_parts)
        return agents, lanes

    return step
