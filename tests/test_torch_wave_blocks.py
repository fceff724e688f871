"""The plain versions of the wave's table kernels against the reference on
the CPU: admission (kernel B4's plain version) against the reference's
`admission_block_np` twin and its XLA `admit_batch`; the fsm/saga/
terminate block (B5's) against `fsm_saga_block_np`; and the small ops
they are built from. Bit for bit throughout."""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervisor_tpu.config import DEFAULT_CONFIG
from hypervisor_tpu.kernels import wave_pallas
from hypervisor_tpu.ops import admission as jax_admission
from hypervisor_tpu.ops import liability as jax_liability
from hypervisor_tpu.ops import saga_ops as jax_saga
from hypervisor_tpu.ops import session_fsm as jax_fsm
from hypervisor_tpu.tables.state import AgentTable, SessionTable, VouchTable
from hypervisor_tpu.tables.struct import replace as jax_replace
from hypervisor_tpu_torch.kernels import wave
from hypervisor_tpu_torch.ops import admission, liability, saga_ops, session_fsm
from hypervisor_tpu_torch.tables import state as ts
from hypervisor_tpu_torch.tables.state import AgentTable as PAgents
from hypervisor_tpu_torch.tables.state import SessionTable as PSessions
from hypervisor_tpu_torch.tables.state import VouchTable as PVouches

N, SC, E = 64, 32, 48
BURSTS = DEFAULT_CONFIG.rate_limit.ring_bursts


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _port_agents(a) -> PAgents:
    return PAgents(f32=_t(a.f32), i32=_t(a.i32), ring=_t(a.ring))


def _port_sessions(s) -> PSessions:
    return PSessions(
        i32=_t(s.i32), f32=_t(s.f32), enable_audit=_t(s.enable_audit),
        has_nonreversible=_t(s.has_nonreversible),
    )


def _stage_admission(rng, b, unique):
    agents = AgentTable.create(N)
    sessions = SessionTable.create(SC)
    live = rng.choice(SC, SC // 2, replace=False)
    sessions = jax_replace(
        sessions,
        state=sessions.state.at[live].set(1),
        n_participants=sessions.n_participants.at[live[:3]].set(2),
        max_participants=sessions.max_participants.at[:].set(3),
        min_sigma_eff=sessions.min_sigma_eff.at[:].set(0.5),
    )
    if unique:
        session_slot = rng.choice(SC, b, replace=False).astype(np.int32)
    else:
        # Crowd a few live sessions so some lanes run out of seats.
        session_slot = rng.choice(live[:4], b).astype(np.int32)
    lanes = dict(
        slot=rng.choice(N, b, replace=False).astype(np.int32),
        did=rng.randint(0, 1000, b).astype(np.int32),
        session_slot=session_slot,
        sigma_raw=rng.uniform(0, 1, b).astype(np.float32),
        trustworthy=rng.uniform(size=b) > 0.2,
        duplicate=rng.uniform(size=b) > 0.85,
    )
    contribution = rng.uniform(0, 0.5, b).astype(np.float32)
    return agents, sessions, lanes, contribution


@pytest.mark.parametrize("unique,b", [(True, 16), (False, 24), (False, 7)])
def test_admission_plain_matches_twin_and_admit_batch(unique, b):
    rng = np.random.RandomState(7 + b)
    agents, sessions, lanes, contribution = _stage_admission(rng, b, unique)
    twin = wave_pallas.admission_block_np(
        np.asarray(agents.f32), np.asarray(agents.i32), np.asarray(agents.ring),
        np.asarray(sessions.i32), np.asarray(sessions.f32),
        lanes["slot"], lanes["did"], lanes["session_slot"], lanes["sigma_raw"],
        contribution, np.float32(0.5), lanes["trustworthy"], lanes["duplicate"],
        np.float32(3.0), np.asarray(BURSTS, np.float32),
        ring2_threshold=DEFAULT_CONFIG.trust.ring2_threshold, unique_sessions=unique,
    )
    ref = jax_admission.admit_batch(
        agents, sessions, now=3.0, contribution=jnp.asarray(contribution), omega=0.5,
        unique_sessions=unique, **{k: jnp.asarray(v) for k, v in lanes.items()},
    )
    p_agents, p_sessions = _port_agents(agents), _port_sessions(sessions)
    status, ring, sigma_eff = wave.admission_block(
        p_agents, p_sessions, *(_t(lanes[k]) for k in ("slot", "did", "session_slot", "sigma_raw")),
        _t(contribution), 0.5, _t(lanes["trustworthy"]), _t(lanes["duplicate"]), 3.0,
        BURSTS, DEFAULT_CONFIG.trust, unique,
    )
    got = (p_agents.f32, p_agents.i32, p_agents.ring, p_sessions.i32, status, ring, sigma_eff)
    for g, want in zip(got, twin):
        assert g.numpy().tobytes() == np.asarray(want).tobytes()
    for g, want in zip(
        (p_agents.f32, p_agents.i32, p_agents.ring, p_sessions.i32, status, ring, sigma_eff),
        (ref.agents.f32, ref.agents.i32, ref.agents.ring, ref.sessions.i32,
         ref.status, ref.ring, ref.sigma_eff),
    ):
        assert g.numpy().tobytes() == np.asarray(want).tobytes()
    codes = set(status.tolist())
    assert admission.ADMIT_OK in codes and admission.ADMIT_DUPLICATE in codes
    if not unique and b > 20:
        assert admission.ADMIT_CAPACITY in codes


def test_admission_plain_on_the_shared_session_layout():
    """Four lanes join each session in one wave, every lane otherwise
    admissible; one session has two seats left, so its last two lanes
    are refused for capacity in lane order."""
    rng = np.random.RandomState(12)
    b, n_sessions = 32, 8
    live = rng.choice(SC, n_sessions, replace=False)
    sessions = SessionTable.create(SC)
    sessions = jax_replace(
        sessions,
        state=sessions.state.at[live].set(1),
        n_participants=sessions.n_participants.at[live[0]].set(8),
        max_participants=sessions.max_participants.at[:].set(10),
        min_sigma_eff=sessions.min_sigma_eff.at[:].set(0.5),
    )
    agents = AgentTable.create(N)
    lanes = dict(
        slot=rng.choice(N, b, replace=False).astype(np.int32),
        did=rng.randint(0, 1000, b).astype(np.int32),
        session_slot=live[np.arange(b) % n_sessions].astype(np.int32),
        sigma_raw=rng.uniform(0.6, 1.0, b).astype(np.float32),
        trustworthy=np.ones(b, bool),
        duplicate=np.zeros(b, bool),
    )
    contribution = rng.uniform(0, 0.2, b).astype(np.float32)
    twin = wave_pallas.admission_block_np(
        np.asarray(agents.f32), np.asarray(agents.i32), np.asarray(agents.ring),
        np.asarray(sessions.i32), np.asarray(sessions.f32),
        lanes["slot"], lanes["did"], lanes["session_slot"], lanes["sigma_raw"],
        contribution, np.float32(0.5), lanes["trustworthy"], lanes["duplicate"],
        np.float32(3.0), np.asarray(BURSTS, np.float32),
        ring2_threshold=DEFAULT_CONFIG.trust.ring2_threshold, unique_sessions=False,
    )
    p_agents, p_sessions = _port_agents(agents), _port_sessions(sessions)
    status, ring, sigma_eff = wave.admission_block_plain(
        p_agents, p_sessions, *(_t(lanes[k]) for k in ("slot", "did", "session_slot", "sigma_raw")),
        _t(contribution), 0.5, _t(lanes["trustworthy"]), _t(lanes["duplicate"]), 3.0,
        BURSTS, DEFAULT_CONFIG.trust, False,
    )
    got = (p_agents.f32, p_agents.i32, p_agents.ring, p_sessions.i32, status, ring, sigma_eff)
    for g, want in zip(got, twin):
        assert g.numpy().tobytes() == np.asarray(want).tobytes()
    refused = np.flatnonzero(status.numpy() != admission.ADMIT_OK)
    np.testing.assert_array_equal(refused, [16, 24])  # live[0]'s third and fourth joins
    assert set(status.numpy()[refused].tolist()) == {admission.ADMIT_CAPACITY}


def test_rank_within_session_matches_twin():
    keys = np.random.RandomState(1).randint(-5, 6, 64).astype(np.int64)
    np.testing.assert_array_equal(
        admission.rank_within_session(torch.from_numpy(keys)).numpy(),
        wave_pallas._rank_within_np(keys),
    )


def _stage_fsm(rng, k, b, lo):
    sessions = SessionTable.create(SC)
    ks = np.arange(lo, lo + k, dtype=np.int32)
    states = rng.choice([0, 1, 2, 3, 4, 9], k).astype(np.int32)
    sessions = jax_replace(
        sessions,
        state=sessions.state.at[ks].set(states),
        n_participants=sessions.n_participants.at[ks].set(rng.randint(0, 3, k)),
        terminated_at=sessions.terminated_at.at[:].set(rng.uniform(0, 5, SC).astype(np.float32)),
    )
    agents = AgentTable.create(N)
    agents = jax_replace(
        agents,
        session=agents.session.at[:].set(rng.randint(-1, SC, N)),
        flags=agents.flags.at[:].set(rng.randint(0, 32, N)),
    )
    vsess = rng.randint(-1, SC, E).astype(np.int32)
    vact = rng.uniform(size=E) > 0.3
    ok = rng.uniform(size=b) > 0.4
    return agents, sessions, ks, vsess, vact, ok


@pytest.mark.parametrize("has_range", [True, False])
def test_fsm_saga_plain_matches_twin(has_range):
    rng = np.random.RandomState(5 + has_range)
    k, b, lo = 9, 12, 4
    agents, sessions, ks, vsess, vact, ok = _stage_fsm(rng, k, b, lo)
    twin = wave_pallas.fsm_saga_block_np(
        np.asarray(agents.i32), np.asarray(sessions.i32), np.asarray(sessions.f32),
        vsess, vact, ks, ok, np.float32(7.5), np.int32(lo), np.int32(lo + k),
        has_range=has_range, transition_bits=jax_fsm._TRANSITION_BITS,
        active_code=2, terminating_code=3, archived_code=4,
    )
    p_agents, p_sessions = _port_agents(agents), _port_sessions(sessions)
    vouches = PVouches.create(E, "cpu")
    vouches.session.copy_(_t(vsess))
    vouches.active.copy_(_t(vact))
    step, wstate, err, released = wave.fsm_saga_block(
        p_agents, p_sessions, vouches, _t(ks), _t(ok), 7.5,
        (lo, lo + k) if has_range else None,
    )
    got = (p_agents.i32, p_sessions.i32, p_sessions.f32, vouches.active, step, wstate, err)
    for g, want in zip(got, twin[:7]):
        assert g.numpy().tobytes() == np.asarray(want).tobytes()
    assert int(released) == int(twin[7])
    assert err.any() and not err.all()  # the odd states walk illegally


def test_fsm_saga_plain_mask_form_on_a_scattered_layout():
    """B5's mask form (no `wave_range`) on a wave whose sessions leave
    gaps and come in no order, with two parked rows (memberless, past the
    live rows) at its end, against the reference's numpy twin; members
    and live edges sit on sessions inside and outside the wave."""
    rng = np.random.RandomState(9)
    b = 12
    agents, sessions, _, vsess, vact, ok = _stage_fsm(rng, SC - 4, b, 0)
    ks = np.concatenate([rng.choice(SC - 4, 9, replace=False), [SC - 2, SC - 1]]).astype(np.int32)
    assert not np.array_equal(np.sort(ks), ks) and np.ptp(ks[:9]) > 9  # out of order, gaps
    twin = wave_pallas.fsm_saga_block_np(
        np.asarray(agents.i32), np.asarray(sessions.i32), np.asarray(sessions.f32),
        vsess, vact, ks, ok, np.float32(7.5), np.int32(0), np.int32(0),
        has_range=False, transition_bits=jax_fsm._TRANSITION_BITS,
        active_code=2, terminating_code=3, archived_code=4,
    )
    p_agents, p_sessions = _port_agents(agents), _port_sessions(sessions)
    vouches = PVouches.create(E, "cpu")
    vouches.session.copy_(_t(vsess))
    vouches.active.copy_(_t(vact))
    step, wstate, err, released = wave.fsm_saga_block(
        p_agents, p_sessions, vouches, _t(ks), _t(ok), 7.5, None)
    got = (p_agents.i32, p_sessions.i32, p_sessions.f32, vouches.active, step, wstate, err)
    for g, want in zip(got, twin[:7]):
        assert g.numpy().tobytes() == np.asarray(want).tobytes()
    assert int(released) == int(twin[7]) > 0
    outside = ~np.isin(vsess, ks) & vact
    assert outside.any() and vouches.active.numpy()[outside].all()


def test_transition_bits_match_reference():
    assert tuple(int(x) for x in session_fsm.TRANSITION_BITS) == tuple(
        int(x) for x in jax_fsm._TRANSITION_BITS
    )
    np.testing.assert_array_equal(
        session_fsm.SESSION_TRANSITION_MATRIX, jax_fsm.SESSION_TRANSITION_MATRIX
    )


def test_execute_attempt_matches_reference():
    rng = np.random.RandomState(2)
    state = rng.randint(0, 7, 40).astype(np.int8)
    success = rng.uniform(size=40) > 0.5
    retries = rng.randint(0, 3, 40).astype(np.int8)
    want = jax_saga.execute_attempt(jnp.asarray(state), jnp.asarray(success), jnp.asarray(retries))
    got = saga_ops.execute_attempt(_t(state), _t(success), _t(retries))
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


def _several_vouchers_per_vouchee():
    """A vouch table with many edges per vouchee (some expired, some
    inactive, some out of scope), the slots' target sessions, and the
    reference's contribution."""
    rng = np.random.RandomState(4)
    vouches = VouchTable.create(E)
    n_live = 40
    e = jnp.arange(n_live)
    vouchee = rng.randint(-1, 6, n_live).astype(np.int32)  # many edges per vouchee
    vouches = jax_replace(
        vouches,
        voucher=vouches.voucher.at[e].set(rng.randint(0, N, n_live)),
        vouchee=vouches.vouchee.at[e].set(vouchee),
        session=vouches.session.at[e].set(rng.randint(0, 3, n_live)),
        bond=vouches.bond.at[e].set(rng.uniform(0, 0.4, n_live).astype(np.float32)),
        active=vouches.active.at[e].set(rng.uniform(size=n_live) > 0.2),
        expiry=vouches.expiry.at[e].set(rng.choice([1.0, 50.0, np.inf], n_live).astype(np.float32)),
    )
    target = rng.randint(-2, 3, N).astype(np.int32)
    want = jax_liability.contribution_toward(vouches, jnp.asarray(target), jnp.float32(10.0))
    port_v = PVouches(**{f: _t(getattr(vouches, f)) for f in vouches.__dataclass_fields__})
    assert (np.bincount(vouchee[vouchee >= 0]) > 2).any()
    return port_v, _t(target), np.asarray(want)


def test_contribution_toward_with_several_vouchers_per_vouchee():
    port_v, target, want = _several_vouchers_per_vouchee()
    got = liability.contribution_toward(port_v, target, admission.f32_scalar(10.0, "cpu"))
    assert got.numpy().tobytes() == want.tobytes()


def _several_scoped_per_vouchee():
    """Most edges scoped, several on each vouchee, in a scrambled edge
    order, and the reference's contribution."""
    rng = np.random.RandomState(6)
    target = np.full(N, -2, np.int32)
    target[:6] = rng.randint(0, 3, 6)
    vouchee = rng.randint(-1, 6, E).astype(np.int32)
    session = np.where(rng.uniform(size=E) < 0.8, target[np.maximum(vouchee, 0)],
                       rng.randint(0, 3, E)).astype(np.int32)
    vouches = jax_replace(
        VouchTable.create(E),
        voucher=jnp.asarray(rng.randint(0, N, E).astype(np.int32)),
        vouchee=jnp.asarray(vouchee),
        session=jnp.asarray(session),
        bond=jnp.asarray(rng.uniform(0, 0.4, E).astype(np.float32)),
        active=jnp.asarray(rng.uniform(size=E) > 0.1),
        expiry=jnp.asarray(rng.choice([1.0, 50.0, np.inf], E).astype(np.float32)),
    )
    want = jax_liability.contribution_toward(vouches, jnp.asarray(target), jnp.float32(10.0))
    port_v = PVouches(**{f: _t(getattr(vouches, f)) for f in vouches.__dataclass_fields__})
    return port_v, _t(target), np.asarray(want)


def _one_vouchee_holds_all():
    """Every edge of the table live and scoped on one vouchee, and the
    reference's contribution."""
    rng = np.random.RandomState(5)
    vouches = VouchTable.create(E)
    vouches = jax_replace(
        vouches,
        voucher=jnp.asarray(rng.randint(0, N, E).astype(np.int32)),
        vouchee=jnp.full((E,), 7, jnp.int32),
        session=jnp.full((E,), 2, jnp.int32),
        bond=jnp.asarray(rng.uniform(0, 0.4, E).astype(np.float32)),
        active=jnp.ones((E,), bool),
    )
    target = np.full(N, -2, np.int32)
    target[7] = 2
    want = jax_liability.contribution_toward(vouches, jnp.asarray(target), jnp.float32(10.0))
    port_v = PVouches(**{f: _t(getattr(vouches, f)) for f in vouches.__dataclass_fields__})
    return port_v, _t(target), np.asarray(want)


@pytest.mark.parametrize("table, fullest", [
    (_several_vouchers_per_vouchee, 1),
    (_several_scoped_per_vouchee, 3),
    (_one_vouchee_holds_all, E),
])
def test_contribution_buckets_folded_in_order_match_reference(table, fullest):
    """The CUDA path's layout (csrc/wave.cu, the contribution kernels):
    count the live scoped edges per vouchee, scan the counts into bucket
    offsets, fill each bucket in an arbitrary order (the atomics'), then
    order each bucket by edge index and fold its bonds in f32 from +0.0;
    an empty bucket gives +0.0. That gives the reference's bits."""
    port_v, target, want = table()
    vee, scoped = liability.scoped_edges(port_v, target, admission.f32_scalar(10.0, "cpu"))
    vee, scoped, bond = vee.numpy(), scoped.numpy(), port_v.bond.numpy()
    n = target.shape[0]
    count = np.zeros(n, np.int64)
    place = np.full(vee.shape[0], -1)
    for e in np.random.RandomState(0).permutation(vee.shape[0]):  # atomics in any order
        if scoped[e]:
            place[e] = count[vee[e]]
            count[vee[e]] += 1
    offset = np.concatenate([[0], np.cumsum(count)[:-1]])
    bucket = np.full(int(count.sum()), -1)
    for e in np.flatnonzero(place >= 0):
        bucket[offset[vee[e]] + place[e]] = e
    got = np.zeros(n, np.float32)
    for k in np.flatnonzero(count):
        acc = np.float32(0.0)
        for e in np.sort(bucket[offset[k]:offset[k] + count[k]]):
            acc = np.float32(acc + bond[e])
        got[k] = acc
    assert count.max() >= fullest
    assert got.tobytes() == want.tobytes()


def test_wave_kernel_columns_match_the_table_layout():
    """csrc/wave.cu hard-codes the packed column layout; pin it to
    tables/state.py so the two cannot drift."""
    src = (Path(wave.__file__).resolve().parent.parent / "csrc" / "wave.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (-?\d+);", src))
    checked = 0
    for name, value in consts.items():
        if hasattr(ts, name):
            assert getattr(ts, name) == int(value), name
            checked += 1
    assert checked >= 15
    assert int(consts["ADMIT_CAPACITY"]) == admission.ADMIT_CAPACITY
    assert int(consts["STEP_COMMITTED"]) == saga_ops.STEP_COMMITTED
    assert int(consts["STEP_FAILED"]) == saga_ops.STEP_FAILED


def test_wave_blocks_refuse_a_device_with_no_kernel_and_no_plain_path():
    with pytest.raises(ValueError, match="no kernel or plain path"):
        wave.fsm_saga_block(
            None, None, None, torch.zeros(1, dtype=torch.int32, device="meta"),
            torch.zeros(1, dtype=torch.bool, device="meta"), 0.0,
        )
