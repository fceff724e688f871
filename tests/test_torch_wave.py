"""The port's governance wave against the reference, end to end, on the CPU.

The same seeded state goes through the JAX package's unarmed
`governance_wave` (jitted, `wave_kernels=False`, `use_pallas=False`) and
through `hypervisor_tpu_torch`'s wave on `device="cpu"`, over three
consecutive waves carried forward on both sides. Every output, every
table byte and every metrics column must agree bit for bit.
"""

from __future__ import annotations

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervisor_tpu.audit.delta import merkle_root_host
from hypervisor_tpu.config import HypervisorConfig, TableCapacity
from hypervisor_tpu.models import SessionConfig
from hypervisor_tpu.ops.pipeline import governance_wave as jax_wave
from hypervisor_tpu.runtime.checkpoint import state_arrays
from hypervisor_tpu.state import HypervisorState
from hypervisor_tpu.tables.struct import replace as jax_replace
from hypervisor_tpu_torch import config as port_config
from hypervisor_tpu_torch import models as port_models
from hypervisor_tpu_torch import tables as port_tables
from hypervisor_tpu_torch import u32
from hypervisor_tpu_torch.ops import pipeline as port_pipeline
from hypervisor_tpu_torch.ops.sha256 import digests_to_hex
from hypervisor_tpu_torch.state import HypervisorState as PortState

K = 6          # sessions per wave
T = 3          # audit deltas per session
N_WAVES = 3
VOUCHER_BASE = 48
SMALL = dict(max_agents=64, max_sessions=32, max_vouch_edges=64)

_JAX_WAVE = jax.jit(
    jax_wave, static_argnames=("use_pallas", "unique_sessions", "wave_kernels")
)
_METRICS_COLS = ("counters", "gauges", "hist", "hist_sum", "bounds")


def _jax_config() -> HypervisorConfig:
    return HypervisorConfig(capacity=TableCapacity(
        **SMALL, max_sagas=16, max_steps_per_saga=4, max_elevations=16,
        delta_log_capacity=256, event_log_capacity=64, trace_log_capacity=128,
    ))


def _seeded_state(seed: int):
    """A reference state: N_WAVES blocks of K sessions (max 2 seats) and
    vouch edges toward the first lanes of every wave — several vouchers
    on one vouchee, an expired edge, an inactive edge, and an edge plus a
    standing agent in a session outside every wave."""
    rng = np.random.RandomState(seed)
    state = HypervisorState(_jax_config())
    state.create_sessions_batch(
        [f"s{i}" for i in range(N_WAVES * K)],
        SessionConfig(min_sigma_eff=0.55, max_participants=2),
    )
    outside = state.create_sessions_batch(["outside"], SessionConfig())[0]
    n_edges = 4 * N_WAVES + 1
    voucher = np.full(n_edges, VOUCHER_BASE, np.int32) + np.arange(n_edges) % 16
    vouchee = np.zeros(n_edges, np.int32)
    session = np.zeros(n_edges, np.int32)
    for w in range(N_WAVES):
        lane_slot, lane_sess = w * (K + 2), w * K
        vouchee[4 * w:4 * w + 4] = [lane_slot, lane_slot, lane_slot, lane_slot + 1]
        session[4 * w:4 * w + 4] = [lane_sess, lane_sess, lane_sess, lane_sess + 1]
    vouchee[-1], session[-1] = VOUCHER_BASE - 1, outside
    bond = rng.uniform(0.05, 0.3, n_edges).astype(np.float32)
    active = np.ones(n_edges, bool)
    active[2] = False
    expiry = np.full(n_edges, np.inf, np.float32)
    expiry[5] = 1.0
    e = jnp.arange(n_edges)
    state.vouches = jax_replace(
        state.vouches,
        voucher=state.vouches.voucher.at[e].set(voucher),
        vouchee=state.vouches.vouchee.at[e].set(vouchee),
        session=state.vouches.session.at[e].set(session),
        bond=state.vouches.bond.at[e].set(bond),
        bond_pct=state.vouches.bond_pct.at[e].set(0.2),
        active=state.vouches.active.at[e].set(active),
        expiry=state.vouches.expiry.at[e].set(expiry),
    )
    state.agents = jax_replace(
        state.agents,
        session=state.agents.session.at[VOUCHER_BASE - 1].set(int(outside)),
        flags=state.agents.flags.at[VOUCHER_BASE - 1].set(1),
    )
    return state


def _lanes(seed: int, w: int, unique: bool):
    """Wave w's join lanes: K lanes on the wave's K sessions; the
    non-unique wave adds two lanes on its first session, so its third
    seat request is refused for capacity."""
    rng = np.random.RandomState(seed * 31 + w)
    sessions = np.arange(w * K, (w + 1) * K, dtype=np.int32)
    lane_sessions = sessions if unique else np.concatenate([sessions, sessions[:1], sessions[:1]])
    b = lane_sessions.shape[0]
    sigma = rng.uniform(0.3, 1.0, b).astype(np.float32)
    sigma[0] = 0.45  # lifted over the ring-2 threshold by its vouchers
    trust = rng.uniform(size=b) > 0.15
    trust[0] = True
    dup = np.zeros(b, bool)
    dup[2] = True
    return dict(
        slot=np.arange(w * (K + 2), w * (K + 2) + b, dtype=np.int32),
        did=rng.randint(0, 1000, b).astype(np.int32),
        session_slot=lane_sessions,
        sigma_raw=sigma,
        trustworthy=trust,
        duplicate=dup,
        wave_sessions=sessions,
        delta_bodies=rng.randint(0, 2**32, (T, K, 16), dtype=np.uint64).astype(np.uint32),
        now=10.0 + w,
    )


def _metrics_arrays(table) -> dict[str, np.ndarray]:
    return {f"metrics.{c}": np.array(getattr(table, c), copy=True) for c in _METRICS_COLS}


def _jax_tables_arrays(res) -> dict[str, np.ndarray]:
    out = {}
    for tname in ("agents", "sessions", "vouches"):
        tbl = getattr(res, tname)
        for f in tbl.__dataclass_fields__:
            out[f"{tname}.{f}"] = np.array(getattr(tbl, f), copy=True)
    out.update(_metrics_arrays(res.metrics))
    return out


def _assert_arrays_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].tobytes() == want[key].tobytes(), f"{key} diverged"


def _assert_outputs_equal(port, ref) -> None:
    for field in ("status", "ring", "sigma_eff", "saga_step_state", "fsm_error"):
        got = getattr(port, field).numpy()
        want = np.asarray(getattr(ref, field))
        assert got.dtype == want.dtype, field
        assert got.tobytes() == want.tobytes(), f"{field} diverged"
    for field in ("chain", "merkle_root"):
        np.testing.assert_array_equal(
            u32.to_numpy_u32(getattr(port, field)), np.asarray(getattr(ref, field)),
            err_msg=f"{field} diverged",
        )
    assert int(port.released) == int(np.asarray(ref.released))


@pytest.mark.parametrize("unique,ranged", [(True, True), (False, True), (False, False)])
def test_consecutive_waves_match_reference(unique, ranged):
    seed = 11 + 2 * unique + ranged
    ref_state = _seeded_state(seed)
    arrays = state_arrays(ref_state)
    arrays.update(_metrics_arrays(ref_state.metrics.table))
    port = port_tables.from_state_arrays(arrays, "cpu")
    # The DeltaLog, SagaTable, ElevationTable and EventLog ride across too; a wave without them
    # leaves them untouched.
    untouched_log = {k: v for k, v in arrays.items() if k.startswith(("delta_log.", "sagas.", "elevations.", "event_log."))}
    agents, sessions, vouches = ref_state.agents, ref_state.sessions, ref_state.vouches
    metrics = ref_state.metrics.table
    for w in range(N_WAVES):
        lanes = _lanes(seed, w, unique)
        lo, hi = w * K, (w + 1) * K
        ref = _JAX_WAVE(
            agents, sessions, vouches,
            jnp.asarray(lanes["slot"]), jnp.asarray(lanes["did"]),
            jnp.asarray(lanes["session_slot"]), jnp.asarray(lanes["sigma_raw"]),
            jnp.asarray(lanes["trustworthy"]), jnp.asarray(lanes["duplicate"]),
            jnp.asarray(lanes["wave_sessions"]), jnp.asarray(lanes["delta_bodies"]),
            lanes["now"], 0.5,
            use_pallas=False, wave_kernels=False, unique_sessions=unique,
            wave_range=(jnp.int32(lo), jnp.int32(hi)) if ranged else None,
            metrics=metrics,
        )
        agents, sessions, vouches, metrics = ref.agents, ref.sessions, ref.vouches, ref.metrics

        def t(a):
            return torch.from_numpy(np.asarray(a))

        got = port_pipeline.governance_wave(
            port.agents, port.sessions, port.vouches,
            t(lanes["slot"]), t(lanes["did"]), t(lanes["session_slot"]),
            t(lanes["sigma_raw"]), t(lanes["trustworthy"]), t(lanes["duplicate"]),
            t(lanes["wave_sessions"]), u32.from_numpy_u32(lanes["delta_bodies"], "cpu"),
            lanes["now"], 0.5,
            wave_range=(lo, hi) if ranged else None,
            unique_sessions=unique, metrics=port.metrics,
        )
        _assert_outputs_equal(got, ref)
        _assert_arrays_equal(port_tables.to_state_arrays(port),
                             {**_jax_tables_arrays(ref), **untouched_log})
    status = np.asarray(ref.status)
    assert (status == 0).any() and (status != 0).any()
    if not unique:
        assert 3 in status  # the capacity refusal rode the wave


def test_wave_on_a_scattered_layout_with_parked_rows_matches_reference():
    """One wave whose sessions leave gaps and come in no order, two parked
    rows (unallocated, memberless) at its end and no `wave_range`: the
    reference's unarmed XLA wave and the port's agree, and the sessions
    and the standing agent outside the wave keep their rows."""
    seed = 17
    ref_state = _seeded_state(seed)
    arrays = state_arrays(ref_state)
    arrays.update(_metrics_arrays(ref_state.metrics.table))
    port = port_tables.from_state_arrays(arrays, "cpu")
    rng = np.random.RandomState(seed)
    wave_sessions = np.concatenate([rng.choice(N_WAVES * K, K, replace=False),
                                    [SMALL["max_sessions"] - 2, SMALL["max_sessions"] - 1]])
    wave_sessions = wave_sessions.astype(np.int32)
    lanes = _lanes(seed, 0, False)
    lanes["session_slot"] = wave_sessions[np.arange(K + 2) % K]
    lanes["wave_sessions"] = wave_sessions
    lanes["delta_bodies"] = rng.randint(0, 2**32, (T, K + 2, 16), dtype=np.uint64).astype(np.uint32)
    ref = _JAX_WAVE(
        ref_state.agents, ref_state.sessions, ref_state.vouches,
        *(jnp.asarray(lanes[k]) for k in ("slot", "did", "session_slot", "sigma_raw",
                                           "trustworthy", "duplicate", "wave_sessions",
                                           "delta_bodies")),
        lanes["now"], 0.5, use_pallas=False, wave_kernels=False, unique_sessions=False,
        wave_range=None, metrics=ref_state.metrics.table,
    )
    got = port_pipeline.governance_wave(
        port.agents, port.sessions, port.vouches,
        *(torch.from_numpy(np.asarray(lanes[k])) for k in (
            "slot", "did", "session_slot", "sigma_raw", "trustworthy", "duplicate",
            "wave_sessions")),
        u32.from_numpy_u32(lanes["delta_bodies"], "cpu"), lanes["now"], 0.5,
        wave_range=None, unique_sessions=False, metrics=port.metrics,
    )
    _assert_outputs_equal(got, ref)
    untouched = {k: v for k, v in arrays.items() if k.startswith(("delta_log.", "sagas.", "elevations.", "event_log."))}
    _assert_arrays_equal(port_tables.to_state_arrays(port), {**_jax_tables_arrays(ref), **untouched})
    assert not np.array_equal(np.sort(wave_sessions[:K]), wave_sessions[:K])
    assert int(got.released) > 0 and bool(port.agents.i32[VOUCHER_BASE - 1, 2] & 1)


# ── bench.py's staging at a small size, through both states ──────────


N_BENCH, N_VOUCHED = 16, 4


def _bench_stage(state, replace_vouches):
    slots = state.create_sessions_batch(
        [f"bench:s{i}" for i in range(N_BENCH)], SessionConfig(min_sigma_eff=0.0)
    )
    replace_vouches(
        voucher=np.arange(N_BENCH, N_BENCH + N_VOUCHED, dtype=np.int32),
        vouchee=np.arange(N_VOUCHED, dtype=np.int32),
        session=slots[:N_VOUCHED],
    )
    sigma = np.full(N_BENCH, 0.8, np.float32)
    sigma[:N_VOUCHED] = 0.50
    bodies = np.random.RandomState(42).randint(
        0, 2**32, (T, N_BENCH, 16), dtype=np.uint64
    ).astype(np.uint32)
    return slots, sigma, bodies


def test_bench_wave_through_both_states():
    ref_state = HypervisorState(_jax_config())

    def ref_vouch(voucher, vouchee, session):
        v, n = ref_state.vouches, N_VOUCHED
        ref_state.vouches = jax_replace(
            v,
            voucher=v.voucher.at[:n].set(voucher), vouchee=v.vouchee.at[:n].set(vouchee),
            session=v.session.at[:n].set(session), bond=v.bond.at[:n].set(0.30),
            active=v.active.at[:n].set(True),
        )

    slots, sigma, bodies = _bench_stage(ref_state, ref_vouch)
    dids = [f"did:bench:{i}" for i in range(N_BENCH)]
    handles = np.array([ref_state.agent_ids.intern(d) for d in dids], np.int32)
    ref = _JAX_WAVE(
        ref_state.agents, ref_state.sessions, ref_state.vouches,
        jnp.arange(N_BENCH, dtype=jnp.int32), jnp.asarray(handles), jnp.asarray(slots),
        jnp.asarray(sigma), jnp.ones(N_BENCH, bool), jnp.zeros(N_BENCH, bool),
        jnp.asarray(slots), jnp.asarray(bodies), 0.0, 0.5,
        use_pallas=False, wave_kernels=False, unique_sessions=True,
        wave_range=(jnp.int32(slots[0]), jnp.int32(slots[0] + N_BENCH)),
        metrics=ref_state.metrics.table,
    )

    cfg = port_config.HypervisorConfig(capacity=port_config.TableCapacity(**SMALL))
    state = PortState(cfg, device="cpu")

    def port_vouch(voucher, vouchee, session):
        v, n = state.vouches, N_VOUCHED
        v.voucher[:n] = torch.from_numpy(voucher)
        v.vouchee[:n] = torch.from_numpy(vouchee)
        v.session[:n] = torch.from_numpy(session)
        v.bond[:n] = 0.30
        v.active[:n] = True

    port_slots, _, _ = _bench_stage(state, port_vouch)
    np.testing.assert_array_equal(port_slots, slots)
    got = state.governance_wave(np.arange(N_BENCH, dtype=np.int32), dids, slots, sigma, bodies)

    _assert_outputs_equal(got, ref)
    _assert_arrays_equal(
        port_tables.to_state_arrays(port_tables.StateTables(
            state.agents, state.sessions, state.vouches, state.metrics.table,
        )),
        _jax_tables_arrays(ref),
    )
    # bench.py's own gates.
    assert (got.status.numpy() == 0).all() and not got.fsm_error.any()
    assert (got.ring.numpy() == 2).all()
    np.testing.assert_allclose(got.sigma_eff.numpy()[:N_VOUCHED], 0.65, atol=1e-6)
    assert int(got.released) == N_VOUCHED
    for lane in (0, N_BENCH - 1):
        parent, hexes = b"\x00" * 32, []
        for body in bodies[:, lane]:
            parent = hashlib.sha256(body.astype(">u4").tobytes() + parent).digest()
            hexes.append(parent.hex())
        assert digests_to_hex(got.chain[:, lane]) == hexes
        assert digests_to_hex(got.merkle_root[lane:lane + 1])[0] == merkle_root_host(hexes)


def test_stage_wave_refuses_two_joiners_on_one_agent_slot():
    cfg = port_config.HypervisorConfig(capacity=port_config.TableCapacity(**SMALL))
    state = PortState(cfg, device="cpu")
    slots = state.create_sessions_batch(["a", "b", "c"], port_models.SessionConfig())
    bodies = np.zeros((T, 3, 16), np.uint32)
    sigma = np.full(3, 0.8, np.float32)
    with pytest.raises(ValueError, match="same agent slot"):
        state.stage_wave(np.array([4, 5, 4]), ["x", "y", "z"], slots, sigma, bodies)
    # A duplicate lane is refused admission and writes no row, so it may share a slot.
    lanes = state.stage_wave(np.array([4, 5, 4]), ["x", "y", "z"], slots, sigma, bodies,
                             duplicate=np.array([False, False, True]))
    assert lanes["slot"].tolist() == [4, 5, 4]


def test_port_state_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PortState(port_config.DEFAULT_CONFIG)
    assert port_models.SessionState.ARCHIVED.code == 4
