"""The port's sharded governance wave against the reference's, on the CPU.

Counterparts of `tests/parity/test_sharded_wave.py` (4),
`test_state_mesh_wave.py` (4), `test_multislice_wave.py` (8),
`test_mode_wave.py` (2), the mesh cases of `test_ragged_wave.py`,
`test_unique_sessions.py` and `test_wave_shape_fuzz.py`, and
`tests/unit/test_metrics.py::TestShardedTallyParity` and
`test_tracing.py::TestModeParity`.

The table-level cases feed the reference test's own inputs to the
reference's `sharded_governance_wave` on its 8-device CPU mesh and to the
port's on an 8-shard CPU mesh (the harness of `test_torch_parallel.py`)
and hold every output, every partial and every table column equal at
tolerance 0; where the reference compares against its single-device
wave, the port's sharded wave is also held to the port's single-device
wave (`ops.pipeline.governance_wave`). The state-level cases run one
sequence through `HypervisorState.run_governance_wave(mesh=)` on both
packages (`run_waves`: the same ids and clock) and hold the
results, every table, the host indices and the metrics (but the compile
counters, ROADMAP C.2) equal.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hypervisor_tpu.parallel as REF_PAR
import hypervisor_tpu_torch.parallel as PORT_PAR
from hypervisor_tpu.parallel import collectives as RC
from hypervisor_tpu.runtime.checkpoint import state_arrays
from hypervisor_tpu_torch import tables as port_tables
from hypervisor_tpu_torch.ops import pipeline as port_pipeline
from hypervisor_tpu_torch.parallel import collectives as PC
from tests.parity import test_mode_wave as ref_mode
from tests.parity import test_multislice_wave as ref_ms
from tests.parity import test_sharded_wave as ref_sw
from tests.parity import test_wave_shape_fuzz as ref_fuzz
import hypervisor_tpu as REF
import hypervisor_tpu_torch as PORT
from tests.test_torch_facade_api import ManualTime, install_determinism
from tests.test_torch_metrics import masked, unarmed  # noqa: F401
from tests.test_torch_parallel import (
    N_DEV,
    assert_same,
    np_of,
    port_mesh_of,
    port_table,
    put,
    ref_mesh,
)

WAVE_FIELDS = ("status", "ring", "sigma_eff", "saga_step_state", "chain", "merkle_root",
               "fsm_error", "released")


def wave_both(tables, args, extra=(), grid=None, **flags):
    """One sharded wave on both packages from the same reference tables
    and lane arguments (`extra`: the contiguous variant's (lo, hi))."""
    if grid is None:
        rm, pm = ref_mesh(), port_mesh_of()
    else:
        rm = REF_PAR.make_multislice_mesh(*grid, platform="cpu")
        pm = PORT_PAR.make_multislice_mesh(*grid, platform="cpu")
    *lanes, now, omega = args
    ref = RC.sharded_governance_wave(rm, **flags)(
        *tables, *map(jnp.asarray, lanes), now, omega,
        *(jnp.asarray(x, jnp.int32) for x in extra))
    port = PC.sharded_governance_wave(pm, **flags)(
        *map(port_table, tables), *map(put, lanes), now, omega, *extra)
    return ref, port


def port_single(tables, args, **kw):
    """The port's single-device wave (plain versions on the CPU)."""
    *lanes, now, omega = args
    agents, sessions, vouches = map(port_table, tables)
    return port_pipeline.governance_wave(agents, sessions, vouches, *map(put, lanes), now,
                                         omega, **kw)


def assert_wave_fields(got, want, fields=WAVE_FIELDS):
    for f in fields:
        a, b = np_of(getattr(got, f)), np_of(getattr(want, f))
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), f


def np_args(args):
    *lanes, now, omega = args
    return tuple(np.asarray(x) for x in lanes) + (now, omega)


# ── counterparts of tests/parity/test_sharded_wave.py ────────────────


def _sw_args():
    slots, dids, sess, sigma, trust, dup, bodies = ref_sw._wave_inputs()
    return (slots, dids, sess, sigma, trust, dup, np.arange(ref_sw.K, dtype=np.int32),
            bodies, ref_sw.NOW, ref_sw.OMEGA)


def _sw_tables():
    slots, _, sess, *_ = ref_sw._wave_inputs()
    agents, sessions, vouches = ref_sw._tables()
    return agents, sessions, ref_sw._add_vouches(vouches, slots, sess)


@pytest.fixture(scope="module")
def sharded_pair():
    ref, port = wave_both(_sw_tables(), _sw_args())
    return ref, port


class TestShardedGovernanceWave:
    def test_bit_parity_with_single_device_wave(self, sharded_pair):
        ref, port = sharded_pair
        assert_same(port, ref)
        assert_wave_fields(port, port_single(_sw_tables(), _sw_args()))

    def test_output_tables_bit_identical(self, sharded_pair):
        ref, port = sharded_pair
        single = port_single(_sw_tables(), _sw_args())
        for tname in ("agents", "sessions", "vouches"):
            assert_same(getattr(port, tname), getattr(ref, tname))
            assert_same(getattr(port, tname), getattr(single, tname))

    def test_contiguous_variant_bit_parity(self, sharded_pair):
        ref, port = wave_both(_sw_tables(), _sw_args(), extra=(0, ref_sw.K),
                              contiguous_waves=True)
        assert_same(port, ref)
        assert_same(port, sharded_pair[1])

    def test_wave_semantics(self, sharded_pair):
        _, port = sharded_pair
        status, ring, sig = np_of(port.status), np_of(port.ring), np_of(port.sigma_eff)
        assert (status == 0).all()
        assert sig[0] == pytest.approx(0.65) and ring[0] == 2
        assert sig[5] == pytest.approx(0.65) and ring[5] == 2
        assert ring[7] == 3
        assert (np_of(port.sessions.state)[:ref_sw.K] == 4).all()
        assert (np_of(port.sessions.terminated_at)[:ref_sw.K] == ref_sw.NOW).all()
        assert int(port.released) == 2 and not port.fsm_error.any()


# ── counterparts of tests/parity/test_multislice_wave.py ─────────────

MS_FLAGS = dict(mode_dispatch=True, contiguous_waves=True, unique_sessions=True, multislice=True)


def _ms_fold(grid, ref, port):
    (ref_res, ref_part), (port_res, port_part) = ref, port
    folded_ref = RC.multislice_reconcile_wave(REF_PAR.make_multislice_mesh(*grid))(
        ref_res.sessions, *ref_part)
    folded_port = PC.multislice_reconcile_wave(
        PORT_PAR.make_multislice_mesh(*grid, platform="cpu"))(port_res.sessions, *port_part)
    return folded_ref, folded_port


@pytest.mark.parametrize("grid", ref_ms.GRIDS, ids=ref_ms.GRID_IDS)
def test_multislice_wave_plus_dcn_reconcile_matches_single_device(grid):
    args = np_args(ref_ms._wave_args())
    ref, port = wave_both(ref_ms._tables(), args, extra=(0, ref_ms.K), grid=grid, **MS_FLAGS)
    assert_same(port, ref)
    folded_ref, folded_port = _ms_fold(grid, ref, port)
    assert_same(folded_port, folded_ref)
    single = port_single(ref_ms._tables(), args, wave_range=(0, ref_ms.K), unique_sessions=True)
    assert_wave_fields(port[0], single)
    for col in ("state", "n_participants", "terminated_at"):
        assert np_of(getattr(folded_port, col)).tobytes() == \
            np_of(getattr(single.sessions, col)).tobytes(), col
    assert float(port[0].sigma_eff[0]) == pytest.approx(0.65)


@pytest.mark.parametrize("grid", ref_ms.GRIDS, ids=ref_ms.GRID_IDS)
def test_permuted_assignment_crosses_slices(grid):
    args = list(np_args(ref_ms._wave_args()))
    args[2] = np.arange(ref_ms.B - 1, -1, -1, dtype=np.int32)
    args[3] = np.full(ref_ms.B, 0.8, np.float32)
    args[7] = np.random.RandomState(21).randint(
        0, 2**32, size=(ref_ms.T, ref_ms.K, 16), dtype=np.uint64).astype(np.uint32)
    ref, port = wave_both(ref_ms._tables(), tuple(args), extra=(0, ref_ms.K), grid=grid,
                          **MS_FLAGS)
    assert_same(port, ref)
    folded_ref, folded_port = _ms_fold(grid, ref, port)
    assert_same(folded_port, folded_ref)
    assert (np_of(folded_port.state)[:ref_ms.K] == 4).all()


@pytest.mark.parametrize("grid", ref_ms.GRIDS, ids=ref_ms.GRID_IDS)
def test_asymmetric_slice_load_ragged_across_slices(grid):
    """Slice 0's shards carry every real join; slice 1's lanes are all
    padding (refused as duplicates), so the wave is ragged across the
    DCN axis."""
    args = list(np_args(ref_ms._wave_args()))
    dup = np.zeros(ref_ms.B, bool)
    dup[ref_ms.B // grid[0]:] = True
    args[5] = dup
    ref, port = wave_both(ref_ms._tables(), tuple(args), extra=(0, ref_ms.K), grid=grid,
                          **MS_FLAGS)
    assert_same(port, ref)
    folded_ref, folded_port = _ms_fold(grid, ref, port)
    assert_same(folded_port, folded_ref)
    assert (np_of(port[0].status)[ref_ms.B // grid[0]:] == 2).all()


def test_pre_reconcile_replica_is_unchanged():
    args = np_args(ref_ms._wave_args())
    tables = ref_ms._tables()
    before = np_of(port_table(tables[1]).i32).copy()
    ref, port = wave_both(tables, args, extra=(0, ref_ms.K), grid=(2, 4), **MS_FLAGS)
    assert_same(port, ref)
    np.testing.assert_array_equal(np_of(port[0].sessions.i32), before)


@pytest.mark.parametrize("grid", ref_ms.GRIDS, ids=ref_ms.GRID_IDS)
def test_fused_multislice_gateway_matches_single_device(grid):
    """The gateway fused into the multislice wave: standing members' rows
    on several slices, one action each plus two on one row."""
    args = np_args(ref_ms._wave_args())
    agents, sessions, vouches = ref_ms._tables()
    from hypervisor_tpu.tables.struct import replace as t_replace

    standing = np.array([1, 9, 17, 25, 33, 41, 49, 57], np.int32)  # one row per shard
    agents = t_replace(
        agents,
        did=agents.did.at[standing].set(jnp.arange(100, 108)),
        session=agents.session.at[standing].set(ref_ms.S_CAP - 1),
        flags=agents.flags.at[standing].set(1),
        sigma_eff=agents.sigma_eff.at[standing].set(0.8),
        ring=agents.ring.at[standing].set(jnp.int8(2)),
        rl_tokens=agents.rl_tokens.at[standing].set(1.0),
    )
    from hypervisor_tpu.tables.state import ElevationTable

    elev = ElevationTable.create(8)
    act = (standing, np.full(8, 2, np.int8), np.zeros(8, bool), np.zeros(8, bool),
           np.zeros(8, bool), np.zeros(8, bool), np.ones(8, bool))
    rm = REF_PAR.make_multislice_mesh(*grid, platform="cpu")
    pm = PORT_PAR.make_multislice_mesh(*grid, platform="cpu")
    *lanes, now, omega = args
    ref = RC.sharded_governance_wave(rm, with_gateway=True, **MS_FLAGS)(
        agents, sessions, vouches, *map(jnp.asarray, lanes), now, omega, jnp.int32(0),
        jnp.int32(ref_ms.K), elev, *map(jnp.asarray, act))
    port = PC.sharded_governance_wave(pm, with_gateway=True, **MS_FLAGS)(
        port_table(agents), port_table(sessions), port_table(vouches), *map(put, lanes), now,
        omega, 0, ref_ms.K, port_table(elev), *map(put, act))
    assert_same(port, ref)
    assert (np_of(port[1].verdict) == 0).all()


# ── counterparts of tests/parity/test_mode_wave.py ───────────────────


def test_mixed_plus_reconcile_equals_all_strong():
    args = ref_mode._wave_args(np.random.RandomState(11))
    args = np_args(args)
    mixed = np.array([i % 2 for i in range(2 * ref_mode.K)], np.int8)
    strong = np.zeros(2 * ref_mode.K, np.int8)
    ref_s, port_s = wave_both(ref_mode._tables(strong), args, mode_dispatch=True)
    ref_m, port_m = wave_both(ref_mode._tables(mixed), args, mode_dispatch=True)
    assert_same(port_s, ref_s)
    assert_same(port_m, ref_m)
    ev = mixed[:ref_mode.K] == 1
    assert (np_of(port_m[0].sessions.state)[:ref_mode.K][ev] == 1).all()
    assert (np_of(port_m[1].counts).sum(axis=0)[:ref_mode.K][ev] > 0).all()
    folded_ref = RC.reconcile_wave_sessions(ref_mesh())(ref_m[0].sessions, *ref_m[1])
    folded_port = PC.reconcile_wave_sessions(port_mesh_of())(port_m[0].sessions, *port_m[1])
    assert_same(folded_port, folded_ref)
    for col in ("sid", "state", "n_participants", "terminated_at", "created_at",
                "max_participants", "min_sigma_eff"):
        assert np_of(getattr(folded_port, col)).tobytes() == \
            np_of(getattr(port_s[0].sessions, col)).tobytes(), col


# ── the state bridge on both packages ────────────────────────────────


def _cfg(pkg, **cap):
    base = pkg.config.DEFAULT_CONFIG
    return dataclasses.replace(base, capacity=dataclasses.replace(base.capacity, **cap))


def _state(pkg, **cap):
    from importlib import import_module

    cls = import_module(f"{pkg.__name__}.state").HypervisorState
    kw = {} if pkg.__name__ == "hypervisor_tpu" else {"device": "cpu"}
    return cls(_cfg(pkg, **cap), **kw)


def _mesh(pkg, n=N_DEV):
    par = import_par(pkg)
    return par.make_mesh(n, platform="cpu")


def import_par(pkg):
    from importlib import import_module

    return import_module(f"{pkg.__name__}.parallel")


def state_record(st) -> dict:
    """Every device table, the host indices the wave books and the
    metrics (compile counters set apart)."""
    if isinstance(st.agents.f32, torch.Tensor):
        arrays = port_tables.to_state_arrays(port_tables.StateTables(
            agents=st.agents, sessions=st.sessions, vouches=st.vouches,
            sagas=st.sagas, elevations=st.elevations, delta_log=st.delta_log,
            event_log=st.event_log))
        arrays = {k: (v.view(np.uint32) if k in ("delta_log.body", "delta_log.digest") else v)
                  for k, v in arrays.items()}
    else:
        arrays = {k: v for k, v in state_arrays(st).items()}
    snap = masked(st.metrics_snapshot())
    return {
        "arrays": arrays,
        "members": sorted(st._members),
        "audit_rows": {int(k): list(v) for k, v in st._audit_rows.items()},
        "turns": dict(st._turns),
        "seeds": {int(k): np.asarray(v).view(np.uint32).tolist()
                  for k, v in st._chain_seed.items()},
        "next_agent": st._next_agent_slot,
        "free_agents": list(st._free_agent_slots),
        "pending": len(st._pending_partials),
        "metrics": {k: v.tolist() for k, v in snap.items()},
    }


def assert_records_equal(got: dict, want: dict) -> None:
    assert sorted(got["arrays"]) == sorted(want["arrays"])
    for k, w in want["arrays"].items():
        g = got["arrays"][k]
        assert g.shape == w.shape and g.tobytes() == w.tobytes(), f"{k} diverged"
    for k in want:
        if k != "arrays":
            assert got[k] == want[k], k


def wave_outputs(res) -> dict:
    out = {}
    for f in ("status", "ring", "sigma_eff", "saga_step_state", "chain", "merkle_root",
              "fsm_error", "released"):
        a = np_of(getattr(res, f))
        out[f] = a.view(np.uint32) if f in ("chain", "merkle_root") else a
    return out


def run_waves(sequence):
    """`sequence(pkg, mesh)` on both packages; holds what each returns
    (a dict of recorded values) equal, tables and metrics included."""

    outs = []
    for pkg in (REF, PORT):
        with pytest.MonkeyPatch.context() as mp:
            install_determinism(mp, ManualTime())
            outs.append(sequence(pkg, _mesh(pkg)))
    ref, port = outs
    assert sorted(ref) == sorted(port)
    for key in ref:
        if key.startswith("state"):
            assert_records_equal(port[key], ref[key])
        elif isinstance(ref[key], dict):
            for f, want in ref[key].items():
                got = port[key][f]
                assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), (key, f)
        else:
            assert port[key] == ref[key], key
    return port


def _mw_staged(pkg, st, prefix="mw", b=32, k=8, t=3, seed=5, low0=False):
    slots = st.create_sessions_batch([f"{prefix}:s{i}" for i in range(k)],
                                     pkg.SessionConfig(min_sigma_eff=0.0))
    dids = [f"did:{prefix}:{i}" for i in range(b)]
    asess = np.asarray(slots, np.int32)[np.arange(b) % k]
    sigma = np.linspace(0.62, 0.95, b).astype(np.float32)
    if low0:
        sigma[0] = 0.45  # lifted by a phantom voucher's bond
    bodies = np.random.RandomState(seed).randint(0, 2**32, size=(t, k, 16),
                                                 dtype=np.uint64).astype(np.uint32)
    return slots, dids, asess, sigma, bodies


def _set_vouch(pkg, st, vouchee, bond=0.40):
    """A phantom voucher's edge toward `vouchee` in session 0 (row 0)."""
    cap = st.agents.i32.shape[0]
    if pkg.__name__ == "hypervisor_tpu":
        from hypervisor_tpu.tables.struct import replace as t_replace

        v = st.vouches
        st.vouches = t_replace(v, voucher=v.voucher.at[0].set(cap - 1),
                               vouchee=v.vouchee.at[0].set(int(vouchee)),
                               session=v.session.at[0].set(0), bond=v.bond.at[0].set(bond),
                               active=v.active.at[0].set(True))
    else:
        v = st.vouches
        v.voucher[0], v.vouchee[0], v.session[0] = cap - 1, int(vouchee), 0
        v.bond[0], v.active[0] = bond, True


class TestStateMeshWave:
    def test_mesh_wave_matches_single_device_semantics(self):
        def seq(pkg, mesh):
            st = _state(pkg, max_agents=N_DEV * 16)
            args = _mw_staged(pkg, st, low0=True)
            _set_vouch(pkg, st, st._mesh_wave_slots(32, N_DEV)[0])
            res = st.run_governance_wave(*args, now=2.0, mesh=mesh)
            return {"wave": wave_outputs(res), "state": state_record(st)}

        port = run_waves(seq)
        assert port["wave"]["sigma_eff"][0] == pytest.approx(0.45 + 0.5 * 0.40)
        assert (np.asarray(port["state"]["arrays"]["sessions.i32"])[:8, 3] == 4).all()
        assert port["state"]["audit_rows"] == {s: port["state"]["audit_rows"][s]
                                              for s in range(8)}
        assert all(len(v) == 3 for v in port["state"]["audit_rows"].values())

    def test_mesh_wave_equals_the_single_device_state_wave(self):
        """The port's mesh wave against the port's single-device wave on
        the fields the reference holds equal (agent rows differ by
        design: the mesh takes the top rows of each shard)."""
        outs = []
        for mesh in (port_mesh_of(), None):
            st = _state(PORT, max_agents=N_DEV * 16)
            args = _mw_staged(PORT, st, low0=True)
            row = st._mesh_wave_slots(32, N_DEV)[0] if mesh is not None else st._next_agent_slot
            _set_vouch(PORT, st, row)
            res = st.run_governance_wave(*args, now=2.0, mesh=mesh)
            outs.append((wave_outputs(res), np_of(st.sessions.n_participants),
                         np_of(st.delta_log.digest), [st.is_member(i % 8, f"did:mw:{i}")
                                                      for i in range(32)]))
        (wm, nm, dm, mm), (ws, ns, ds, ms) = outs
        for f in ("status", "ring", "sigma_eff", "chain", "merkle_root", "released"):
            assert wm[f].tobytes() == ws[f].tobytes(), f
        assert nm.tobytes() == ns.tobytes() and dm.tobytes() == ds.tobytes()
        assert all(mm) and all(ms)
        assert wm["sigma_eff"][0] == pytest.approx(0.45 + 0.5 * 0.40)

    def test_non_contiguous_wave_takes_mask_fallback(self):
        def seq(pkg, mesh):
            st = _state(pkg, max_agents=N_DEV * 16)
            all_slots = st.create_sessions_batch([f"nc:s{i}" for i in range(16)],
                                                 pkg.SessionConfig(min_sigma_eff=0.0))
            ws = all_slots[::2]
            bodies = np.random.RandomState(9).randint(0, 2**32, size=(3, 8, 16),
                                                      dtype=np.uint64).astype(np.uint32)
            res = st.run_governance_wave(ws, [f"did:nc:{i}" for i in range(32)],
                                         np.asarray(ws, np.int32)[np.arange(32) % 8],
                                         np.full(32, 0.8, np.float32), bodies, now=3.0,
                                         mesh=mesh)
            return {"wave": wave_outputs(res), "state": state_record(st)}

        port = run_waves(seq)
        state = np.asarray(port["state"]["arrays"]["sessions.i32"])[:16, 3]
        assert (state[0::2] == 4).all() and (state[1::2] == 1).all()

    def test_mesh_wave_rows_recycle_without_free_list(self):
        def seq(pkg, mesh):
            st = _state(pkg, max_agents=N_DEV * 16)
            out = {}
            for r in range(2):
                args = _mw_staged(pkg, st, prefix=f"mw2:r{r}", seed=r)
                res = st.run_governance_wave(*args, now=1.0 + r, mesh=mesh)
                out[f"wave{r}"] = wave_outputs(res)
            out["state"] = state_record(st)
            return out

        port = run_waves(seq)
        assert (port["wave1"]["status"] == 0).all()
        assert port["state"]["free_agents"] == []

    def test_bump_overlap_refuses_loudly(self):
        for pkg in (REF, PORT):
            st = _state(pkg)
            st._next_agent_slot = st.agents.i32.shape[0] // N_DEV
            with pytest.raises(RuntimeError, match="mesh-wave region"):
                st._mesh_wave_slots(32, N_DEV)


def test_bridge_defers_and_folds_on_demand():
    def seq(pkg, mesh):
        out = {}
        for defer in (True, False):
            st = _state(pkg, max_agents=N_DEV * 16)
            slots = st.create_sessions_batch(
                [f"md:s{i}" for i in range(8)],
                pkg.SessionConfig(min_sigma_eff=0.0,
                                  consistency_mode=pkg.ConsistencyMode.EVENTUAL))
            for s in slots[::2]:
                st.force_session_mode(int(s), pkg.ConsistencyMode.STRONG,
                                      has_nonreversible=False)
            rng = np.random.RandomState(3)
            bodies = rng.randint(0, 2**32, size=(2, 8, 16), dtype=np.uint64).astype(np.uint32)
            st.run_governance_wave(slots, [f"did:md:{i}" for i in range(16)],
                                   np.arange(16, dtype=np.int32) % 8,
                                   np.linspace(0.62, 0.95, 16).astype(np.float32), bodies,
                                   now=2.0, mesh=mesh, defer_reconcile=defer)
            out[f"state_before_{defer}"] = state_record(st)
            out[f"folded_{defer}"] = st.reconcile_session_partials(mesh)
            out[f"state_after_{defer}"] = state_record(st)
        return out

    port = run_waves(seq)
    assert port["folded_True"] == 1 and port["folded_False"] == 0
    before = np.asarray(port["state_before_True"]["arrays"]["sessions.i32"])
    after = np.asarray(port["state_after_True"]["arrays"]["sessions.i32"])
    assert (before[1:8:2, 3] == 1).all() and (after[1:8:2, 3] == 4).all()
    assert after.tobytes() == np.asarray(
        port["state_after_False"]["arrays"]["sessions.i32"]).tobytes()


def test_bridge_runs_multislice_wave():
    """`run_governance_wave(mesh=<(2, 4) grid>)` builds the multislice
    wave and folds its DCN partials behind it; a second wave carries a
    standing member's action through the fused gateway."""

    def seq(pkg, _mesh_1d):
        mesh = import_par(pkg).make_multislice_mesh(2, 4, platform="cpu")
        st = _state(pkg, max_agents=ref_ms.N_CAP)
        slots = st.create_sessions_batch([f"ms:s{i}" for i in range(8)],
                                         pkg.SessionConfig(min_sigma_eff=0.0))
        bodies = np.random.RandomState(3).randint(0, 2**32, size=(3, 8, 16),
                                                  dtype=np.uint64).astype(np.uint32)
        res = st.run_governance_wave(slots, [f"did:ms:{i}" for i in range(8)],
                                     np.asarray(slots, np.int32), np.full(8, 0.8, np.float32),
                                     bodies, now=2.0, mesh=mesh)
        standing = st.create_session("ms:standing", pkg.SessionConfig(min_sigma_eff=0.0))
        st.enqueue_join(standing, "did:ms:standing", sigma_raw=0.8)
        st.flush_joins(now=2.5)
        probe = st._slot_of_member[(st.agent_ids.lookup("did:ms:standing"), standing)]
        slots2 = st.create_sessions_batch(["ms:extra"], pkg.SessionConfig(min_sigma_eff=0.0))
        extra, gw = st.run_governance_wave(
            slots2, ["did:ms:probe"], np.asarray(slots2, np.int32), np.full(1, 0.9, np.float32),
            np.zeros((1, 1, 16), np.uint32), now=3.0, mesh=mesh,
            actions=dict(slots=np.array([probe], np.int32)))
        return {"wave": wave_outputs(res), "extra": wave_outputs(extra),
                "verdict": np_of(gw.verdict).tolist(), "state": state_record(st)}

    port = run_waves(seq)
    assert port["verdict"] == [0]


def test_bridge_refuses_cross_slice_double_join():
    for pkg in (REF, PORT):
        mesh = import_par(pkg).make_multislice_mesh(2, 4, platform="cpu")
        st = _state(pkg, max_agents=ref_ms.N_CAP)
        slots = st.create_sessions_batch([f"x:s{i}" for i in range(8)],
                                         pkg.SessionConfig(min_sigma_eff=0.0))
        with pytest.raises(ValueError, match="multislice wave requires a contiguous"):
            st.run_governance_wave(slots, [f"did:x:{i}" for i in range(8)],
                                   np.zeros(8, np.int32), np.full(8, 0.8, np.float32),
                                   np.zeros((1, 8, 16), np.uint32), now=1.0, mesh=mesh)


# ── counterparts of the mesh cases of other reference files ──────────


def test_ragged_13_joins_5_sessions_and_a_single_join():
    """`test_ragged_wave.py`: B = 13 and K = 5 on 8 shards (and B = K = 1)
    round up inside; the caller sees its own shape."""

    def seq(pkg, mesh):
        st = _state(pkg, max_agents=N_DEV * 16)
        args = _mw_staged(pkg, st, prefix="rg", b=13, k=5, seed=9)
        args = args[:3] + (np.linspace(0.58, 0.95, 13).astype(np.float32),) + args[4:]
        res = st.run_governance_wave(*args, now=2.0, mesh=mesh)
        one = _mw_staged(pkg, st, prefix="rg1", b=1, k=1, seed=4)
        res1 = st.run_governance_wave(*one, now=3.0, mesh=mesh)
        return {"wave": wave_outputs(res), "one": wave_outputs(res1), "state": state_record(st)}

    port = run_waves(seq)
    assert port["wave"]["status"].shape == (13,) and port["wave"]["merkle_root"].shape[0] == 5
    assert port["one"]["status"].shape == (1,)


def test_bridge_detects_unique_and_matches_ranked_outcome():
    """`test_unique_sessions.py`: a one-join-per-session wave takes the
    gather-free path, two joins a session the ranked one."""

    def seq(pkg, mesh):
        out = {}
        for double in (False, True):
            st = _state(pkg)
            slots = st.create_sessions_batch([f"us:s{i}" for i in range(8)],
                                             pkg.SessionConfig(min_sigma_eff=0.0))
            b = 16 if double else 8
            asess = np.asarray(slots, np.int32)[np.arange(b) % 8]
            bodies = np.random.RandomState(3).randint(0, 2**32, size=(2, 8, 16),
                                                      dtype=np.uint64).astype(np.uint32)
            res = st.run_governance_wave(slots, [f"did:us:{i}" for i in range(b)], asess,
                                         np.full(b, 0.8, np.float32), bodies, now=1.0,
                                         mesh=mesh)
            out[f"wave_{double}"] = wave_outputs(res)
            out[f"state_{double}"] = state_record(st)
            out[f"cached_{double}"] = sorted(str(k[2:]) for k in st._sharded_waves
                                            if k[0] != "reconcile")
        return out

    port = run_waves(seq)
    assert port["cached_False"] == ["(True, True)"] and port["cached_True"] == ["(True, False)"]


def test_random_shapes_sharded_and_multislice_match():
    """`test_wave_shape_fuzz.py` (an opt-in soak there), two draws here:
    the 1-D contiguous unique wave and the multislice wave with its DCN
    fold, on both packages."""
    rng = np.random.default_rng(7)
    for it in range(2):
        b, k, s_cap, slots, sigma, trust, dup, bodies = ref_fuzz._draw(rng)
        args = (slots, np.arange(b, dtype=np.int32), np.arange(b, dtype=np.int32), sigma,
                trust, dup, np.arange(k, dtype=np.int32), bodies, float(it + 1), 0.5)

        def world():
            return ref_fuzz._world(np.random.default_rng(1000 + it), b, k, s_cap)

        ref1, port1 = wave_both(world(), args, extra=(0, k), contiguous_waves=True,
                                unique_sessions=True)
        assert_same(port1, ref1)
        ref2, port2 = wave_both(world(), args, extra=(0, k), grid=(2, 4), **MS_FLAGS)
        assert_same(port2, ref2)
        folded_ref, folded_port = _ms_fold((2, 4), ref2, port2)
        assert_same(folded_port, folded_ref)
        assert_wave_fields(port2[0], port1)


def test_mesh_wave_counts_match_single_device():
    """`tests/unit/test_metrics.py::TestShardedTallyParity`: the mesh
    wave's host-plane tallies equal the single-device wave's in-wave
    counts, a memberless session included, on both packages."""

    def seq(pkg, _mesh8):
        out = {}
        for name, mesh in (("single", None), ("mesh", import_par(pkg).make_mesh(
                4, platform="cpu"))):
            st = _state(pkg)
            slots = st.create_sessions_batch([f"sp:{name}{i}" for i in range(8)],
                                             pkg.SessionConfig(min_sigma_eff=0.7))
            sigma = np.full(8, 0.8, np.float32)
            sigma[-1] = 0.65
            st.run_governance_wave(slots, [f"did:sp:{name}{i}" for i in range(8)],
                                   slots.copy(), sigma, np.zeros((1, 8, 16), np.uint32),
                                   mesh=mesh)
            snap = masked(st.metrics_snapshot())
            out[name] = {k: v.tolist() for k, v in snap.items() if k != "stage_counts"}
        return out

    port = run_waves(seq)
    from hypervisor_tpu_torch.observability import metrics as mp

    for handle in (mp.WAVE_TICKS, mp.ADMITTED, mp.REFUSED, mp.SESSIONS_ARCHIVED,
                   mp.BONDS_RELEASED, mp.SAGA_STEPS_COMMITTED, mp.SAGA_STEPS_FAILED):
        assert port["mesh"]["counters"][handle.index] == port["single"]["counters"][handle.index]
    assert port["mesh"]["hist"][mp.WAVE_LANES.index] == port["single"]["hist"][mp.WAVE_LANES.index]
    assert port["single"]["counters"][mp.ADMITTED.index] == 7


def test_mesh_wave_reconstructs_same_child_structure():
    """`tests/unit/test_tracing.py::TestModeParity`: the sharded wave's
    host-mirrored stamps reconstruct the single-device wave's child
    structure, on both packages alike."""

    def seq(pkg, _mesh8):
        out = {}
        for name, mesh in (("s", None), ("m", import_par(pkg).make_mesh(4, platform="cpu"))):
            st = _state(pkg)
            slots = st.create_sessions_batch([f"mp:{name}{i}" for i in range(8)],
                                             pkg.SessionConfig(min_sigma_eff=0.0))
            st.run_governance_wave(slots, [f"did:mp:{name}{i}" for i in range(8)],
                                   slots.copy(), np.full(8, 0.8, np.float32),
                                   np.zeros((1, 8, 16), np.uint32), mesh=mesh)
            spans = st.tracer.drain()
            root = [s for s in spans if s.stage in ("governance_wave",
                                                    "governance_wave_sharded")][0]
            out[name] = [root.stage] + [c.stage for c in root.children] + [
                c.parent_span_word == root.span_word for c in root.children]
        return out

    port = run_waves(seq)
    assert port["s"][1:] == port["m"][1:] and port["m"][0] == "governance_wave_sharded"
