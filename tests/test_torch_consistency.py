"""The port's consistency runtime and mixed-mode tick against the
reference's, on the CPU.

Counterparts of `tests/integration/test_consistency_modes.py` (5) and
`tests/parity/test_mode_tick_property.py` (1): one facade per package
(`Hypervisor()` on the reference, `Hypervisor(device="cpu")` on the port,
the same ids and clock) creates STRONG and EVENTUAL sessions, and
`Hypervisor.consistency_runtime(mesh)` ticks lanes on the reference's
8-device CPU mesh and on the port's 8-shard mesh. Every tick result, the
pending partials, every reconcile total and the SessionTable are held
equal at tolerance 0 (the EVENTUAL sigma mass is an f32 sum per session,
in lane order within a shard and rank order across shards), and the
mixed-mode run must end on the all-STRONG table. `parallel.collectives.
mode_tick` is also held to the reference's directly.
"""

from __future__ import annotations

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest

import hypervisor_tpu as REF
import hypervisor_tpu_torch as PORT
from hypervisor_tpu.parallel import collectives as RC
from hypervisor_tpu_torch.parallel import collectives as PC
from tests.test_torch_facade_api import ManualTime, install_determinism
from tests.test_torch_mesh_wave import import_par
from tests.test_torch_metrics import unarmed  # noqa: F401
from tests.test_torch_parallel import (
    N_DEV,
    assert_same,
    np_of,
    port_mesh_of,
    port_table,
    put,
    ref_mesh,
)

LANES = 16
T = 2


def _bodies(seed=0, lanes=LANES):
    return np.random.RandomState(seed).randint(0, 2**32, size=(T, lanes, 16),
                                               dtype=np.uint64).astype(np.uint32)


def _facade(pkg):
    return pkg.Hypervisor() if pkg is REF else pkg.Hypervisor(device="cpu")


async def _facade_with_modes(pkg):
    hv = _facade(pkg)
    made = []
    for mode in (pkg.ConsistencyMode.STRONG, pkg.ConsistencyMode.EVENTUAL):
        made.append(await hv.create_session(
            pkg.SessionConfig(consistency_mode=mode, min_sigma_eff=0.0, max_participants=64),
            creator_did="did:lead"))
    return hv, made[0], made[1]


def tick_record(result) -> dict:
    out = {}
    for f in ("ring", "sigma_eff", "session_state", "saga_step_state", "merkle_root", "status",
              "consensus"):
        a = np_of(getattr(result, f))
        out[f] = a.view(np.uint32) if f == "merkle_root" else a
    return out


def both_facades(sequence):
    """`sequence(pkg)` on both packages under the same ids and clock; the
    returned dicts of arrays and values must be equal."""
    outs = []
    for pkg in (REF, PORT):
        with pytest.MonkeyPatch.context() as mp:
            install_determinism(mp, ManualTime())
            outs.append(asyncio.run(sequence(pkg)))
    ref, port = outs
    assert sorted(ref) == sorted(port)
    for key, want in ref.items():
        got = port[key]
        if isinstance(want, dict):
            assert sorted(got) == sorted(want), key
            for f in want:
                assert np.asarray(got[f]).tobytes() == np.asarray(want[f]).tobytes(), (key, f)
        elif isinstance(want, np.ndarray):
            assert got.shape == want.shape and got.tobytes() == want.tobytes(), key
        else:
            assert got == want, key
    return port


def sessions_of(hv) -> dict:
    s = hv.state.sessions
    return {"i32": np_of(s.i32).copy(), "f32": np_of(s.f32).copy()}


class TestConsistencyDispatch:
    def test_mode_column_reflects_config(self):
        async def seq(pkg):
            hv, strong, eventual = await _facade_with_modes(pkg)
            modes = np_of(hv.state.sessions.mode)
            return {"modes": modes[[strong.slot, eventual.slot]]}

        port = both_facades(seq)
        assert port["modes"].tolist() == [PORT.ConsistencyMode.STRONG.code,
                                          PORT.ConsistencyMode.EVENTUAL.code]

    def test_eventual_defers_strong_lands_in_tick(self):
        async def seq(pkg):
            hv, strong, eventual = await _facade_with_modes(pkg)
            rt = hv.consistency_runtime(import_par(pkg).make_mesh(N_DEV, platform="cpu"))
            lanes = np.where(np.arange(LANES) % 2 == 0, strong.slot,
                             eventual.slot).astype(np.int32)
            out = {"modes": rt.lane_modes(lanes), "before": sessions_of(hv)}
            result = rt.tick(lanes, sigma_raw=np.full(LANES, 0.8, np.float32),
                             trustworthy=np.ones(LANES, bool), delta_bodies=_bodies())
            out.update(tick=tick_record(result), after=sessions_of(hv),
                       pending=rt.has_pending, counts=rt._pending_counts.copy(),
                       sigma=rt._pending_sigma.copy())
            counts, sigma = rt.reconcile()
            out.update(totals={"counts": counts, "sigma": sigma}, final=sessions_of(hv),
                       pending_after=rt.has_pending, slots=(strong.slot, eventual.slot))
            return out

        port = both_facades(seq)
        strong, eventual = port["slots"]
        n = lambda rec: rec["i32"][:, 2]  # noqa: E731
        assert n(port["after"])[strong] - n(port["before"])[strong] == LANES // 2
        assert n(port["after"])[eventual] == n(port["before"])[eventual]
        assert port["pending"] and not port["pending_after"]
        assert float(port["tick"]["consensus"][0]) == LANES // 2
        assert port["totals"]["counts"][eventual] == LANES // 2
        assert port["totals"]["sigma"][eventual] == pytest.approx(0.8 * LANES / 2, rel=1e-5)
        assert n(port["final"])[eventual] - n(port["before"])[eventual] == LANES // 2

    def test_strong_and_eventual_converge_to_same_table(self):
        async def seq(pkg):
            out = {}
            for name in ("strong", "eventual"):
                hv, strong, eventual = await _facade_with_modes(pkg)
                slot = strong.slot if name == "strong" else eventual.slot
                rt = hv.consistency_runtime(import_par(pkg).make_mesh(N_DEV, platform="cpu"))
                sigma = np.linspace(0.6, 0.95, LANES).astype(np.float32)
                rt.tick(np.full(LANES, slot, np.int32), sigma, np.ones(LANES, bool),
                        _bodies(3))
                out[f"pending_{name}"] = rt.has_pending
                totals = rt.reconcile()
                out[f"totals_{name}"] = {"counts": totals[0], "sigma": totals[1]}
                out[f"n_{name}"] = int(np_of(hv.state.sessions.n_participants)[slot])
            return out

        port = both_facades(seq)
        assert not port["pending_strong"] and port["pending_eventual"]
        assert port["n_strong"] == port["n_eventual"] == LANES

    def test_runtime_cached_per_mesh(self):
        par = import_par(PORT)
        hv = _facade(PORT)
        mesh = par.make_mesh(N_DEV, platform="cpu")
        assert hv.consistency_runtime(mesh) is hv.consistency_runtime(mesh)
        # An equal mesh built again finds the same runtime (meshes hash by
        # their devices and axis names); another mesh gets its own.
        assert hv.consistency_runtime(par.make_mesh(N_DEV, platform="cpu")) is \
            hv.consistency_runtime(mesh)
        assert hv.consistency_runtime(par.make_mesh(4, platform="cpu")) is not \
            hv.consistency_runtime(mesh)

    def test_nonreversible_manifest_forces_strong_dispatch(self):
        async def seq(pkg):
            hv, _, eventual = await _facade_with_modes(pkg)
            await hv.join_session(
                eventual.sso.session_id, "did:perm",
                actions=[pkg.ActionDescriptor(
                    action_id="drop_table", name="drop table", execute_api="/exec",
                    undo_api=None, reversibility=pkg.ReversibilityLevel.NONE)],
                sigma_raw=0.9)
            rt = hv.consistency_runtime(import_par(pkg).make_mesh(N_DEV, platform="cpu"))
            return {"modes": rt.lane_modes(np.full(LANES, eventual.slot, np.int32))}

        port = both_facades(seq)
        assert port["modes"].all()


@pytest.mark.parametrize("case", range(4))
def test_mixed_modes_converge_to_all_strong(case):
    """`test_mode_tick_property.py`'s property on seeded draws (the
    reference draws them with hypothesis): any mode assignment and lane
    targets, one tick and a reconcile, equal the all-STRONG table, on
    both packages alike."""
    rng = np.random.RandomState(100 + case)
    n_sessions = 6
    modes = rng.randint(0, 2, n_sessions).tolist()
    lane_sessions = rng.randint(0, n_sessions, LANES).tolist()
    sigma = rng.uniform(0.3, 1.0, LANES).astype(np.float32)

    async def run(pkg, modes_):
        hv = pkg.Hypervisor(state=_facade(pkg).state)
        slots = []
        for i in range(n_sessions):
            ms = await hv.create_session(pkg.SessionConfig(
                consistency_mode=(pkg.ConsistencyMode.STRONG if modes_[i]
                                  else pkg.ConsistencyMode.EVENTUAL),
                min_sigma_eff=0.0, max_participants=64), creator_did="did:lead")
            slots.append(ms.slot)
        rt = hv.consistency_runtime(import_par(pkg).make_mesh(N_DEV, platform="cpu"))
        tick = rt.tick(np.array([slots[s] for s in lane_sessions], np.int32), sigma,
                       np.ones(LANES, bool), _bodies(0))
        counts, total_sigma = rt.reconcile()
        return {"tick": tick_record(tick), "totals": {"counts": counts, "sigma": total_sigma},
                "n": np_of(hv.state.sessions.n_participants)[:n_sessions + 1].copy()}

    async def seq(pkg):
        mixed = await run(pkg, modes)
        strong = await run(pkg, [1] * n_sessions)
        return {"mixed_tick": mixed["tick"], "mixed_totals": mixed["totals"],
                "mixed_n": mixed["n"], "strong_n": strong["n"]}

    port = both_facades(seq)
    np.testing.assert_array_equal(port["mixed_n"], port["strong_n"])


def test_mode_tick_equals_the_reference_with_crowded_sessions():
    """`mode_tick` directly: 64 lanes over 5 sessions (several lanes of one
    session on each shard, so the EVENTUAL sigma partial sums many f32
    values in lane order), mixed modes, a few inactive lanes."""
    from hypervisor_tpu.tables.state import SessionTable
    from hypervisor_tpu.tables.struct import replace as t_replace

    rng = np.random.RandomState(8)
    s = 64
    sessions = SessionTable.create(16)
    sessions = t_replace(sessions, mode=sessions.mode.at[:5].set(
        jnp.asarray([0, 1, 1, 0, 1], jnp.int8)))
    lane_session = rng.randint(0, 5, s).astype(np.int32)
    strong = np.asarray(sessions.mode)[lane_session] == 0
    args = (lane_session, strong, rng.uniform(0.5, 1.0, s).astype(np.float32),
            rng.uniform(size=s) > 0.1, np.full(s, 0.55, np.float32), _bodies(4, s),
            rng.uniform(size=s) > 0.1)
    ref = RC.mode_tick(ref_mesh())(sessions, *map(jnp.asarray, args))
    port = PC.mode_tick(port_mesh_of())(port_table(sessions), *map(put, args))
    assert_same(port, ref)
    assert (np_of(port[3]) != 0).sum() > 5
