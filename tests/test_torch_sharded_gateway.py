"""The port's sharded action gateway against the reference's, on the CPU.

Counterparts of `tests/parity/test_sharded_gateway.py` (5) and of
`test_multislice_wave.py::test_multislice_sharded_gateway_matches_single_device`:
the same deterministic world (40 standing members over five shard
regions, a quarantined row, a sudo grant, a drained bucket) is built on
both packages' `HypervisorState` (the port on the CPU), the same ragged
action wave runs through `check_actions_wave(mesh=)` on the reference's
8-device CPU mesh and on the port's 8-shard mesh, and the verdict lanes,
every agent column, the metrics (but the compile counters) and the trace
structure are held equal at tolerance 0. Each case also holds the port's
sharded wave to the port's single-device gateway wave, as the reference
holds its own.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import hypervisor_tpu as REF
import hypervisor_tpu_torch as PORT
from tests.parity import test_sharded_gateway as ref_gw
from tests.test_torch_mesh_wave import (
    _state,
    import_par,
    run_waves,
    state_record,
    wave_outputs,
)
from tests.test_torch_metrics import unarmed  # noqa: F401
from tests.test_torch_parallel import N_DEV, np_of

LANES = ("verdict", "ring_status", "eff_ring", "sigma_eff", "severity", "anomaly_rate",
         "window_calls", "tripped")


def _world(pkg, max_agents=64):
    """The reference test's `_state()` on either package."""
    cfg = dataclasses.replace(
        pkg.config.DEFAULT_CONFIG,
        rate_limit=pkg.config.RateLimitConfig(ring_rates=(0.0, 0.0, 0.0, 0.0)),
        capacity=dataclasses.replace(pkg.config.DEFAULT_CONFIG.capacity,
                                     max_agents=max_agents),
    )
    from importlib import import_module

    cls = import_module(f"{pkg.__name__}.state").HypervisorState
    st = cls(cfg) if pkg is REF else cls(cfg, device="cpu")
    sess = st.create_session("sg:s0", pkg.SessionConfig(min_sigma_eff=0.0, max_participants=64))
    for i in range(ref_gw.N_AGENTS):
        st.enqueue_join(sess, f"did:g{i}", sigma_raw=ref_gw._sigma(i))
    assert (np_of(st.flush_joins(now=10.0)) == 0).all()
    st.quarantine_rows([21], now=10.0)
    st.grant_elevation(7, granted_ring=1, now=10.0, ttl_seconds=900.0)
    if pkg is REF:
        from hypervisor_tpu.tables.struct import replace as t_replace

        st.agents = t_replace(st.agents, rl_tokens=st.agents.rl_tokens.at[30].set(1.4))
    else:
        from hypervisor_tpu_torch.tables.state import AF32_RL_TOKENS

        st.agents.f32[30, AF32_RL_TOKENS] = 1.4
    return st


def gateway_out(gw) -> dict:
    return {f: np_of(getattr(gw, f)) for f in LANES}


def _mesh8(pkg):
    return import_par(pkg).make_mesh(N_DEV, platform="cpu")


def test_ragged_wave_matches_single_device_bitwise():
    def seq(pkg, mesh):
        st = _world(pkg)
        gw = st.check_actions_wave(*ref_gw._cols(), now=20.0, mesh=mesh)
        return {"gw": gateway_out(gw), "state": state_record(st)}

    port = run_waves(seq)
    from hypervisor_tpu_torch.ops import gateway as gw

    assert port["gw"]["verdict"].tolist() == [  # the reference test's refusal story
        gw.GATE_ALLOWED, gw.GATE_QUARANTINED, gw.GATE_ALLOWED, gw.GATE_RING, gw.GATE_ALLOWED,
        gw.GATE_RING, gw.GATE_RING, gw.GATE_RING, gw.GATE_RING, gw.GATE_RATE, gw.GATE_RING,
        gw.GATE_BREAKER, gw.GATE_ALLOWED, gw.GATE_BREAKER, gw.GATE_ALLOWED,
    ]
    single = _world(PORT)
    gw1 = single.check_actions_wave(*ref_gw._cols(), now=20.0)
    for f in LANES:
        assert np_of(getattr(gw1, f)).tobytes() == port["gw"][f].tobytes(), f
    assert np_of(single.agents.f32).tobytes() == port["state"]["arrays"]["agents.f32"].tobytes()
    assert np_of(single.agents.i32).tobytes() == port["state"]["arrays"]["agents.i32"].tobytes()


def test_single_action_and_cross_shard_elevation():
    def seq(pkg, mesh):
        st = _world(pkg)
        st.grant_elevation(33, granted_ring=1, now=10.0, ttl_seconds=900.0)
        one = (np.asarray([33], np.int32), np.asarray([1], np.int8), np.asarray([False]),
               np.asarray([True]), np.asarray([False]), np.asarray([False]))
        gw = st.check_actions_wave(*one, now=20.0, mesh=mesh)
        return {"gw": gateway_out(gw), "state": state_record(st)}

    port = run_waves(seq)
    assert port["gw"]["verdict"].tolist() == [0] and port["gw"]["eff_ring"].tolist() == [1]


def test_empty_wave_is_a_noop():
    def seq(pkg, mesh):
        st = _world(pkg)
        before = state_record(st)
        empty = np.asarray([], np.int32)
        gw = st.check_actions_wave(empty, empty, empty.astype(bool), empty.astype(bool),
                                   empty.astype(bool), empty.astype(bool), now=20.0, mesh=mesh)
        return {"gw": gateway_out(gw), "state_before": before, "state": state_record(st)}

    port = run_waves(seq)
    assert len(port["gw"]["verdict"]) == 0
    assert port["state"]["arrays"]["agents.i32"].tobytes() == \
        port["state_before"]["arrays"]["agents.i32"].tobytes()


def test_indivisible_capacity_refuses_clearly():
    for pkg in (REF, PORT):
        st = _world(pkg, max_agents=60)
        with pytest.raises(ValueError, match="not divisible"):
            st.check_actions_wave([0], [2], [False], [False], [False], [False], now=20.0,
                                  mesh=_mesh8(pkg))


def test_fused_gateway_phase_matches_composed_calls():
    """`run_governance_wave(mesh=, actions=)`: admissions, terminations and
    standing members' actions in one sharded wave, equal on both packages
    and to the port's single-device wave with the same actions."""
    t, k, b = 2, 8, 16
    slots, req, ro, cons, wit, ht = ref_gw._cols()
    actions = dict(slots=slots, required_rings=req, is_read_only=ro, has_consensus=cons,
                   has_sre_witness=wit, host_tripped=ht)

    def staged(pkg, st):
        session_slots = st.create_sessions_batch([f"fw:s{i}" for i in range(k)],
                                                 pkg.SessionConfig(min_sigma_eff=0.0))
        bodies = np.random.RandomState(7).randint(0, 2**32, size=(t, k, 16),
                                                  dtype=np.uint64).astype(np.uint32)
        return (session_slots, [f"did:fw:{i}" for i in range(b)],
                np.asarray(session_slots, np.int32)[np.arange(b) % k],
                np.linspace(0.62, 0.95, b).astype(np.float32), bodies)

    def seq(pkg, mesh):
        st = _world(pkg, max_agents=512)
        res, gw = st.run_governance_wave(*staged(pkg, st), now=20.0, mesh=mesh,
                                         actions=actions)
        return {"wave": wave_outputs(res), "gw": gateway_out(gw), "state": state_record(st)}

    port = run_waves(seq)
    single = _world(PORT, max_agents=512)
    res1, gw1 = single.run_governance_wave(*staged(PORT, single), now=20.0, actions=actions)
    for f in ("status", "merkle_root"):
        assert np_of(getattr(res1, f)).tobytes() == port["wave"][f].tobytes(), f
    for f in ("verdict", "ring_status", "eff_ring", "tripped"):
        assert np_of(getattr(gw1, f)).tobytes() == port["gw"][f].tobytes(), f
    from hypervisor_tpu_torch.observability import metrics as mp

    snap = single.metrics_snapshot()
    counters = port["state"]["metrics"]["counters"]
    for handle in (mp.GATEWAY_ALLOWED, mp.GATEWAY_DENIED):
        assert counters[handle.index] == snap.counter(handle), handle
    assert counters[mp.GATEWAY_ALLOWED.index] + counters[mp.GATEWAY_DENIED.index] == len(slots)
    flags = port["state"]["arrays"]["agents.i32"][:, 2]
    assert flags[33] & 4  # FLAG_BREAKER_TRIPPED


def test_multislice_sharded_gateway_matches_single_device():
    """`check_actions_wave(mesh=<(2, 4) grid>)`: the collective-free gateway
    over the flattened grid on a ragged, duplicate-slot request."""

    def seq(pkg, _mesh8):
        mesh = import_par(pkg).make_multislice_mesh(2, 4, platform="cpu")
        st = _state(pkg, max_agents=64)
        sess = st.create_session("gw:s", pkg.SessionConfig(min_sigma_eff=0.0))
        for i in range(5):
            st.enqueue_join(sess, f"did:gw:{i}", sigma_raw=0.8)
        st.flush_joins(now=1.0)
        slots = [st._slot_of_member[(st.agent_ids.lookup(f"did:gw:{i}"), sess)]
                 for i in range(5)]
        req = np.array(slots + [slots[0]], np.int32)
        n = len(req)
        gw = st.check_actions_wave(req, np.full(n, 2, np.int8), np.zeros(n, bool),
                                   np.zeros(n, bool), np.zeros(n, bool), np.zeros(n, bool),
                                   now=2.0, mesh=mesh)
        return {"gw": gateway_out(gw), "state": state_record(st)}

    port = run_waves(seq)
    assert port["gw"]["verdict"].tolist() == [0] * 6


def test_sharded_gateway_function_equals_the_reference():
    """`parallel.collectives.sharded_gateway` called directly on a padded
    layout (every shard's block, valid=False padding): lanes and the
    agent table at tolerance 0 against the reference's program."""
    import jax.numpy as jnp

    from hypervisor_tpu.parallel import collectives as RC
    from hypervisor_tpu_torch.parallel import collectives as PC
    from tests.test_torch_parallel import assert_same, port_mesh_of, port_table, put, ref_mesh

    ref_st = _world(REF)
    act = {"slots": ref_gw._cols()[0], "required_rings": ref_gw._cols()[1],
           "is_read_only": ref_gw._cols()[2], "has_consensus": ref_gw._cols()[3],
           "has_sre_witness": ref_gw._cols()[4], "host_tripped": ref_gw._cols()[5]}
    flat, valid, args = ref_st._gateway_shard_args(act, N_DEV)
    cols = [np.asarray(a) for a in args]
    agents, elev = ref_st.agents, ref_st.elevations
    ref = RC.sharded_gateway(ref_mesh())(agents, elev, *map(jnp.asarray, cols), 20.0)
    port = PC.sharded_gateway(port_mesh_of())(port_table(agents), port_table(elev),
                                              *map(put, cols), 20.0)
    assert_same(port, ref)
    port_st = _world(PORT)
    p_flat, p_valid, p_args = port_st._gateway_shard_args(act, N_DEV)
    assert (p_flat == flat).all() and (p_valid == valid).all()
    assert all(np_of(a).tobytes() == c.tobytes() for a, c in zip(p_args, cols))
    assert isinstance(port[0].f32, torch.Tensor)
