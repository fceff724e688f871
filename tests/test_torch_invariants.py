"""The port's invariant sanitizer and gauge epilogue against the
reference's, on the CPU, bit for bit (tolerance 0).

One clean seeded set of the nine tables, rings and logs (numpy), and the
same set with one field corrupted for each entry of `CATALOG`, go
through the JAX package's `check_invariants` and the port's: the
violation masks, the counts, the metrics rows `book_sanitizer_metrics`
writes, and every `repair_*` of the masks must agree, and the corrupted
entry's bit must be set. `update_gauges` and `apply_occupancy_gauges`
are held the same way on random tables.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervisor_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from hypervisor_tpu.integrity import invariants as jax_inv
from hypervisor_tpu.observability import metrics as jax_schema
from hypervisor_tpu.tables import logs as jax_logs
from hypervisor_tpu.tables import state as jax_ts
from hypervisor_tpu.tables.metrics import MetricsTable as JaxMetricsTable
from hypervisor_tpu_torch import u32
from hypervisor_tpu_torch.integrity import invariants as port_inv
from hypervisor_tpu_torch.observability import metrics as port_schema
from hypervisor_tpu_torch.tables import logs as port_logs
from hypervisor_tpu_torch.tables import state as port_ts
from hypervisor_tpu_torch.tables.metrics import MetricsTable

N, S, E, G, M_STEPS, M_ELEV, C, C_EVENTS, C_TRACE = 32, 16, 40, 8, 4, 6, 24, 8, 16
BURSTS = (200.0, 100.0, 40.0, 10.0)
NOW, QUARANTINE = 50.0, 300.0
_TABLES = {
    "agents": (jax_ts.AgentTable, port_ts.AgentTable),
    "sessions": (jax_ts.SessionTable, port_ts.SessionTable),
    "vouches": (jax_ts.VouchTable, port_ts.VouchTable),
    "sagas": (jax_ts.SagaTable, port_ts.SagaTable),
    "elevations": (jax_ts.ElevationTable, port_ts.ElevationTable),
    "delta_log": (jax_logs.DeltaLog, port_logs.DeltaLog),
    "event_log": (jax_logs.EventLog, port_logs.EventLog),
    "trace_log": (jax_logs.TraceLog, port_logs.TraceLog),
}
_MASKS = ("agent_mask", "session_mask", "vouch_mask", "saga_mask", "elev_mask", "log_mask")


def _clean(seed: int = 0) -> dict[str, dict[str, np.ndarray]]:
    """Every table consistent: allocated agents with sane sigma, rings,
    tokens and memberships; live sessions, sagas and grants in range;
    at most three edges of bond <= 0.3 a voucher; a wrapped DeltaLog
    whose surviving turns are contiguous per session."""
    rng = np.random.RandomState(seed)
    f32 = np.zeros((N, 8), np.float32)
    f32[:, 0] = rng.uniform(0, 1, N)
    f32[:, 1] = rng.uniform(0.65, 1, N)
    f32[:, 4] = rng.uniform(0, 10, N)
    i32 = np.zeros((N, 21), np.int32)
    i32[:, 0] = np.where(np.arange(N) < 24, np.arange(N), -1)
    i32[:, 1] = np.where(np.arange(N) < 24, rng.randint(-1, S, N), -1)
    i32[:, 2] = np.where(np.arange(N) < 20, port_ts.FLAG_ACTIVE, 0) | (
        (rng.uniform(size=N) < 0.2) * port_ts.FLAG_QUARANTINED)
    ring = rng.randint(1, 4, N).astype(np.int8)
    agents = {"f32": f32, "i32": i32, "ring": ring}

    si32 = np.zeros((S, 5), np.int32)
    si32[:, 0] = np.where(np.arange(S) < 12, np.arange(S), -1)
    si32[:, 1] = 10
    si32[:, 2] = rng.randint(0, 11, S)
    si32[:, 3] = rng.randint(0, 5, S)
    si32[:, 4] = rng.randint(0, 2, S)
    sf32 = np.zeros((S, 4), np.float32)
    sf32[:, 0] = 0.6
    sf32[:, 1] = rng.uniform(0, 40, S)
    sf32[:, 3] = rng.uniform(0, 3600, S)
    sessions = {"i32": si32, "f32": sf32, "enable_audit": np.ones(S, bool),
                "has_nonreversible": np.zeros(S, bool)}

    voucher = np.repeat(np.arange(14, dtype=np.int32), 3)[:E]
    vouches = {
        "voucher": voucher, "vouchee": rng.randint(0, N, E).astype(np.int32),
        "session": rng.randint(0, S, E).astype(np.int32),
        "bond_pct": rng.uniform(0, 1, E).astype(np.float32),
        "bond": rng.uniform(0, 0.3, E).astype(np.float32),
        "active": rng.uniform(size=E) < 0.8,
        "expiry": np.full(E, np.inf, np.float32),
    }
    n_steps = rng.randint(0, M_STEPS + 1, G).astype(np.int32)
    sagas = {
        "step_state": rng.randint(0, 7, (G, M_STEPS)).astype(np.int8),
        "retries_left": rng.randint(0, 3, (G, M_STEPS)).astype(np.int8),
        "has_undo": rng.uniform(size=(G, M_STEPS)) < 0.5,
        "timeout": np.full((G, M_STEPS), 300.0, np.float32),
        "saga_state": rng.randint(0, 5, G).astype(np.int8),
        "session": np.where(np.arange(G) < 6, rng.randint(0, S, G), -1).astype(np.int32),
        "n_steps": n_steps, "cursor": np.minimum(rng.randint(0, M_STEPS + 1, G), n_steps).astype(np.int32),
    }
    elevations = {
        "agent": np.where(np.arange(M_ELEV) < 4, rng.randint(0, N, M_ELEV), -1).astype(np.int32),
        "granted_ring": rng.randint(0, 4, M_ELEV).astype(np.int8),
        "expires_at": rng.uniform(0, 100, M_ELEV).astype(np.float32),
        "active": np.arange(M_ELEV) < 4,
    }
    # Ten sessions append three turns each, in order: 30 records, the
    # oldest six overwritten.
    records = [(s, t) for s in range(10) for t in range(3)]
    dsess, dturn = np.full(C, -1, np.int32), np.zeros(C, np.int32)
    for i, (s, t) in enumerate(records):
        dsess[i % C], dturn[i % C] = s, t
    delta_log = {
        "body": rng.randint(0, 2**32, (C, 16), dtype=np.uint64).astype(np.uint32),
        "digest": rng.randint(0, 2**32, (C, 8), dtype=np.uint64).astype(np.uint32),
        "session": dsess, "turn": dturn, "cursor": np.int32(len(records)),
    }
    event_log = {
        "event_type": rng.randint(-1, 9, C_EVENTS).astype(np.int32),
        "session": rng.randint(-1, S, C_EVENTS).astype(np.int32),
        "agent": rng.randint(-1, N, C_EVENTS).astype(np.int32),
        "trace": rng.randint(0, 2**32, C_EVENTS, dtype=np.uint64).astype(np.uint32),
        "span": rng.randint(0, 2**32, C_EVENTS, dtype=np.uint64).astype(np.uint32),
        "timestamp": rng.uniform(0, 50, C_EVENTS).astype(np.float32),
        "cursor": np.int32(11),
    }
    trace_log = {"words": rng.randint(0, 2**32, (C_TRACE, 7), dtype=np.uint64).astype(np.uint32),
                 "cursor": np.int32(21)}
    return {"agents": agents, "sessions": sessions, "vouches": vouches, "sagas": sagas,
            "elevations": elevations, "delta_log": delta_log, "event_log": event_log,
            "trace_log": trace_log}


def _corrupt_escrow(t):
    v = t["vouches"]
    v["active"][:3] = True
    v["bond"][:3] = np.float32(0.35)


def _corrupt_turn_chain(t):
    d = t["delta_log"]
    live = np.nonzero(d["session"] == 5)[0]
    d["turn"][live[2]] = d["turn"][live[0]]


def _set(table, col, index, value):
    def go(t):
        t[table][col][index] = value
    return go


#: One corruption per CATALOG entry: (table, check) -> (edit, mask field, row).
CORRUPTIONS = {
    ("agents", "sigma_range"): (_set("agents", "f32", (3, 0), 1.5), "agent_mask", 3),
    ("agents", "ring_range"): (_set("agents", "ring", 4, 7), "agent_mask", 4),
    ("agents", "ring_sigma"): (lambda t: (_set("agents", "ring", 5, 1)(t),
                                          _set("agents", "f32", (5, 1), 0.3)(t)), "agent_mask", 5),
    ("agents", "rl_tokens"): (_set("agents", "f32", (6, 4), np.inf), "agent_mask", 6),
    ("agents", "flags"): (_set("agents", "i32", (7, 2), 1 | (1 << 9)), "agent_mask", 7),
    ("agents", "session_ref"): (_set("agents", "i32", (8, 1), S + 5), "agent_mask", 8),
    ("sessions", "state_code"): (_set("sessions", "i32", (2, 3), 9), "session_mask", 2),
    ("sessions", "mode_code"): (_set("sessions", "i32", (3, 4), 5), "session_mask", 3),
    ("sessions", "n_participants"): (_set("sessions", "i32", (4, 2), 13), "session_mask", 4),
    ("sessions", "timestamps"): (_set("sessions", "f32", (5, 1), np.nan), "session_mask", 5),
    ("vouches", "endpoint"): (lambda t: (_set("vouches", "voucher", 5, N + 2)(t),
                                         _set("vouches", "active", 5, True)(t)), "vouch_mask", 5),
    ("vouches", "bond"): (lambda t: (_set("vouches", "bond", 7, -0.5)(t),
                                     _set("vouches", "active", 7, True)(t)), "vouch_mask", 7),
    ("vouches", "escrow_conservation"): (_corrupt_escrow, "vouch_mask", 1),
    ("sagas", "state_code"): (_set("sagas", "saga_state", 1, 7), "saga_mask", 1),
    ("sagas", "cursor"): (_set("sagas", "cursor", 2, M_STEPS + 3), "saga_mask", 2),
    ("sagas", "n_steps"): (_set("sagas", "n_steps", 3, -1), "saga_mask", 3),
    ("sagas", "step_state"): (_set("sagas", "step_state", (4, 2), 9), "saga_mask", 4),
    ("elevations", "range"): (_set("elevations", "agent", 1, N + 1), "elev_mask", 1),
    ("logs", "cursor"): (lambda t: t["event_log"].update(cursor=np.int32(-3)), "log_mask", 1),
    ("logs", "delta_row"): (_set("delta_log", "session", 10, S + 4), "log_mask", 0),
    ("logs", "turn_chain"): (_corrupt_turn_chain, "log_mask", 0),
}


def _jax_tables(t):
    out = {}
    for name, (jcls, _) in _TABLES.items():
        out[name] = jcls(**{k: jnp.asarray(v) for k, v in t[name].items()})
    return out


def _port_tables(t):
    out = {}
    for name, (_, pcls) in _TABLES.items():
        cols = {}
        for k, v in t[name].items():
            a = np.array(v, copy=True)
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            cols[k] = torch.from_numpy(a) if a.ndim else torch.tensor(a)
        out[name] = pcls(**cols)
    return out


def _bits(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _run(t):
    jt, pt = _jax_tables(t), _port_tables(t)
    jm = JaxMetricsTable.create(*jax_schema.REGISTRY.counts(), jax_schema.DEFAULT_BUCKET_BOUNDS_US)
    pm = MetricsTable.create(device="cpu")
    jres = jax_inv.check_invariants(
        jt["agents"], jt["sessions"], jt["vouches"], jt["sagas"], jt["elevations"],
        jt["delta_log"], jt["event_log"], jt["trace_log"], jnp.asarray(BURSTS, jnp.float32),
        metrics=jm)
    pres = port_inv.check_invariants(
        pt["agents"], pt["sessions"], pt["vouches"], pt["sagas"], pt["elevations"],
        pt["delta_log"], pt["event_log"], pt["trace_log"], BURSTS, metrics=pm)
    for f in _MASKS:
        want = np.asarray(getattr(jres, f))
        got = getattr(pres, f).numpy().view(np.uint32)
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), f
    assert int(pres.total) == int(jres.total)
    assert int(pres.unrepairable) == int(jres.unrepairable)
    np.testing.assert_array_equal(u32.to_numpy_u32(pm.counters), np.asarray(jres.metrics.counters))
    assert pm.gauges.numpy().tobytes() == np.asarray(jres.metrics.gauges).tobytes()
    return jt, pt, jres, pres


def _assert_table(got, want, label):
    for f in dataclasses.fields(want):
        w = np.asarray(getattr(want, f.name))
        g = _bits(getattr(got, f.name))
        if w.dtype == np.uint32:
            g = g.view(np.uint32)
        assert g.shape == w.shape and g.tobytes() == w.tobytes(), f"{label}.{f.name}"


def test_clean_tables_show_no_violation():
    *_, jres, pres = _run(_clean())
    assert int(pres.total) == int(jres.total) == 0
    assert int(pres.unrepairable) == 0


def test_every_catalog_entry_has_a_corruption():
    assert sorted(CORRUPTIONS) == sorted((t, c) for t, c, _, _ in port_inv.CATALOG)
    assert port_inv.CATALOG == jax_inv.CATALOG
    for name in ("ESCROW_CAP", "N_SESSION_STATES", "N_CONSISTENCY_MODES", "N_SAGA_STATES",
                 "N_STEP_STATES", "REPAIRABLE_AGENT_BITS", "CONTAIN_AGENT_BITS",
                 "REPAIRABLE_SESSION_BITS", "CONTAIN_VOUCH_BITS"):
        assert getattr(port_inv, name) == getattr(jax_inv, name), name


@pytest.mark.parametrize("entry", [(t, c, k, b) for t, c, k, b in jax_inv.CATALOG],
                         ids=lambda e: f"{e[0]}.{e[1]}")
def test_corrupted_field_matches_reference(entry):
    table, check, klass, bit = entry
    edit, mask_field, row = CORRUPTIONS[(table, check)]
    t = _clean()
    edit(t)
    jt, pt, jres, pres = _run(t)
    assert int(getattr(pres, mask_field)[row]) & bit, f"{table}.{check} not flagged"
    assert int(pres.unrepairable) == int(jres.unrepairable) > 0 if klass == "restore" else True

    # Each repair of the masks, on both sides.
    jm, pm = jres, pres
    ja = jax_inv.repair_agents(jt["agents"], jm.agent_mask, jnp.asarray(BURSTS, jnp.float32),
                               NOW, QUARANTINE, JAX_CONFIG)
    pa = port_inv.repair_agents(pt["agents"], pm.agent_mask, BURSTS, NOW, QUARANTINE)
    _assert_table(pa, ja, "agents")
    _assert_table(port_inv.repair_sessions(pt["sessions"], pm.session_mask),
                  jax_inv.repair_sessions(jt["sessions"], jm.session_mask), "sessions")
    _assert_table(port_inv.repair_vouches(pt["vouches"], pm.vouch_mask),
                  jax_inv.repair_vouches(jt["vouches"], jm.vouch_mask), "vouches")
    _assert_table(port_inv.repair_elevations(pt["elevations"], pm.elev_mask),
                  jax_inv.repair_elevations(jt["elevations"], jm.elev_mask), "elevations")
    if klass == "repair" and table == "agents":
        # A repaired agent row checks clean again.
        again = port_inv.check_invariants(
            pa, pt["sessions"], pt["vouches"], pt["sagas"], pt["elevations"], pt["delta_log"],
            pt["event_log"], pt["trace_log"], BURSTS)
        assert int(again.agent_mask[row]) == 0


def test_repairs_of_random_damage_match_reference():
    """Many rows damaged at once, in every agent column, the session
    counts, the edges and the grants: the repairs agree bit for bit."""
    rng = np.random.RandomState(5)
    t = _clean(5)
    a = t["agents"]
    a["f32"][:, 0] = np.where(rng.uniform(size=N) < 0.3, rng.uniform(-2, 3, N), a["f32"][:, 0])
    a["f32"][:4, 1] = [np.nan, -np.inf, np.inf, 1.25]
    a["f32"][:, 4] = np.where(rng.uniform(size=N) < 0.3, rng.uniform(-50, 500, N), a["f32"][:, 4])
    a["f32"][4, 4] = np.nan
    a["ring"][:] = np.where(rng.uniform(size=N) < 0.3, rng.randint(-3, 9, N), a["ring"])
    a["i32"][:, 2] |= (rng.uniform(size=N) < 0.3) * (1 << 7)
    a["i32"][:, 1] = np.where(rng.uniform(size=N) < 0.2, S + 9, a["i32"][:, 1])
    t["sessions"]["i32"][:, 2] = rng.randint(-3, 15, S)
    t["vouches"]["bond"][:] = np.where(rng.uniform(size=E) < 0.3, -1.0, t["vouches"]["bond"])
    t["vouches"]["vouchee"][:] = np.where(rng.uniform(size=E) < 0.2, -4, t["vouches"]["vouchee"])
    t["elevations"]["granted_ring"][:] = rng.randint(-2, 6, M_ELEV)
    jt, pt, jres, pres = _run(t)
    assert int(pres.total) > 10
    ja = jax_inv.repair_agents(jt["agents"], jres.agent_mask, jnp.asarray(BURSTS, jnp.float32),
                               NOW, QUARANTINE, JAX_CONFIG)
    _assert_table(port_inv.repair_agents(pt["agents"], pres.agent_mask, BURSTS, NOW, QUARANTINE),
                  ja, "agents")
    _assert_table(port_inv.repair_sessions(pt["sessions"], pres.session_mask),
                  jax_inv.repair_sessions(jt["sessions"], jres.session_mask), "sessions")
    _assert_table(port_inv.repair_vouches(pt["vouches"], pres.vouch_mask),
                  jax_inv.repair_vouches(jt["vouches"], jres.vouch_mask), "vouches")
    _assert_table(port_inv.repair_elevations(pt["elevations"], pres.elev_mask),
                  jax_inv.repair_elevations(jt["elevations"], jres.elev_mask), "elevations")


def test_book_sanitizer_metrics_matches_reference():
    jm = JaxMetricsTable.create(*jax_schema.REGISTRY.counts(), jax_schema.DEFAULT_BUCKET_BOUNDS_US)
    jm = jm.__class__(**{**{f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)},
                         "counters": jm.counters.at[50].set(np.uint32(2**32 - 1))})
    pm = MetricsTable.create(device="cpu")
    pm.counters[50] = -1
    # A pass counts rows, below 2^24 (the reference adds each delta
    # through f32, exact up to there); the check counter wraps.
    for total, unrep in ((7, 2), (0, 0), (2**24 - 1, 5)):
        jm = jax_inv.book_sanitizer_metrics(jm, jnp.int32(total), jnp.int32(unrep))
        port_inv.book_sanitizer_metrics(pm, torch.tensor(total, dtype=torch.int32),
                                        torch.tensor(unrep, dtype=torch.int32))
    np.testing.assert_array_equal(u32.to_numpy_u32(pm.counters), np.asarray(jm.counters))
    assert pm.gauges.numpy().tobytes() == np.asarray(jm.gauges).tobytes()


@pytest.mark.parametrize("optional", [True, False])
def test_update_gauges_matches_reference(optional):
    from hypervisor_tpu.observability.metrics import update_gauges as jax_update

    rng = np.random.RandomState(9)
    t = _clean(9)
    t["agents"]["i32"][:, 2] = rng.randint(0, 32, N)
    t["agents"]["ring"][:] = rng.randint(0, 4, N)
    t["delta_log"]["cursor"] = np.int32(3)
    t["trace_log"]["cursor"] = np.int32(400)
    jt, pt = _jax_tables(t), _port_tables(t)
    jm = JaxMetricsTable.create(*jax_schema.REGISTRY.counts(), jax_schema.DEFAULT_BUCKET_BOUNDS_US)
    pm = MetricsTable.create(device="cpu")
    pm.gauges[:] = 7.0
    jm = jm.__class__(**{**{f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)},
                         "gauges": jnp.full(jm.gauges.shape, 7.0, jnp.float32)})
    names = ("sagas", "elevations", "delta_log", "event_log", "trace_log")
    jargs = [jt[n] if optional else None for n in names]
    pargs = [pt[n] if optional else None for n in names]
    jm = jax_update(jm, jt["agents"], jt["sessions"], jt["vouches"], *jargs)
    port_schema.update_gauges(pm, pt["agents"], pt["sessions"], pt["vouches"], *pargs)
    assert pm.gauges.numpy().tobytes() == np.asarray(jm.gauges).tobytes()
    assert pm.gauges[port_schema.TABLE_LIVE_ROWS["trace_log"].index] == (C_TRACE if optional else 7)

    vec = rng.randint(0, 1000, 17).astype(np.int32)
    for flags in ((True, True, True), (False, False, False), (True, False, True)):
        jm = jax_schema.apply_occupancy_gauges(jm, jnp.asarray(vec), *flags)
        port_schema.apply_occupancy_gauges(pm, torch.from_numpy(vec), *flags)
        assert pm.gauges.numpy().tobytes() == np.asarray(jm.gauges).tobytes()
        vec = vec + 1
