"""The port's security surface against the reference's, on the CPU, bit for
bit (tolerance 0 everywhere), but for one documented divergence: the
reference's jitted rate refill is a fused multiply-add, and at a
non-dyadic elapsed time its bucket level lies one ulp from the port's,
which rounds as the reference's source is written (held exactly in
`test_consume_rate_off_the_dyadic_grid_differs_from_the_jitted_reference`).

Two layers:

  * the ops: `ops.security_ops` (`window_latest_epoch`, `record_calls`,
    `breach_sweep`, `elevation_expiry`, `quarantine_sweep`) and
    `ops.rate_limit` (`consume`, `reset_on_ring_change`) on seeded random
    tables, against the JAX package's functions on the same numpy
    inputs;
  * `HypervisorState`: `record_calls`, `breach_sweep_tick`, the elevation
    methods, the quarantine methods, `consume_rate`, `check_actions_wave`,
    `set_agent_ring` / `set_agent_risk` and the session-row writes,
    each sequence run on the reference's state (unarmed) and the port's
    `device="cpu"` state, with the returned values, every table, the
    metrics table, the trace ring and the host indices held equal after
    every step (`tests/test_torch_joins.py`'s harness). The cases port
    `tests/integration/test_security_waves.py` (`TestBreachSweep`,
    `TestElevation`, `TestQuarantinePlane`) and
    `tests/parity/test_breach_window.py` (`TestSweepMidWindow`,
    `TestSlidingExpiry`, `TestWindowProperty`), with the reference's
    `HypervisorState` as the oracle in place of the host breach detector.

Also here: the terminate wave's elevation reclaim (a grant held by a
reclaimed row dies with it, and the next grant takes its row), and
`window_epoch`'s required device.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervisor_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT
from hypervisor_tpu.ops import rate_limit as jax_rate
from hypervisor_tpu.ops import security_ops as jax_security
from hypervisor_tpu.tables.state import AgentTable as JaxAgentTable
from hypervisor_tpu.tables.state import ElevationTable as JaxElevationTable
from hypervisor_tpu_torch import config as port_config
from hypervisor_tpu_torch.ops import rate_limit as port_rate
from hypervisor_tpu_torch.ops import security_ops as port_security
from hypervisor_tpu_torch.state import HypervisorState as PortState
from hypervisor_tpu_torch.tables.state import (
    AF32_BD_BREAKER_UNTIL,
    AF32_QUARANTINE_UNTIL,
    AF32_RL_STAMP,
    AF32_RL_TOKENS,
    AI32_BD_WIN_START,
    AI32_FLAGS,
    AI32_WIDTH,
    BD_BUCKETS,
    FLAG_ACTIVE,
    FLAG_BREAKER_TRIPPED,
    FLAG_QUARANTINED,
    AgentTable,
    ElevationTable,
)
from tests.test_torch_joins import CAP, assert_logs_equal, assert_same, run_both

N = 32
NOW = 125.0
CFG = JAX_DEFAULT.breach
SUB = CFG.window_seconds / BD_BUCKETS


def _agents(rng) -> dict[str, np.ndarray]:
    """Random rows: rings 0-3, tokens and stamps, breaker and quarantine
    deadlines around now, flags, and breach windows whose epochs straddle
    the window's edge (some newer than now)."""
    f32 = rng.uniform(0, 1, (N, 8)).astype(np.float32)
    f32[:, AF32_RL_TOKENS] = rng.uniform(0, 40, N)
    f32[:, AF32_RL_STAMP] = rng.uniform(NOW - 3, NOW + 1, N)
    f32[:, AF32_BD_BREAKER_UNTIL] = np.where(rng.uniform(size=N) < 0.3, 0.0,
                                             rng.uniform(NOW - 40, NOW + 20, N))
    f32[:, AF32_QUARANTINE_UNTIL] = rng.uniform(NOW - 5, NOW + 5, N)
    f32[:4, AF32_QUARANTINE_UNTIL] = NOW  # at the deadline: still held
    i32 = np.zeros((N, AI32_WIDTH), np.int32)
    i32[:, AI32_FLAGS] = (FLAG_ACTIVE | (rng.uniform(size=N) < 0.4) * FLAG_QUARANTINED
                          | (rng.uniform(size=N) < 0.4) * FLAG_BREAKER_TRIPPED)
    k, w = BD_BUCKETS, AI32_BD_WIN_START
    cur = int(np.floor(np.float32(NOW) / np.float32(SUB)))
    i32[:, w:w + k] = rng.randint(0, 6, (N, k))
    i32[:, w + k:w + 2 * k] = rng.randint(0, 4, (N, k))
    i32[:, w + 2 * k:w + 3 * k] = cur - rng.randint(-1, 9, (N, k))
    return {"f32": f32, "i32": i32, "ring": rng.randint(0, 4, N).astype(np.int8)}


def _elevations(rng, m=12) -> dict[str, np.ndarray]:
    return {"agent": np.where(rng.uniform(size=m) < 0.8, rng.randint(0, N, m), -1).astype(np.int32),
            "granted_ring": rng.randint(0, 4, m).astype(np.int8),
            "expires_at": rng.uniform(NOW - 10, NOW + 10, m).astype(np.float32),
            "active": rng.uniform(size=m) < 0.7}


def _jax(cls, cols):
    return cls(**{k: jnp.asarray(v) for k, v in cols.items()})


def _port(cls, cols):
    return cls(**{k: torch.from_numpy(np.array(v, copy=True)) for k, v in cols.items()})


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _same_table(got, want, cols) -> None:
    for c in cols:
        _same(getattr(got, c), getattr(want, c))


# ── the ops ──────────────────────────────────────────────────────────


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("now", [NOW, NOW + 0.5 * SUB, NOW + CFG.window_seconds])
def test_window_latest_epoch_and_breach_sweep_match_reference(seed, now):
    rng = np.random.RandomState(seed)
    cols = _agents(rng)
    ja, pa = _jax(JaxAgentTable, cols), _port(AgentTable, cols)
    _same(port_security.window_latest_epoch(pa.bd_window, now),
          jax_security.window_latest_epoch(ja.bd_window, now))
    cfg = dataclasses.replace(CFG, min_calls_for_analysis=int(rng.randint(1, 8)))
    want = jax_security.breach_sweep(ja, now, cfg)
    got = port_security.breach_sweep(pa, now, port_config.BreachConfig(**vars(cfg)))
    _same(got.severity, want.severity)
    _same(got.tripped, want.tripped)
    _same_table(got.agents, want.agents, ("f32", "i32", "ring"))


@pytest.mark.parametrize("seed", range(3))
def test_record_calls_matches_reference(seed):
    rng = np.random.RandomState(10 + seed)
    cols = _agents(rng)
    slots = rng.randint(0, N, 50).astype(np.int32)  # repeated slots
    rings = rng.randint(0, 4, 50).astype(np.int8)
    for now in (NOW, NOW - 2 * SUB, NOW + 3.3 * SUB):  # a late `now` too
        want = jax_security.record_calls(_jax(JaxAgentTable, cols), jnp.asarray(slots),
                                         jnp.asarray(rings), now)
        got = port_security.record_calls(_port(AgentTable, cols), torch.from_numpy(slots),
                                         torch.from_numpy(rings), now)
        _same_table(got, want, ("f32", "i32", "ring"))


@pytest.mark.parametrize("now", [NOW - 10.0, NOW, NOW + 0.25, NOW + 10.0])
def test_elevation_expiry_and_quarantine_sweep_match_reference(now):
    rng = np.random.RandomState(20)
    ecols, acols = _elevations(rng), _agents(rng)
    want_e, want_x = jax_security.elevation_expiry(_jax(JaxElevationTable, ecols), now)
    got_e, got_x = port_security.elevation_expiry(_port(ElevationTable, ecols), now)
    _same(got_x, want_x)
    _same_table(got_e, want_e, ("agent", "granted_ring", "expires_at", "active"))
    want = jax_security.quarantine_sweep(_jax(JaxAgentTable, acols), now)
    got = port_security.quarantine_sweep(_port(AgentTable, acols), now)
    _same(got.released, want.released)
    _same(got.still_held, want.still_held)
    _same_table(got.agents, want.agents, ("f32", "i32", "ring"))


@pytest.mark.parametrize("cost", ["scalar", "vector"])
def test_rate_consume_and_ring_reset_match_reference(cost):
    rng = np.random.RandomState(30)
    cols = _agents(rng)
    tokens, stamp = cols["f32"][:, AF32_RL_TOKENS], cols["f32"][:, AF32_RL_STAMP]
    ring = cols["ring"]
    c = (1.0 if cost == "scalar"
         else np.where(rng.uniform(size=N) < 0.5, 0.0, rng.randint(1, 40, N)).astype(np.float32))
    for now in (NOW, NOW + 0.37):
        want = jax_rate.consume(jnp.asarray(tokens), jnp.asarray(stamp), jnp.asarray(ring), now,
                                c if cost == "scalar" else jnp.asarray(c))
        got = port_rate.consume(torch.from_numpy(tokens), torch.from_numpy(stamp),
                                torch.from_numpy(ring), now,
                                c if cost == "scalar" else torch.from_numpy(c))
        for f in ("allowed", "tokens", "stamp"):
            _same(getattr(got, f), getattr(want, f))
    changed = rng.uniform(size=N) < 0.5
    new_ring = rng.randint(-1, 5, N).astype(np.int8)
    _same(port_rate.reset_on_ring_change(torch.from_numpy(tokens), torch.from_numpy(changed),
                                         torch.from_numpy(new_ring)),
          jax_rate.reset_on_ring_change(jnp.asarray(tokens), jnp.asarray(changed),
                                        jnp.asarray(new_ring)))


def test_refill_rounds_the_multiply_and_the_add_apart():
    """tokens + elapsed * rate rounds the product, then the sum, as the
    reference's op is written and as its eager run computes it: 40 +
    (1.0 - f32(0.9)) * 100 is 50.0, where one fused multiply-add gives
    50.000004. (The reference's jitted XLA:CPU program contracts the two
    into one fused multiply-add: ROADMAP C.3.)"""
    args = (np.array([40.0], np.float32), np.array([0.9], np.float32), np.array([0], np.int8))
    want = jax_rate.refill(*(jnp.asarray(a) for a in args), 1.0)
    got = port_rate.refill(*(torch.from_numpy(a) for a in args), 1.0)
    _same(got, want)
    assert got.item() == 50.0


def test_window_epoch_takes_no_device_default():
    with pytest.raises(TypeError):
        port_security.window_epoch(NOW)
    assert int(port_security.window_epoch(NOW, device="cpu")) == 12


# ── HypervisorState: the breach window and sweep ─────────────────────


def _admitted(st, m, n=4, sigma=0.8, config_name="s:b"):
    slot = st.create_session(config_name, m.SessionConfig(max_participants=32), now=0.0)
    for i in range(n):
        st.enqueue_join(slot, f"did:b{i}", sigma)
    assert (st.flush_joins() == 0).all()
    return slot


def _privileged_trips(st, m, record):
    _admitted(st, m)
    st.record_calls([0] * 8, [0] * 8, now=0.0)
    st.record_calls([1] * 8, [2] * 8, now=0.0)
    record("sweep", st.breach_sweep_tick(now=1.0))


def _below_min_calls(st, m, record):
    _admitted(st, m)
    st.record_calls([0] * 3, [0] * 3, now=0.0)
    record("sweep", st.breach_sweep_tick(now=1.0))


def _cooldown_expires(st, m, record):
    _admitted(st, m)
    st.record_calls([0] * 6, [0] * 6, now=0.0)
    record("trip", st.breach_sweep_tick(now=0.0))
    record("release", st.breach_sweep_tick(now=CFG.circuit_breaker_cooldown_seconds + 1.0))


def _sweep_mid_window(st, m, record):
    _admitted(st, m, n=2)
    st.record_calls([0] * 4, [0] * 4, now=1.0)
    record("mid", st.breach_sweep_tick(now=2.0))
    st.record_calls([0] * 2, [0] * 2, now=3.0)
    record("after", st.breach_sweep_tick(now=3.0))


def _many_sweeps(st, m, record):
    _admitted(st, m, n=2)
    for k, p in enumerate([1, 0, 1, 1, 0, 1, 1, 1, 0, 1]):
        st.record_calls([0], [0 if p else 2], now=1.0 + k)
        record(f"sweep{k}", st.breach_sweep_tick(now=1.0 + k))


def _sliding_expiry(st, m, record):
    _admitted(st, m, n=2)
    st.record_calls([0] * 4, [0] * 4, now=0.5 * SUB)
    st.record_calls([0] * 3, [2] * 3, now=3.5 * SUB)
    record("both", st.breach_sweep_tick(now=3.5 * SUB))
    record("first_aged_out", st.breach_sweep_tick(now=0.5 * SUB + CFG.window_seconds + SUB))
    st.record_calls([0] * 2, [2] * 2, now=3.5 * SUB + BD_BUCKETS * SUB)  # the same bucket, wrapped
    record("wrapped", st.breach_sweep_tick(now=1.0 + 2 * CFG.window_seconds))


def _idle_release_and_retrip(st, m, record):
    _admitted(st, m, n=2)
    st.record_calls([0] * 6, [0] * 6, now=0.0)
    record("trip", st.breach_sweep_tick(now=0.0))
    cooldown = CFG.circuit_breaker_cooldown_seconds
    record("idle_release", st.breach_sweep_tick(now=cooldown + 1.0))
    st.record_calls([0] * 2, [0] * 2, now=cooldown + SUB)
    record("retrip", st.breach_sweep_tick(now=cooldown + SUB))


def _random_schedule(seed):
    def sequence(st, m, record):
        rng = np.random.RandomState(seed)
        _admitted(st, m, n=3)
        t_units = 0
        for i in range(25):
            t_units += int(rng.randint(0, 3 * BD_BUCKETS))
            ts = (t_units + rng.uniform(0.0, 1.0)) * SUB
            slots = rng.randint(0, 3, rng.randint(1, 6))
            st.record_calls(slots, rng.randint(0, 4, len(slots)), now=ts)
            if i % 3 == 0:
                record(f"sweep{i}", st.breach_sweep_tick(now=(t_units + 1) * SUB))
    return sequence


BREACH_CASES = {
    "privileged_call_ratio_trips_breaker": _privileged_trips,
    "below_min_calls_no_analysis": _below_min_calls,
    "breaker_cooldown_expires": _cooldown_expires,
    "sweep_mid_window": _sweep_mid_window,
    "agreement_through_many_sweeps": _many_sweeps,
    "sliding_expiry_and_bucket_wrap": _sliding_expiry,
    "idle_release_then_fresh_probes_retrip": _idle_release_and_retrip,
    **{f"random_schedule_{s}": _random_schedule(s) for s in range(4)},
}


@pytest.mark.parametrize("case", sorted(BREACH_CASES))
def test_breach_case_matches_reference(case, monkeypatch):
    port = assert_logs_equal(*run_both(BREACH_CASES[case], monkeypatch))
    if case == "privileged_call_ratio_trips_breaker":
        severity, tripped = port["sweep"]
        assert severity[0] == 4 and tripped[0] and severity[1] == 0 and not tripped[1]
        assert port["sweep:tables"]["agents.i32"][0, AI32_FLAGS] & FLAG_BREAKER_TRIPPED
    if case == "below_min_calls_no_analysis":
        assert port["sweep"][0][0] == 0 and not port["sweep"][1][0]
    if case == "breaker_cooldown_expires":
        assert port["trip"][1][0]
        assert not port["release:tables"]["agents.i32"][0, AI32_FLAGS] & FLAG_BREAKER_TRIPPED
    if case == "sweep_mid_window":
        assert port["mid"][0][0] == 0 and port["after"][0][0] == 4 and port["after"][1][0]
    if case == "idle_release_then_fresh_probes_retrip":
        assert not port["idle_release"][1][0] and port["retrip"][1][0]


def _custom_breach(st, m, record):
    slot = st.create_session("s:cfg", m.SessionConfig(max_participants=8), now=0.0)
    st.enqueue_join(slot, "did:cfg", 0.8)
    st.flush_joins()
    st.record_calls([0] * 4, [0, 0, 2, 2], now=1.0)
    record("sweep", st.breach_sweep_tick(now=1.0))


def test_sweep_honors_custom_breach_config(monkeypatch):
    """The state's BreachConfig reaches the sweep (min calls 3, high
    threshold 0.5: four calls, two privileged, trip)."""
    from hypervisor_tpu import state as jax_state_mod

    from hypervisor_tpu import config as jax_config

    custom = dict(min_calls_for_analysis=3, high_threshold=0.5)
    jax_cfg = JAX_DEFAULT.replace(breach=dataclasses.replace(JAX_DEFAULT.breach, **custom),
                                  capacity=jax_config.TableCapacity(**CAP))
    port_cfg = port_config.HypervisorConfig(breach=port_config.BreachConfig(**custom),
                                            capacity=port_config.TableCapacity(**CAP))
    made = []

    def make_states(**cap):
        made.append(True)
        return (jax_state_mod.HypervisorState(jax_cfg),
                PortState(port_cfg, device="cpu"))

    monkeypatch.setattr("tests.test_torch_joins.make_states", make_states)
    port = assert_logs_equal(*run_both(_custom_breach, monkeypatch))
    assert made and int(port["sweep"][0][0]) >= 3 and port["sweep"][1][0]


# ── elevations ───────────────────────────────────────────────────────


def _elevation_sequence(st, m, record):
    _admitted(st, m, n=3)
    record("grant", st.grant_elevation(0, granted_ring=1, now=0.0, ttl_seconds=100.0))
    record("rings", (st.effective_rings(now=50.0), st.effective_rings(now=150.0)))
    record("short", st.grant_elevation(1, granted_ring=1, now=0.0, ttl_seconds=10.0))
    record("default_ttl", st.grant_elevation(2, granted_ring=1, now=0.1))
    record("capped", st.grant_elevation(2, granted_ring=1, now=0.3, ttl_seconds=1e9))
    record("tick5", st.elevation_tick(now=5.0))
    record("tick11", st.elevation_tick(now=11.0))
    with pytest.raises(ValueError, match="Ring 0"):
        st.grant_elevation(0, granted_ring=0, now=0.0)
    with pytest.raises(ValueError, match="more privileged"):
        st.grant_elevation(0, granted_ring=2, now=0.0)
    record("reuse", st.grant_elevation(0, granted_ring=1, now=12.0, ttl_seconds=7.7))
    with pytest.raises(ValueError, match="now belongs to agent"):
        st.revoke_elevation(1, expected_agent=1)
    st.revoke_elevation(1, expected_agent=0)
    st.revoke_elevation(1)  # already revoked: a no-op
    record("revoked", st.effective_rings(now=13.0))
    for _ in range(2):
        st.grant_elevation(1, granted_ring=1, now=13.0, ttl_seconds=3.0)
    with pytest.raises(RuntimeError, match="elevation table full"):
        st.grant_elevation(1, granted_ring=1, now=13.0)
    record("full")


def test_elevations_match_reference(monkeypatch):
    port = assert_logs_equal(*run_both(_elevation_sequence, monkeypatch, max_elevations=5))
    during, after = port["rings"]
    assert during[0] == 1 and after[0] == 2
    assert port["tick5"] == 0 and port["tick11"] == 1 and port["reuse"] == 1
    expires = port["capped:tables"]["elevations.expires_at"]
    assert expires[3] == np.float32(0.3 + JAX_DEFAULT.elevation.max_ttl_seconds)
    assert expires[2] == np.float32(0.1 + JAX_DEFAULT.elevation.default_ttl_seconds)


def _terminate_reclaims_grants(st, m, record):
    s = _admitted(st, m, n=3, config_name="s:term")
    t = st.create_session("s:other", m.SessionConfig(), now=0.0)
    st.enqueue_join(t, "did:t0", 0.8)
    st.flush_joins()
    record("grants", [st.grant_elevation(r, 1, now=0.0, ttl_seconds=60.0) for r in (1, 3, 2)])
    record("terminate", st.terminate_sessions([s], now=1.0))
    st.enqueue_join(t, "did:t1", 0.8)  # takes a reclaimed row
    record("rejoin", st.flush_joins(now=2.0))
    row = st.agent_row("did:t1", t)
    record("regrant", (row, st.grant_elevation(row["slot"], 1, now=2.0, ttl_seconds=5.0)))
    record("rings", st.effective_rings(now=3.0))


def test_terminate_reclaims_elevation_rows_as_the_reference(monkeypatch):
    """A grant held by a row the terminate wave reclaims is deactivated,
    its holder set to -1 and its row put back on the free list; the next
    grant takes that row, and the recycled agent row carries no grant."""
    port = assert_logs_equal(*run_both(_terminate_reclaims_grants, monkeypatch))
    assert port["grants"] == [0, 1, 2]
    elev = port["terminate:tables"]
    assert elev["elevations.active"].tolist()[:3] == [False, True, False]
    assert elev["elevations.agent"].tolist()[:3] == [-1, 3, -1]
    assert port["terminate:host"]["free_elev_slots"] == [0, 2]
    row, regrant = port["regrant"]
    assert row["slot"] == 2 and regrant == 2  # the last-freed rows, LIFO
    rings = port["rings"]
    assert rings[:4].tolist() == [2, 2, 1, 1]  # no grant survived on row 1


# ── quarantine, rows and session writes ──────────────────────────────


def _quarantine_sequence(st, m, record):
    _admitted(st, m, n=3)
    st.quarantine_rows([0, 1], now=100.0)
    record("mask", st.quarantined_mask())
    st.quarantine_rows([0], now=150.0, duration=500.0)  # keeps its deadline
    record("extended")
    record("ticks", [st.quarantine_tick(now=t) for t in (399.0, 400.0, 400.5)])
    st.quarantine_rows(np.array([0, 2]), now=500.0, duration=100.25)
    record("again", st.quarantine_tick(now=601.0))


def test_quarantine_matches_reference(monkeypatch):
    port = assert_logs_equal(*run_both(_quarantine_sequence, monkeypatch))
    assert port["mask"][:3].tolist() == [True, True, False]
    until = port["extended:tables"]["agents.f32"][:, AF32_QUARANTINE_UNTIL]
    assert until[0] == 400.0 and until[1] == 400.0
    assert port["ticks"] == [[], [], [0, 1]] and port["again"] == [0, 2]


def _rows_and_sessions(st, m, record):
    s = _admitted(st, m, n=4)
    st.consume_rate([0, 1, 2, 3] * 3, now=1.0)
    st.set_agent_ring(1, 3, now=2.0)
    st.set_agent_ring(2, 1, now=2.25)
    st.set_agent_risk(3, 0.1)
    record("rows")
    short = st.create_session("s:short", m.SessionConfig(max_duration_seconds=30), now=5.0)
    st.create_session("s:long", m.SessionConfig(max_duration_seconds=3600), now=5.0)
    ended = st.create_session("s:ended", m.SessionConfig(max_duration_seconds=1), now=0.0)
    st.set_session_state(ended, m.SessionState.ARCHIVED)
    st.set_session_state(s, m.SessionState.ACTIVE)
    record("sweep", (st.session_expiry_sweep(now=20.0), st.session_expiry_sweep(now=40.0)))
    st.force_session_mode(short, m.ConsistencyMode.STRONG)
    st.force_session_mode(s, m.ConsistencyMode.EVENTUAL, has_nonreversible=False)
    record("modes")


def test_rows_and_session_writes_match_reference(monkeypatch):
    port = assert_logs_equal(*run_both(_rows_and_sessions, monkeypatch))
    assert port["sweep"] == ([], [1])


# ── rate consume and the gateway wave ────────────────────────────────


def _consume_sequence(st, m, record):
    # Dyadic times: elapsed * rate is exact, so the refill's one rounding
    # is the add's; off that grid the jitted reference differs by one ulp
    # (test_consume_rate_off_the_dyadic_grid_differs_from_the_jitted_reference).
    _admitted(st, m, n=6, sigma=0.8)
    st.set_agent_ring(5, 3, now=0.0)  # a burst of 10
    record("unique", st.consume_rate([0, 1, 2, 3, 4, 5], now=0.5))
    record("empty", st.consume_rate([], now=0.625))
    slots = [5] * 14 + [0] * 3 + [4, 5, 0]
    record("duplicates", st.consume_rate(slots, now=0.75))
    rings = [3] * 9 + [1] * 11
    record("rings", st.consume_rate(slots, now=0.875, rings=rings))
    record("unique_rings", st.consume_rate([1, 2], now=1.0, rings=[0, 3]))


def test_consume_rate_matches_reference(monkeypatch):
    port = assert_logs_equal(*run_both(_consume_sequence, monkeypatch))
    assert port["unique"].all() and port["empty"].shape == (0,)
    dup = port["duplicates"]
    assert dup[:10].all() and not dup[10:14].any()  # ring 3's burst of 10, in call order


def _consume_off_the_dyadic_grid(st, m, record):
    _admitted(st, m, n=2, sigma=0.8)  # ring 2: a full bucket of 40
    record("stamp", st.consume_rate([0, 1], now=0.9))  # 39 tokens at stamp f32(0.9)
    # Ring 0 refills 100/s: 39 + (1.0 - f32(0.9)) * 100 - 1.
    record("refill", st.consume_rate([0, 1], now=1.0, rings=[0, 2]))
    record("capped", st.consume_rate([0] * 49 + [1], now=1.0))  # ring 2's burst caps both


def test_consume_rate_off_the_dyadic_grid_differs_from_the_jitted_reference(monkeypatch):
    """The one known divergence from the reference's `HypervisorState`
    (ROADMAP C.3): its jitted consume contracts tokens + elapsed * rate into
    one fused multiply-add, the port rounds the product and the sum apart,
    as the reference's source is written and its eager op computes. At a
    non-dyadic elapsed time the refilled level then differs by exactly one
    ulp; every other value, table and index stays bit-equal (tolerance 0),
    and the burst cap brings the two back together."""
    ref_log, port_log = run_both(_consume_off_the_dyadic_grid, monkeypatch)
    assert [k for k, _ in port_log] == [k for k, _ in ref_log]
    for (label, want), (_, got) in zip(ref_log, port_log):
        if label == "refill:tables":
            want, got = dict(want), dict(got)
            w_f32, g_f32 = want.pop("agents.f32"), got.pop("agents.f32")
            w_tok = w_f32[0, AF32_RL_TOKENS]
            g_tok = g_f32[0, AF32_RL_TOKENS]
            eager = jax_rate.consume(jnp.asarray([39.0], jnp.float32),
                                     jnp.asarray([0.9], jnp.float32), jnp.asarray([0], jnp.int8),
                                     1.0, 1.0).tokens
            assert g_tok == np.asarray(eager)[0] == np.float32(48.0)
            assert w_tok == np.nextafter(g_tok, np.float32(np.inf))  # the fused one: one ulp up
            w_f32[0, AF32_RL_TOKENS] = g_tok
            assert_same(label + " agents.f32", g_f32, w_f32)
        assert_same(label, got, want)


def _gateway_sequence(st, m, record):
    _admitted(st, m, n=8, sigma=0.8)
    st.grant_elevation(1, 1, now=0.0, ttl_seconds=100.0)
    st.quarantine_rows([2], now=0.0)
    st.record_calls([3] * 8, [0] * 8, now=0.0)
    st.breach_sweep_tick(now=0.0)  # row 3's breaker trips
    st.set_agent_ring(4, 3, now=0.0)
    rng = np.random.RandomState(5)
    for wave, b in enumerate((13, 40, 1)):
        slots = rng.randint(0, 8, b)
        slots[:4] = [4] * 4 if b >= 4 else slots[:4]
        record(f"wave{wave}", st.check_actions_wave(
            slots, np.where(rng.uniform(size=b) < 0.3, 0, rng.randint(1, 4, b)),
            rng.uniform(size=b) < 0.3, rng.uniform(size=b) < 0.5, rng.uniform(size=b) < 0.5,
            rng.uniform(size=b) < 0.1, now=1.0 + wave))
    with pytest.raises(ValueError, match="out of range"):
        st.check_actions_wave([0, 99], [2, 2], [False] * 2, [False] * 2, [False] * 2,
                              [False] * 2, now=5.0)
    record("after_refusal")


def _gateway_lanes(result) -> dict:
    return {f: np.array(getattr(result, f), copy=True)
            for f in ("verdict", "ring_status", "eff_ring", "sigma_eff", "severity",
                      "anomaly_rate", "window_calls", "tripped")}


def test_check_actions_wave_matches_reference(monkeypatch):
    def sequence(st, m, record):
        def rec(label, value=None):
            if value is not None and hasattr(value, "verdict"):
                value = _gateway_lanes(value)
            record(label, value)
        _gateway_sequence(st, m, rec)

    port = assert_logs_equal(*run_both(sequence, monkeypatch))
    verdicts = np.concatenate([port[f"wave{w}"]["verdict"] for w in range(3)])
    assert len(set(verdicts.tolist())) >= 4  # several gates refuse
    assert port["wave1"]["verdict"].shape == (40,)


def test_check_actions_wave_refuses_mesh():
    """The sharded gateway is ported: on a CPU mesh it equals the
    reference's on its mesh; a `mesh` that is not a mesh is refused with
    the reference's own error before anything runs."""
    from hypervisor_tpu import parallel as jax_parallel
    from hypervisor_tpu.state import HypervisorState as JaxState
    from hypervisor_tpu_torch import parallel as port_parallel

    outs = []
    for cls, cfg_mod, par, kw in ((JaxState, jax_config_mod(), jax_parallel, {}),
                                  (PortState, port_config, port_parallel, {"device": "cpu"})):
        st = cls(cfg_mod.HypervisorConfig(capacity=cfg_mod.TableCapacity(
            max_agents=8, max_sessions=4)), **kw)
        with pytest.raises(AttributeError) as err:
            st.check_actions_wave([0], [2], [False], [False], [False], [False], now=0.0,
                                  mesh=object())
        assert not np.asarray(st.agents.bd_window).any()  # nothing ran
        gw = st.check_actions_wave([0, 5, 5], [2, 3, 3], [False, True, True], [False] * 3,
                                   [False] * 3, [False] * 3, now=1.0,
                                   mesh=par.make_mesh(4, platform="cpu"))
        outs.append((str(err.value), np.asarray(gw.verdict).tolist(),
                     np.asarray(gw.window_calls).tolist(), np.asarray(st.agents.i32).tolist()))
    assert outs[1] == outs[0]
    assert outs[1][0] == "'object' object has no attribute 'devices'"


def jax_config_mod():
    from hypervisor_tpu import config

    return config
