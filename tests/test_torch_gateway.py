"""The port's action gateway (`ops.gateway.check_actions`) against the
reference's, on the CPU, bit for bit (tolerance 0).

The same seeded agent and elevation tables and action lanes, made with
numpy, go through the JAX package's `check_actions` (jitted, as the
unarmed wave runs it) and the port's on `device="cpu"`. Held equal: every
verdict lane (verdict, ring status, effective ring, sigma, severity,
anomaly rate, window total, trip), the agent table after the gateway
and `tally_gateway`'s counters. One hand-built wave covers each gate:
duplicate slots, ring-0 probes, a live elevation, a breaker tripped on
the device, on the host and in the wave, rate exhaustion, a quarantined
row, an expired breaker and padding lanes; random waves cover the rest.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervisor_tpu.config import BreachConfig, RateLimitConfig
from hypervisor_tpu.observability import metrics as jax_schema
from hypervisor_tpu.ops import gateway as jax_gateway
from hypervisor_tpu.ops import security_ops as jax_security
from hypervisor_tpu.tables.metrics import MetricsTable as JaxMetricsTable
from hypervisor_tpu.tables.state import AgentTable as JaxAgentTable
from hypervisor_tpu.tables.state import ElevationTable as JaxElevationTable
from hypervisor_tpu_torch import config as port_config
from hypervisor_tpu_torch import u32
from hypervisor_tpu_torch.observability import metrics as port_schema
from hypervisor_tpu_torch.ops import gateway as port_gateway
from hypervisor_tpu_torch.ops import rate_limit as port_rate
from hypervisor_tpu_torch.ops import rings as port_rings
from hypervisor_tpu_torch.ops import security_ops as port_security
from hypervisor_tpu_torch.tables.metrics import MetricsTable
from hypervisor_tpu_torch.tables.state import (
    AF32_BD_BREAKER_UNTIL,
    AF32_QUARANTINE_UNTIL,
    AF32_RL_STAMP,
    AF32_RL_TOKENS,
    AF32_SIGMA_EFF,
    AF32_SIGMA_RAW,
    AI32_BD_WIN_START,
    AI32_DID,
    AI32_FLAGS,
    AI32_SESSION,
    AI32_WIDTH,
    BD_BUCKETS,
    FLAG_ACTIVE,
    FLAG_BREAKER_TRIPPED,
    FLAG_QUARANTINED,
    AgentTable,
    ElevationTable,
)

N = 24
NOW = 125.0
_LANES = ("verdict", "ring_status", "eff_ring", "sigma_eff", "severity", "anomaly_rate",
          "window_calls", "tripped")
_JAX_CHECK = jax.jit(jax_gateway.check_actions, static_argnames=("breach", "rate_limit", "trust"))


def _agents(rng) -> dict[str, np.ndarray]:
    """Random live rows: rings 0-3, sigma, tokens, stamps, breaker
    deadlines around now and breach windows whose epochs straddle the
    sliding window's edge."""
    f32 = np.zeros((N, 8), np.float32)
    f32[:, AF32_SIGMA_RAW] = rng.uniform(0, 1, N)
    f32[:, AF32_SIGMA_EFF] = rng.uniform(0.3, 1, N)
    f32[:, AF32_RL_TOKENS] = np.where(rng.uniform(size=N) < 0.5, rng.uniform(0, 2.5, N),
                                      rng.uniform(0, 40, N))
    f32[:, AF32_RL_STAMP] = rng.uniform(NOW - 3, NOW, N)
    f32[:, AF32_BD_BREAKER_UNTIL] = rng.uniform(NOW - 20, NOW + 20, N)
    f32[:, AF32_QUARANTINE_UNTIL] = rng.uniform(NOW, NOW + 60, N)
    i32 = np.zeros((N, AI32_WIDTH), np.int32)
    i32[:, AI32_DID] = np.arange(N)
    i32[:, AI32_SESSION] = rng.randint(0, 4, N)
    i32[:, AI32_FLAGS] = FLAG_ACTIVE | (rng.uniform(size=N) < 0.15) * FLAG_QUARANTINED \
        | (rng.uniform(size=N) < 0.2) * FLAG_BREAKER_TRIPPED
    k = BD_BUCKETS
    cur = int(np.floor(np.float32(NOW) / np.float32(10.0)))
    w = AI32_BD_WIN_START
    i32[:, w:w + k] = rng.randint(0, 5, (N, k))
    i32[:, w + k:w + 2 * k] = rng.randint(0, 3, (N, k))
    i32[:, w + 2 * k:w + 3 * k] = cur - rng.randint(-1, 9, (N, k))
    ring = rng.randint(0, 4, N).astype(np.int8)
    return {"f32": f32, "i32": i32, "ring": ring}


def _elevations(rng, m=8) -> dict[str, np.ndarray]:
    return {
        "agent": np.where(rng.uniform(size=m) < 0.8, rng.randint(0, N + 3, m), -1).astype(np.int32),
        "granted_ring": rng.randint(0, 4, m).astype(np.int8),
        "expires_at": rng.uniform(NOW - 10, NOW + 10, m).astype(np.float32),
        "active": rng.uniform(size=m) < 0.7,
    }


def _actions(rng, b, n_valid) -> dict[str, np.ndarray]:
    return {
        "slot": rng.randint(0, N, b).astype(np.int32),
        "required_ring": np.where(rng.uniform(size=b) < 0.25, 0, rng.randint(0, 4, b)).astype(np.int8),
        "is_read_only": rng.uniform(size=b) < 0.3,
        "has_consensus": rng.uniform(size=b) < 0.5,
        "has_sre_witness": rng.uniform(size=b) < 0.3,
        "host_tripped": rng.uniform(size=b) < 0.05,
        "valid": np.arange(b) < n_valid,
    }


_ARGS = ("slot", "required_ring", "is_read_only", "has_consensus", "has_sre_witness",
         "host_tripped")


def _run_both(agents, elevs, acts, now, breach, rate):
    jm = JaxMetricsTable.create(*jax_schema.REGISTRY.counts(), jax_schema.DEFAULT_BUCKET_BOUNDS_US)
    jres = _JAX_CHECK(
        JaxAgentTable(**{k: jnp.asarray(v) for k, v in agents.items()}),
        JaxElevationTable(**{k: jnp.asarray(v) for k, v in elevs.items()}),
        *(jnp.asarray(acts[a]) for a in _ARGS), jnp.float32(now),
        valid=jnp.asarray(acts["valid"]), breach=breach, rate_limit=rate, metrics=jm,
    )
    pm = MetricsTable.create(device="cpu")
    pa = AgentTable(**{k: torch.from_numpy(v.copy()) for k, v in agents.items()})
    pres = port_gateway.check_actions(
        pa, ElevationTable(**{k: torch.from_numpy(v.copy()) for k, v in elevs.items()}),
        *(torch.from_numpy(acts[a]) for a in _ARGS), now, valid=torch.from_numpy(acts["valid"]),
        breach=port_config.BreachConfig(**vars(breach)),
        rate_limit=port_config.RateLimitConfig(**vars(rate)), metrics=pm,
    )
    return jres, pres, pa, pm


def _assert_same(jres, pres, pa, pm):
    assert pres.agents is pa
    for f in _LANES:
        want, got = np.asarray(getattr(jres, f)), getattr(pres, f).numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), f
    for col in ("f32", "i32", "ring"):
        want, got = np.asarray(getattr(jres.agents, col)), getattr(pa, col).numpy()
        assert got.tobytes() == want.tobytes(), f"agents.{col}"
    np.testing.assert_array_equal(u32.to_numpy_u32(pm.counters), np.asarray(jres.metrics.counters))
    np.testing.assert_array_equal(pm.gauges.numpy(), np.asarray(jres.metrics.gauges))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("b,n_valid", [(32, 32), (64, 45), (8, 0)])
def test_random_waves_match_reference(seed, b, n_valid):
    rng = np.random.RandomState(seed * 100 + b)
    rate = RateLimitConfig(ring_rates=(100.0, 50.0, 20.0, 5.0) if seed % 2 else (0.0,) * 4,
                           ring_bursts=(200.0, 100.0, 40.0, 10.0))
    breach = BreachConfig(min_calls_for_analysis=3 if seed % 3 == 0 else 5)
    out = _run_both(_agents(rng), _elevations(rng), _actions(rng, b, n_valid), NOW, breach, rate)
    _assert_same(*out)


def test_each_gate_matches_reference():
    """One wave through every gate. Rows: 0 clean ring 2; 1 a prober whose
    window already holds 4 privileged calls of 4 (its first probe trips
    the breaker, so its later actions are refused); 2 breaker live on the
    device; 3 quarantined (a write refused, a read passes); 4 a bucket of
    2.4 tokens under four writes; 5 ring 2 with a live sudo grant to ring
    0 (its ring-0 action needs only the witness); 6 a lapsed breaker
    (released); 7 tripped on the host; lanes past 11 are padding."""
    rng = np.random.RandomState(7)
    agents = _agents(rng)
    f32, i32 = agents["f32"], agents["i32"]
    agents["ring"][:8] = 2
    f32[:8, AF32_SIGMA_EFF] = 0.8
    f32[:8, AF32_RL_TOKENS] = 40.0
    f32[:8, AF32_RL_STAMP] = NOW
    i32[:8, AI32_FLAGS] = FLAG_ACTIVE
    k, w = BD_BUCKETS, AI32_BD_WIN_START
    i32[:8, w:w + 3 * k] = 0
    cur = int(np.floor(np.float32(NOW) / np.float32(10.0)))
    i32[1, w + (cur % k)], i32[1, w + k + (cur % k)], i32[1, w + 2 * k + (cur % k)] = 4, 4, cur
    i32[2, AI32_FLAGS] |= FLAG_BREAKER_TRIPPED
    f32[2, AF32_BD_BREAKER_UNTIL] = NOW + 5
    i32[3, AI32_FLAGS] |= FLAG_QUARANTINED
    f32[4, AF32_RL_TOKENS] = 2.4
    i32[6, AI32_FLAGS] |= FLAG_BREAKER_TRIPPED
    f32[6, AF32_BD_BREAKER_UNTIL] = NOW - 1
    elevs = {"agent": np.array([5, -1], np.int32), "granted_ring": np.array([0, 1], np.int8),
             "expires_at": np.array([NOW + 30, NOW + 30], np.float32),
             "active": np.array([True, False])}
    slots = [0, 1, 1, 1, 2, 3, 3, 4, 4, 4, 4, 5, 6, 7, 0, 0]
    b = len(slots)
    acts = {
        "slot": np.array(slots, np.int32),
        "required_ring": np.array([2, 0, 2, 2, 2, 2, 3, 2, 2, 2, 2, 0, 2, 2, 2, 2], np.int8),
        "is_read_only": np.array([False] * 6 + [True] + [False] * 9),
        "has_consensus": np.zeros(b, bool),
        "has_sre_witness": np.array([False] * 11 + [True] + [False] * 4),
        "host_tripped": np.array([False] * 13 + [True] + [False] * 2),
        "valid": np.arange(b) < 12 + 2,
    }
    acts["valid"][12:14] = True
    acts["valid"][14:] = False
    jres, pres, pa, pm = _run_both(agents, elevs, acts, NOW, BreachConfig(),
                                   RateLimitConfig(ring_rates=(0.0,) * 4))
    _assert_same(jres, pres, pa, pm)
    v = pres.verdict.tolist()
    G = port_gateway
    assert v[0] == G.GATE_ALLOWED
    assert v[1] == G.GATE_RING and bool(pres.tripped[1])      # the probe that trips
    assert v[2] == v[3] == G.GATE_BREAKER                     # refused after the trip
    assert v[4] == G.GATE_BREAKER                             # live on the device
    assert v[5] == G.GATE_QUARANTINED and v[6] == G.GATE_ALLOWED
    assert v[7:11] == [G.GATE_ALLOWED, G.GATE_ALLOWED, G.GATE_RATE, G.GATE_RATE]
    assert v[11] == G.GATE_ALLOWED and int(pres.eff_ring[11]) == 0
    assert v[12] == G.GATE_ALLOWED and not pa.flags[6] & FLAG_BREAKER_TRIPPED
    assert v[13] == G.GATE_BREAKER                            # the host plane's trip
    assert v[14:] == [G.GATE_INVALID] * 2
    assert pa.flags[1] & FLAG_BREAKER_TRIPPED
    counters = u32.to_numpy_u32(pm.counters)
    assert counters[port_schema.GATEWAY_ALLOWED.index] == 6
    assert counters[port_schema.GATEWAY_DENIED.index] == 8


def test_row_adds_are_exact_in_any_order():
    """The gateway's one scatter-add sums 0/1 values in f32 per row: the
    counts are integers below 2^24, so any order of the adds (CUDA's
    atomics) gives the same bits. 4,097 actions on one row, the adds in
    a shuffled order, equal the in-order sum and the count."""
    rng = np.random.RandomState(3)
    vals = (rng.uniform(size=(4097, 4)) < 0.6).astype(np.float32)
    rows = torch.zeros((2, 4), dtype=torch.float32)
    rows.index_add_(0, torch.zeros(4097, dtype=torch.int64), torch.from_numpy(vals))
    perm = rng.permutation(4097)
    shuffled = torch.zeros((2, 4), dtype=torch.float32)
    shuffled.index_add_(0, torch.zeros(4097, dtype=torch.int64), torch.from_numpy(vals[perm]))
    assert rows.numpy().tobytes() == shuffled.numpy().tobytes()
    np.testing.assert_array_equal(rows.numpy()[0], vals.sum(axis=0, dtype=np.int64))


def test_segment_prefix_matches_reference():
    """The per-slot prefix sums in wave order, on many duplicate slots
    (the stable sort keeps wave order within a slot)."""
    rng = np.random.RandomState(11)
    slot = rng.randint(0, 5, 200).astype(np.int32)
    vals = rng.randint(0, 3, 200).astype(np.int32)
    want = jax_gateway._segment_prefix(jnp.asarray(slot), jnp.asarray(vals))
    ((incl, excl),) = port_gateway._segment_prefix_many(
        port_gateway._segment_layout(torch.from_numpy(slot)), (torch.from_numpy(vals),))
    np.testing.assert_array_equal(incl.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(excl.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("seed", range(3))
def test_security_window_and_rings_match_reference(seed):
    """The breach window's totals and commit (late `now` included), the
    effective rings, the refill and the ring check, one by one."""
    rng = np.random.RandomState(seed)
    agents = _agents(rng)
    elevs = _elevations(rng)
    win = agents["i32"][:, AI32_BD_WIN_START:]
    for now in (NOW, NOW - 25.0, NOW + 61.0):
        jt = jax_security.window_totals(jnp.asarray(win), jnp.float32(now))
        pt = port_security.window_totals(torch.from_numpy(win), now)
        for a, b in zip(pt, jt):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        calls = rng.randint(0, 3, N).astype(np.int32)
        priv = np.minimum(calls, rng.randint(0, 2, N)).astype(np.int32)
        want = jax_security.window_commit(jnp.asarray(win), jnp.asarray(calls), jnp.asarray(priv),
                                          jnp.float32(now))
        got = port_security.window_commit(torch.from_numpy(win), torch.from_numpy(calls),
                                          torch.from_numpy(priv), now)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        want = jax_security.effective_rings(
            jnp.asarray(agents["ring"]), JaxElevationTable(**{k: jnp.asarray(v) for k, v in elevs.items()}),
            jnp.float32(now))
        got = port_security.effective_rings(
            torch.from_numpy(agents["ring"]),
            ElevationTable(**{k: torch.from_numpy(v) for k, v in elevs.items()}), now)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    from hypervisor_tpu.ops import rate_limit as jax_rate
    from hypervisor_tpu.ops import rings as jax_rings

    f32 = agents["f32"]
    want = jax_rate.refill(jnp.asarray(f32[:, AF32_RL_TOKENS]), jnp.asarray(f32[:, AF32_RL_STAMP]),
                           jnp.asarray(agents["ring"]), jnp.float32(NOW))
    got = port_rate.refill(torch.from_numpy(f32[:, AF32_RL_TOKENS].copy()),
                           torch.from_numpy(f32[:, AF32_RL_STAMP].copy()),
                           torch.from_numpy(agents["ring"]), NOW)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    req = rng.randint(0, 4, N).astype(np.int8)
    sig = np.where(rng.uniform(size=N) < 0.3, np.float32(0.95), f32[:, AF32_SIGMA_EFF]).astype(np.float32)
    cons, wit = rng.uniform(size=N) < 0.5, rng.uniform(size=N) < 0.5
    want = jax_rings.ring_check(jnp.asarray(agents["ring"]), jnp.asarray(req), jnp.asarray(sig),
                                jnp.asarray(cons), jnp.asarray(wit))
    got = port_rings.ring_check(torch.from_numpy(agents["ring"]), torch.from_numpy(req),
                                torch.from_numpy(sig), torch.from_numpy(cons), torch.from_numpy(wit))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
