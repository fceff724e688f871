"""The port's slash cascade against the reference's, on the CPU.

* Kernel B8's plain version (`kernels.liability.slash_cascade_plain`) is
  held bit for bit (tolerance 0) against the reference's scatter form
  `ops.liability.slash_cascade` in sigma, slashed, clipped, wave_of and
  the active column, on `random_graph`'s graphs from
  `tests/parity/test_liability_pallas.py` (seeds 0-4, omega 0.95 and
  0.6, 1-3 sessions, expired edges) and on one graph of 10,000 agents x
  8,192 edges; and against the kernel's dense matmul twin
  `slash_cascade_dense`, also with tolerance 0 on sigma (the reference
  holds its own twin to rtol 1e-5; on these graphs the bits agree).
* The plain version's SLASHED / CLIPPED tallies, and the whole metrics
  table `ops.liability.slash_cascade` leaves, equal the reference's from
  counters seeded at 0xFFFFFFF0 (the u32 wrap).
* The clip factor (the host libm's powf, subnormals flushed, tabled per
  omega) against the reference's `jnp.power` over a 4,001-point omega
  grid at k = 0..64, at k up to 65,536 and in the clipped sigma; the
  table's length; the wipe threshold.
* The facade: `add_vouch`, `release_vouch`, `free_edge_rows`,
  `apply_slash` (a cascade that reaches depth 2) and `blacklist_rows` on
  the JAX package's `HypervisorState` and the port's, with the agents
  and vouches tables, the returned lists, the metrics counters and the
  TraceLog words equal after every step.
"""

from __future__ import annotations

import dataclasses
import itertools
import secrets

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervisor_tpu import config as jax_config
from hypervisor_tpu.kernels.liability_pallas import slash_cascade_dense
from hypervisor_tpu.observability import metrics as jax_schema
from hypervisor_tpu.ops.liability import slash_cascade as jax_slash_cascade
from hypervisor_tpu.runtime.checkpoint import state_arrays
from hypervisor_tpu.state import HypervisorState as JaxState
from hypervisor_tpu.tables import metrics as jax_metrics
from hypervisor_tpu.tables.struct import replace as jax_replace
from hypervisor_tpu_torch import config as port_config
from hypervisor_tpu_torch import tables as port_tables
from hypervisor_tpu_torch.kernels import liability as liability_kernels
from hypervisor_tpu_torch.ops import liability as liability_ops
from hypervisor_tpu_torch.state import HypervisorState as PortState
from hypervisor_tpu_torch.tables.metrics import MetricsTable as PortMetrics
from hypervisor_tpu_torch.tables.state import AF32_SIGMA_EFF, AI32_FLAGS, VouchTable
from tests.parity.test_liability_pallas import random_graph

_FIELDS = ("sigma", "active", "slashed", "clipped", "wave_of")


def _port_vouches(v) -> VouchTable:
    return VouchTable(**{f.name: torch.from_numpy(np.array(getattr(v, f.name)))
                         for f in dataclasses.fields(v)})


def _reference_cols(res) -> list[np.ndarray]:
    return [np.asarray(res.sigma), np.asarray(res.vouch.active), np.asarray(res.slashed),
            np.asarray(res.clipped), np.asarray(res.wave_of)]


def _plain(v, sigma, seeds, session, omega, now=0.0):
    return liability_kernels.slash_cascade_plain(
        _port_vouches(v), torch.from_numpy(np.array(sigma)), torch.from_numpy(np.array(seeds)),
        session, omega, now)


def _assert_bits(got, want, label):
    for name, g, w in zip(_FIELDS, got, want):
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, f"{label} {name}"
        assert g.tobytes() == w.tobytes(), f"{label} {name} diverged"


@pytest.mark.parametrize("omega", [0.95, 0.6])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_plain_matches_scatter_op(seed, omega):
    sessions = 1 + seed % 3
    v, sigma, seeds = random_graph(seed=seed, sessions=sessions)
    session = seed % sessions
    want = _reference_cols(jax_slash_cascade(v, sigma, seeds, session, omega, 0.0))
    _assert_bits(_plain(v, sigma, seeds, session, omega), want, f"seed {seed} omega {omega}")
    assert want[3].sum() > 0 and want[4].max() >= 1  # clips, and a cascade past depth 0


def test_plain_matches_scatter_op_at_10k_agents():
    v, sigma, seeds = random_graph(seed=6, n_agents=10_000, n_edges=8192)
    want = _reference_cols(jax_slash_cascade(v, sigma, seeds, 0, 0.95, 0.0))
    _assert_bits(_plain(v, sigma, seeds, 0, 0.95), want, "10k")
    assert want[4].max() == 2


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_plain_matches_dense_twin(seed):
    """Twin rule: B8's plain version and the reference's dense matmul twin
    `slash_cascade_dense` agree bit for bit (tolerance 0, sigma included)."""
    kw = dict(n_agents=64, n_edges=256) if seed == 3 else {}
    v, sigma, seeds = random_graph(seed=seed, **kw)
    omega = 0.6 if seed == 3 else 0.95
    want = _reference_cols(slash_cascade_dense(v, sigma, seeds, 1 if seed == 3 else 0, omega, 0.0))
    _assert_bits(_plain(v, sigma, seeds, 1 if seed == 3 else 0, omega), want, f"dense {seed}")


def test_clip_factor_matches_reference_power_on_cascade_omegas():
    """The clip factor gives the reference's clipped sigma for k up to 64
    at the omegas the cascades here use."""
    rng = np.random.RandomState(1)
    omegas = np.float32([0.95, 0.6, 0.5, 0.3, 0.123, 0.77])
    o, k, s = np.meshgrid(omegas, np.arange(65, dtype=np.float32),
                          rng.uniform(0.05, 1, 200).astype(np.float32), indexing="ij")
    want = np.asarray(jnp.maximum(jnp.asarray(s) * jnp.power(1.0 - jnp.asarray(o), jnp.asarray(k)),
                                  0.05))
    base = 1.0 - torch.from_numpy(o)
    got = torch.maximum(torch.from_numpy(s) * liability_kernels.clip_factor(
        base, torch.from_numpy(k).to(torch.int32)), torch.tensor(np.float32(0.05)))
    assert got.numpy().tobytes() == want.tobytes()
    assert liability_kernels.clip_factor(torch.tensor(0.5), torch.tensor([0, 1, 3])).tolist() == [
        1.0, 0.5, 0.125]


_OMEGA_GRID = np.linspace(0, 1, 4001, dtype=np.float32)


def _reference_factor(omega, k):
    """The reference's clip factor on its CPU run:
    jnp.power(1 - omega, k.astype(f32)) in float32."""
    return np.asarray(jnp.power(1.0 - jnp.asarray(omega), jnp.asarray(k).astype(jnp.float32)))


def _port_factor(omega, k):
    return liability_kernels.clip_factor(1.0 - torch.from_numpy(omega),
                                         torch.from_numpy(k)).numpy()


def test_clip_factor_sweep_matches_reference_power():
    """The clip factor, bit for bit, against the reference's jnp.power:
    k = 0..64 at every omega of a 4,001-point f32 grid over [0, 1]
    (subnormal results included, which the reference flushes to +0.0);
    a geometric set of k up to 65,536 at a few dozen omegas, tiny ones
    among them; and the clipped sigma max(sigma * factor, floor) at
    seeded sigma for k = 1..64."""
    omega, k = np.meshgrid(_OMEGA_GRID, np.arange(65, dtype=np.int32), indexing="ij")
    want = _reference_factor(omega, k)
    got = _port_factor(omega, k)
    assert got.tobytes() == want.tobytes()
    assert (want == 0).sum() > 6000  # the flushed results are part of the sweep

    far_k = np.unique(np.round(np.geomspace(1, 65_536, 48)).astype(np.int32))
    far_omega = np.concatenate([_OMEGA_GRID[::160], np.float32(
        [1e-3, 2.5e-4, 1e-4, 1e-5, 1e-6, 1e-7, 6e-8, 2.0**-24])]).astype(np.float32)
    omega, k = np.meshgrid(far_omega, np.concatenate([far_k, [65_535]]).astype(np.int32),
                           indexing="ij")
    assert _port_factor(omega, k).tobytes() == _reference_factor(omega, k).tobytes()

    rng = np.random.RandomState(3)
    omega, k = np.meshgrid(_OMEGA_GRID, np.arange(1, 65, dtype=np.int32), indexing="ij")
    sigma = rng.uniform(0.3, 1.0, omega.shape).astype(np.float32)
    want = np.asarray(jnp.maximum(jnp.asarray(sigma) * _reference_factor(omega, k), 0.05))
    got = torch.maximum(torch.from_numpy(sigma) * torch.from_numpy(_port_factor(omega, k)),
                        torch.tensor(np.float32(0.05)))
    assert got.numpy().tobytes() == want.tobytes()


def test_factor_table_stops_where_the_factor_stops_changing():
    half = liability_kernels.factor_table(0.5, 1000, "cpu")
    assert half.numel() == 128 and float(half[-1]) == 0.0 and float(half[-2]) > 0.0
    assert liability_kernels.factor_table(1.0, 70_000, "cpu").tolist() == [1.0]
    assert liability_kernels.factor_table(0.0, 10, "cpu").tolist() == [1.0, 0.0]
    tiny = liability_kernels.factor_table(np.float32(1) - np.float32(1e-6), 65_536, "cpu")
    assert tiny.numel() == 65_537 and float(tiny[-1]) > 0.9
    assert liability_kernels.factor_table(0.5, 10, "cpu") is half  # cached, never rebuilt


def test_factor_tables_stay_bounded_when_omega_varies():
    """A caller who varies omega keeps at most FACTOR_TABLES_KEPT tables on
    the host and per device, the least recently used evicted; an evicted
    table is rebuilt with the same bits."""
    kept = liability_kernels.FACTOR_TABLES_KEPT
    first = liability_kernels.factor_table(np.float32(0.25), 64, "cpu").clone()
    for omega in np.linspace(0.01, 0.99, 3 * kept, dtype=np.float32):
        liability_kernels.factor_table(np.float32(1) - omega, 64, "cpu")
        assert len(liability_kernels._host_tables) <= kept
        assert len(liability_kernels._device_tables) <= kept
    last = liability_kernels.factor_table(np.float32(1) - np.float32(0.99), 64, "cpu")
    assert liability_kernels.factor_table(np.float32(1) - np.float32(0.99), 64, "cpu") is last
    assert int(np.float32(0.25).view(np.uint32)) not in liability_kernels._host_tables
    assert liability_kernels.factor_table(np.float32(0.25), 64, "cpu").numpy().tobytes() == (
        first.numpy().tobytes())


def test_wipe_threshold_is_rounded_once():
    trust = port_config.DEFAULT_CONFIG.trust
    wipe = liability_kernels.wipe_threshold(trust)
    assert np.float32(wipe).view(np.int32) == 1031127695
    assert (np.float32(trust.sigma_floor) + np.float32(trust.cascade_wipe_epsilon)).view(
        np.int32) == 1031127696  # a float32 sum lands one ulp higher


def test_cascade_entry_books_metrics_and_leaves_inputs_alone():
    v, sigma, seeds = random_graph(seed=2)
    pv = _port_vouches(v)
    before = pv.active.clone()
    sig = torch.from_numpy(np.array(sigma))
    res = liability_ops.slash_cascade(pv, sig, torch.from_numpy(np.array(seeds)), 0, 0.95, 0.0)
    assert torch.equal(pv.active, before) and torch.equal(sig, torch.from_numpy(np.array(sigma)))
    assert res.metrics is None and res.trace is None
    assert int(res.slashed.sum()) > 0 and not torch.equal(res.vouch.active, before)


COUNTER_SEED = 0xFFFFFFF0  # the cascade's tallies wrap the u32 rows past 2^32


def _seeded_reference_metrics():
    """The reference's metrics table, SLASHED and CLIPPED seeded near 2^32;
    and those counters as the port's int32 bits."""
    seeded = np.zeros(jax_schema.REGISTRY.counts()[0], np.uint32)
    seeded[list(liability_kernels.TALLY_ROWS)] = COUNTER_SEED
    jm = jax_metrics.MetricsTable.create(*jax_schema.REGISTRY.counts(),
                                         jax_schema.DEFAULT_BUCKET_BOUNDS_US)
    return jax_replace(jm, counters=jnp.asarray(seeded)), torch.from_numpy(seeded.view(np.int32))


@pytest.mark.parametrize("seed", [0, 3, 4])
def test_plain_books_the_reference_tallies_through_the_wrap(seed):
    """B8's plain version adds the slashed and clipped counts to the
    counter column it is given, rows SLASHED and CLIPPED, wrapping at
    2^32 as the reference's u32 rows do."""
    sessions = 1 + seed % 3
    v, sigma, seeds = random_graph(seed=seed, sessions=sessions)
    jm, counters = _seeded_reference_metrics()
    res = jax_slash_cascade(v, sigma, seeds, seed % sessions, 0.95, 0.0, metrics=jm)
    counters = counters.clone()
    got = liability_kernels.slash_cascade_plain(
        _port_vouches(v), torch.from_numpy(np.array(sigma)), torch.from_numpy(np.array(seeds)),
        seed % sessions, 0.95, 0.0, counters=counters)
    _assert_bits(got, _reference_cols(res), f"seed {seed}")
    want = np.asarray(res.metrics.counters)
    assert counters.numpy().view(np.uint32).tobytes() == want.tobytes()
    rows = list(liability_kernels.TALLY_ROWS)
    assert want[rows].tolist() == [(COUNTER_SEED + int(got[2].sum())) % 2**32,
                                   (COUNTER_SEED + int(got[3].sum())) % 2**32]
    assert (want[rows] < COUNTER_SEED).all()  # both rows wrapped


def test_cascade_from_wrapping_counters_leaves_the_reference_metrics_table():
    """`ops.liability.slash_cascade` on CPU tensors, SLASHED and CLIPPED
    seeded near 2^32: the whole metrics table byte-identical to the
    reference's."""
    v, sigma, seeds = random_graph(seed=6, n_agents=10_000, n_edges=8192)
    jm, counters = _seeded_reference_metrics()
    res = jax_slash_cascade(v, sigma, seeds, 0, 0.95, 0.0, metrics=jm)
    pm = PortMetrics.create(device="cpu")
    pm.counters.copy_(counters)
    got = liability_ops.slash_cascade(_port_vouches(v), torch.from_numpy(np.array(sigma)),
                                      torch.from_numpy(np.array(seeds)), 0, 0.95, 0.0,
                                      metrics=pm)
    assert got.metrics is pm
    for name in ("counters", "gauges", "hist", "hist_sum", "bounds"):
        port = getattr(pm, name).numpy()
        want = np.asarray(getattr(res.metrics, name))
        assert port.view(want.dtype).tobytes() == want.tobytes(), name


# ── the facade ───────────────────────────────────────────────────────

CAP = dict(max_agents=64, max_sessions=4, max_vouch_edges=48)
N_RANDOM_EDGES = 40


class _Ref:
    def __init__(self):
        self.st = JaxState(jax_config.HypervisorConfig(capacity=jax_config.TableCapacity(
            **CAP, max_sagas=4, max_steps_per_saga=4, max_elevations=4, delta_log_capacity=16,
            event_log_capacity=16, trace_log_capacity=64)))

    def seed_agents(self, sigma, flags, ring):
        a = self.st.agents
        self.st.agents = jax_replace(a, sigma_eff=jnp.asarray(sigma), flags=jnp.asarray(flags),
                                     ring=jnp.asarray(ring))

    def snapshot(self):
        arrays = state_arrays(self.st)
        out = {k: v for k, v in arrays.items() if k.split(".")[0] in ("agents", "vouches")}
        out["metrics.counters"] = np.array(self.st.metrics.table.counters)
        out["trace.words"] = np.array(self.st.tracer.table.words)
        out["free_edge_slots"] = list(self.st._free_edge_slots)
        out["next_edge_slot"] = self.st._next_edge_slot
        return out


class _Port(_Ref):
    def __init__(self):
        self.st = PortState(port_config.HypervisorConfig(
            capacity=port_config.TableCapacity(**CAP, trace_log_capacity=64)), device="cpu")

    def seed_agents(self, sigma, flags, ring):
        a = self.st.agents
        a.f32[:, AF32_SIGMA_EFF] = torch.from_numpy(sigma)
        a.i32[:, AI32_FLAGS] = torch.from_numpy(flags)
        a.ring.copy_(torch.from_numpy(ring))

    def snapshot(self):
        st = self.st
        out = port_tables.to_state_arrays(port_tables.StateTables(st.agents, st.sessions, st.vouches))
        out = {k: v for k, v in out.items() if k.split(".")[0] in ("agents", "vouches")}
        out["metrics.counters"] = st.metrics.table.counters.numpy().view(np.uint32).copy()
        out["trace.words"] = st.tracer.table.words.numpy().view(np.uint32).copy()
        out["free_edge_slots"] = list(st._free_edge_slots)
        out["next_edge_slot"] = st._next_edge_slot
        return out


#: A liability chain in session 0: 11 vouches for 10, 12 for 11, 13 for
#: 12, 14 for 13 — a slash of 10 at omega 0.95 wipes 11 and 12 in turn.
CHAIN = [(11, 10), (12, 11), (13, 12), (14, 13)]


def _run(side) -> list:
    st, log = side.st, []
    rng = np.random.RandomState(31)
    n = CAP["max_agents"]
    side.seed_agents(rng.uniform(0.3, 1.0, n).astype(np.float32),
                     np.full(n, 1, np.int32), np.full(n, 2, np.int8))

    def record(label, value=None):
        log.append((label, value))
        log.append((label + ":state", side.snapshot()))

    rows = [st.add_vouch(a, b, 0, 0.25) for a, b in CHAIN]
    for _ in range(N_RANDOM_EDGES):
        rows.append(st.add_vouch(int(rng.randint(0, n)), int(rng.randint(0, n)),
                                 int(rng.randint(0, 2)), float(rng.uniform(0.05, 0.3)),
                                 bond_pct=0.1, expiry=float(rng.choice([5.0, np.inf]))))
    record("added", rows)
    st.release_vouch(rows[20])
    st.release_vouch(rows[7])
    record("released")
    record("reused", [st.add_vouch(1, 2, 1, 0.1), st.add_vouch(3, 4, 1, 0.2)])
    res = st.apply_slash(0, 10, 0.95, now=1.0)
    record("slash0", res)
    consumed = [r for r in range(CAP["max_vouch_edges"]) if r in rows and r not in (20, 7)]
    st.free_edge_rows(consumed[:3])
    st.blacklist_rows([5, 6, 5])
    record("blacklist")
    record("slash1", st.apply_slash(1, int(rng.randint(0, n)), 0.6, now=10.0))
    record("slash_empty", st.apply_slash(0, 63, 0.5, now=10.0))
    with pytest.raises(RuntimeError, match="vouch table full"):
        for _ in range(CAP["max_vouch_edges"]):
            st.add_vouch(0, 1, 0, 0.1)
    record("full")
    return log


@pytest.fixture(scope="module")
def runs():
    counter = itertools.count()

    def token_hex(nbytes=None):
        return f"{next(counter):0{2 * nbytes}x}"

    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HV_TRACE", raising=False)
        mp.delenv("HV_TRACE_SAMPLE", raising=False)
        mp.setattr(secrets, "token_hex", token_hex)
        ref = dict(_run(_Ref()))
        counter = itertools.count()
        port = dict(_run(_Port()))
    return ref, port


def _assert_same(label, got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), label
        for key, w in want.items():
            _assert_same(f"{label} {key}", got[key], w)
    elif isinstance(want, np.ndarray):
        g = np.asarray(got)
        assert g.dtype == want.dtype and g.shape == want.shape, label
        assert g.tobytes() == want.tobytes(), f"{label} diverged"
    else:
        assert got == want, label


@pytest.mark.parametrize("step", ["added", "released", "reused", "slash0", "blacklist", "slash1",
                                  "slash_empty", "full"])
def test_facade_slash_sequence_matches_reference(runs, step):
    ref, port = runs
    for suffix in ("", ":state"):
        _assert_same(step + suffix, port[step + suffix], ref[step + suffix])


def test_facade_slash_cascade_reaches_depth_two(runs):
    _, port = runs
    assert {10, 11, 12} <= set(port["slash0"]["slashed"])
    assert 13 in port["slash0"]["clipped"]
    assert port["reused"] == [7, 20]  # the released rows, last in first out
    flags = port["slash0:state"]["agents.i32"][:, AI32_FLAGS]
    assert all(flags[a] & 8 for a in (10, 11, 12))
    assert port["blacklist:state"]["agents.ring"][5] == 3
