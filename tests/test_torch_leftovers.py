"""The ops-layer leftovers and two API faults, held to the reference.

The public functions that earlier slices left out of modules they ported
(`ops/liability.{voucher_contribution, contribution_by_agent, sigma_eff,
exposure_by_voucher}`, `ops/rings.{required_rings, should_demote}`,
`ops/session_fsm.session_transition_valid`, `tables/metrics.{bucket_of,
counter_inc, gauge_set}`, `tables/logs.EventLog.count_by_type`) run on the
same inputs in both packages, the port on the CPU, at tolerance 0 (f32
results compared as bits). The reference's own parity cases
(`tests/parity/test_liability_ops.py`, `test_ring_ops.py`,
`test_invariants.py`, `tests/unit/test_metrics.py`) come first, then
seeded cases.

`voucher_contribution` and `exposure_by_voucher` reduce a masked [B, E]
matrix; XLA:CPU sums each row in windows of 32 (a tree of in-order
window sums), and the port adds in that order, so many live edges per
vouchee agree bit for bit too. `contribution_by_agent` is a scatter-add
in edge order, the contribution kernel's order on the card.

Also here: `HypervisorConfig` (every sub-config's fields, their order and
defaults, `replace`) and the `tables` package's exports.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hypervisor_tpu.config as ref_config
import hypervisor_tpu.tables as ref_tables
import hypervisor_tpu_torch.config as port_config
import hypervisor_tpu_torch.tables as port_tables
from hypervisor_tpu.liability import VouchingEngine as RefVouching
from hypervisor_tpu.ops import liability as ref_liab
from hypervisor_tpu.ops import rings as ref_rings
from hypervisor_tpu.ops import session_fsm as ref_fsm
from hypervisor_tpu.tables import logs as ref_logs
from hypervisor_tpu.tables import metrics as ref_mt
from hypervisor_tpu.tables.state import VouchTable as RefVouchTable
from hypervisor_tpu_torch.liability import VouchingEngine as PortVouching
from hypervisor_tpu_torch.ops import liability as port_liab
from hypervisor_tpu_torch.ops import rings as port_rings
from hypervisor_tpu_torch.ops import session_fsm as port_fsm
from hypervisor_tpu_torch.tables import logs as port_logs
from hypervisor_tpu_torch.tables import metrics as port_mt
from hypervisor_tpu_torch.tables.state import VouchTable as PortVouchTable

S = "session:par"


def bits_equal(port: torch.Tensor, ref) -> None:
    got, want = port.cpu().numpy(), np.asarray(ref)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want)


# ── the configuration and the tables package (ROADMAP C.1 items 1, 2) ─


def _config_classes(mod):
    return [mod.HypervisorConfig] + [
        type(getattr(mod.DEFAULT_CONFIG, f.name))
        for f in dataclasses.fields(mod.HypervisorConfig)
    ]


def test_config_fields_order_and_defaults_match_reference():
    ref_classes, port_classes = _config_classes(ref_config), _config_classes(port_config)
    assert [c.__name__ for c in port_classes] == [c.__name__ for c in ref_classes]
    for ref_cls, port_cls in zip(ref_classes, port_classes):
        ref_f, port_f = dataclasses.fields(ref_cls), dataclasses.fields(port_cls)
        assert [f.name for f in port_f] == [f.name for f in ref_f], ref_cls.__name__
    for ref_sub, port_sub in zip(
        (getattr(ref_config.DEFAULT_CONFIG, f.name) for f in dataclasses.fields(ref_config.HypervisorConfig)),
        (getattr(port_config.DEFAULT_CONFIG, f.name) for f in dataclasses.fields(port_config.HypervisorConfig)),
    ):
        assert dataclasses.asdict(port_sub) == dataclasses.asdict(ref_sub), type(ref_sub).__name__
    assert port_config.RetentionPolicy() == port_config.DEFAULT_CONFIG.retention
    assert dataclasses.asdict(port_config.DEFAULT_CONFIG.retention) == {
        "delta_retention_days": 90, "keep_summary_hash_permanently": True,
        "purge_vfs_on_terminate": True}


def test_config_replace_matches_reference():
    def small(mod):
        return mod.DEFAULT_CONFIG.replace(
            capacity=mod.TableCapacity(max_agents=64, max_sessions=64),
            retention=mod.RetentionPolicy(delta_retention_days=7))

    ref, port = small(ref_config), small(port_config)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port_config.DEFAULT_CONFIG.capacity.max_agents == 16_384  # a copy, not a write
    with pytest.raises(TypeError):
        port_config.DEFAULT_CONFIG.replace(bogus=1)


#: Names the port's `tables` package exports beyond the reference's, and
#: why: the port's bridge to and from a reference checkpoint's arrays
#: (`from_state_arrays`, `to_state_arrays`, `StateTables`) and the table
#: types that bridge carries.
PORT_ONLY_TABLE_EXPORTS = {
    "DeltaLog", "ElevationTable", "EventLog", "SagaTable", "StateTables", "TraceLog",
    "from_state_arrays", "to_state_arrays",
}


def test_tables_package_exports_match_reference():
    assert set(ref_tables.__all__) <= set(port_tables.__all__)
    assert set(port_tables.__all__) - set(ref_tables.__all__) == PORT_ONLY_TABLE_EXPORTS
    for name in ref_tables.__all__:
        assert getattr(port_tables, name) is not None, name
    for flag in ("FLAG_ACTIVE", "FLAG_BLACKLISTED", "FLAG_BREAKER_TRIPPED",
                 "FLAG_PROBATIONARY", "FLAG_QUARANTINED"):
        assert getattr(port_tables, flag) == getattr(ref_tables, flag), flag


# ── the liability queries ────────────────────────────────────────────


def both_tables(edges, capacity: int = 8):
    """(ref VouchTable, port VouchTable, ref engine) from one edge list
    (voucher, vouchee, sigma, pct), each engine's own `to_device`."""
    ref, port = RefVouching(), PortVouching()
    for voucher, vouchee, sigma, pct in edges:
        ref.vouch(voucher, vouchee, S, sigma, bond_pct=pct)
        port.vouch(voucher, vouchee, S, sigma, bond_pct=pct)
    return ref.to_device(capacity=capacity), port.to_device(capacity=capacity, device="cpu"), ref


def seeded_tables(seed: int, e: int, n_agents: int, n_sessions: int, live: float = 0.8):
    rng = np.random.default_rng(seed)
    cols = {
        "voucher": rng.integers(-1, n_agents, e).astype(np.int32),
        "vouchee": rng.integers(-1, n_agents, e).astype(np.int32),
        "session": rng.integers(0, n_sessions, e).astype(np.int32),
        "bond_pct": rng.random(e, dtype=np.float32),
        "bond": (rng.random(e, dtype=np.float32) * rng.random(e, dtype=np.float32)).astype(np.float32),
        "active": rng.random(e) < live,
        "expiry": np.where(rng.random(e) < 0.9, np.inf, rng.random(e) * 10).astype(np.float32),
    }
    ref = RefVouchTable(**{k: jnp.asarray(v) for k, v in cols.items()})
    port = PortVouchTable(**{k: torch.from_numpy(np.array(v)) for k, v in cols.items()})
    return ref, port


def test_voucher_contribution_and_exposure_on_the_reference_cases():
    ref_t, port_t, eng = both_tables(
        [("h1", "l", 0.9, 0.2), ("h2", "l", 0.8, 0.3), ("h1", "m", 0.9, 0.1)])
    sess = eng.sessions.lookup(S)
    for vouchee in ("l", "m", "nobody"):
        slot = eng.agents.lookup(vouchee)
        q = [max(slot, 0)] if slot >= 0 else [99]
        want = ref_liab.voucher_contribution(ref_t, jnp.asarray(q, jnp.int32),
                                             jnp.asarray([sess], jnp.int32), now=0.0)
        got = port_liab.voucher_contribution(port_t, torch.tensor(q, dtype=torch.int32),
                                             torch.tensor([sess], dtype=torch.int32), now=0.0)
        bits_equal(got, want)
    ref_t, port_t, eng = both_tables([("h", "a", 0.8, 0.3), ("h", "b", 0.8, 0.2)])
    args = ([eng.agents.lookup("h")], [eng.sessions.lookup(S)])
    want = ref_liab.exposure_by_voucher(ref_t, *(jnp.asarray(a, jnp.int32) for a in args), now=0.0)
    got = port_liab.exposure_by_voucher(port_t, *(torch.tensor(a, dtype=torch.int32) for a in args),
                                        now=0.0)
    bits_equal(got, want)
    assert float(got[0]) == pytest.approx(eng.get_total_exposure("h", S), abs=1e-6)


@pytest.mark.parametrize("seed,e,n_agents", [(1, 70_001, 16), (2, 4_099, 4), (3, 31, 3), (4, 65_536, 64)])
def test_pair_sums_match_reference_with_many_live_edges_per_query(seed, e, n_agents):
    """Thousands of live edges toward each queried vouchee (and from each
    queried voucher): the reduction order decides every last bit."""
    ref_t, port_t = seeded_tables(seed, e, n_agents, n_sessions=2)
    rng = np.random.default_rng(seed + 100)
    q_agent = rng.integers(0, n_agents, 12).astype(np.int32)
    q_sess = rng.integers(0, 2, 12).astype(np.int32)
    for fn in ("voucher_contribution", "exposure_by_voucher"):
        for now in (0.0, 5.0):
            want = getattr(ref_liab, fn)(ref_t, jnp.asarray(q_agent), jnp.asarray(q_sess), now)
            got = getattr(port_liab, fn)(port_t, torch.from_numpy(q_agent), torch.from_numpy(q_sess),
                                         now)
            bits_equal(got, want)
    assert int((port_t.vouchee == int(q_agent[0])).sum()) > 1


@pytest.mark.parametrize("seed,e,n_agents", [(5, 4_096, 64), (6, 65_536, 512), (7, 8, 8)])
def test_contribution_by_agent_and_sigma_eff_match_reference(seed, e, n_agents):
    ref_t, port_t = seeded_tables(seed, e, n_agents, n_sessions=3)
    rng = np.random.default_rng(seed)
    session_of_agent = rng.integers(-1, 3, n_agents).astype(np.int32)
    sigma = rng.random(n_agents, dtype=np.float32)
    for now in (0.0, 5.0):
        want = ref_liab.contribution_by_agent(ref_t, jnp.asarray(session_of_agent), now)
        got = port_liab.contribution_by_agent(port_t, torch.from_numpy(session_of_agent), now)
        bits_equal(got, want)
        for omega in (0.5, 0.35, 1.0):
            bits_equal(port_liab.sigma_eff(torch.from_numpy(sigma), omega, got),
                       ref_liab.sigma_eff(jnp.asarray(sigma), omega, want))


# ── rings and the session FSM ────────────────────────────────────────


def test_should_demote_matches_reference_and_the_enforcer():
    from hypervisor_tpu_torch.models import ExecutionRing
    from hypervisor_tpu_torch.rings import RingEnforcer

    rings = np.array([1, 1, 2, 2, 3, 3], np.int8)
    sigmas = np.array([0.99, 0.5, 0.7, 0.3, 0.1, 0.9], np.float32)
    got = port_rings.should_demote(torch.from_numpy(rings), torch.from_numpy(sigmas))
    bits_equal(got, ref_rings.should_demote(rings, sigmas))
    enforcer = RingEnforcer()
    assert got.tolist() == [enforcer.should_demote(ExecutionRing(int(r)), float(s))
                            for r, s in zip(rings, sigmas)]
    rng = np.random.default_rng(9)
    rings = rng.integers(0, 4, 4_096).astype(np.int8)
    sigmas = rng.random(4_096, dtype=np.float32)
    sigmas[:8] = [0.95, 0.6, np.nextafter(np.float32(0.6), 1), 0.0, 1.0, 0.95, 0.6, 0.5]
    bits_equal(port_rings.should_demote(torch.from_numpy(rings), torch.from_numpy(sigmas)),
               ref_rings.should_demote(rings, sigmas))


def test_required_rings_match_reference_on_every_combination():
    admin, rev, ro = np.meshgrid([False, True], [0, 1, 2, 3], [False, True], indexing="ij")
    admin, rev, ro = admin.ravel(), rev.ravel().astype(np.int8), ro.ravel()
    got = port_rings.required_rings(torch.from_numpy(admin), torch.from_numpy(rev),
                                    torch.from_numpy(ro))
    bits_equal(got, ref_rings.required_rings(jnp.asarray(admin), jnp.asarray(rev), jnp.asarray(ro)))


def test_session_transition_valid_matches_reference_and_the_matrix():
    n = port_fsm.SESSION_TRANSITION_MATRIX.shape[0]
    codes = np.arange(-2, n + 2)
    frm, to = np.meshgrid(codes, codes, indexing="ij")
    frm, to = frm.ravel().astype(np.int8), to.ravel().astype(np.int8)
    got = port_fsm.session_transition_valid(torch.from_numpy(frm), torch.from_numpy(to))
    bits_equal(got, ref_fsm.session_transition_valid(jnp.asarray(frm), jnp.asarray(to)))
    inside = (frm >= 0) & (frm < n) & (to >= 0) & (to < n)
    want = np.zeros(frm.shape, bool)
    want[inside] = port_fsm.SESSION_TRANSITION_MATRIX[frm[inside], to[inside]] == 1
    assert got.numpy().tolist() == want.tolist()


# ── the metrics table and the event log ──────────────────────────────


def _tables():
    from hypervisor_tpu.observability import metrics as ref_mp
    from hypervisor_tpu_torch.observability import metrics as port_mp

    return ref_mp, port_mp, ref_mp.REGISTRY.create_table(), port_mt.MetricsTable.create("cpu")


def test_bucket_of_matches_reference():
    from hypervisor_tpu_torch.observability import metrics as port_mp

    bounds = np.asarray([1.0, 2.0, 4.0, 8.0], np.float32)
    vals = np.asarray([0.5, 1.0, 1.5, 2.0, 8.0, 9.0], np.float32)
    got = port_mt.bucket_of(torch.from_numpy(bounds), torch.from_numpy(vals))
    bits_equal(got, ref_mt.bucket_of(jnp.asarray(bounds), jnp.asarray(vals)))
    assert got.tolist() == [0, 0, 1, 1, 3, 4]
    bounds = np.asarray(port_mp.DEFAULT_BUCKET_BOUNDS_US, np.float32)
    vals = np.random.RandomState(7).uniform(0.1, 4e7, 256).astype(np.float32)
    vals[:4] = bounds[:4]
    bits_equal(port_mt.bucket_of(torch.from_numpy(bounds), torch.from_numpy(vals)),
               ref_mt.bucket_of(jnp.asarray(bounds), jnp.asarray(vals)))
    bits_equal(port_mt.bucket_of(torch.from_numpy(bounds), [3.5, 1e12]),
               ref_mt.bucket_of(jnp.asarray(bounds), jnp.asarray([3.5, 1e12], jnp.float32)))


def test_counter_inc_and_gauge_set_match_reference_in_place():
    ref_mp, port_mp, ref_t, port_t = _tables()
    last = port_mp.N_COUNTERS - 1
    steps = [("inc", ref_mp.WAVE_TICKS.index, 1), ("inc", ref_mp.ADMITTED.index, 7),
             ("inc", last, 2**32 - 2), ("inc", last, 5), ("inc", ref_mp.ADMITTED.index, -3),
             ("gauge", 0, 0.1), ("gauge", 3, 1e9 + 1), ("gauge", 0, -2.5)]
    for kind, idx, val in steps:
        if kind == "inc":
            ref_t = ref_mt.counter_inc(ref_t, idx, val)
            assert port_mt.counter_inc(port_t, idx, val) is None
        else:
            ref_t = ref_mt.gauge_set(ref_t, idx, val)
            assert port_mt.gauge_set(port_t, idx, val) is None
    port_mt.counter_inc(port_t, ref_mp.WAVE_TICKS.index, torch.tensor(4, dtype=torch.int32))
    ref_t = ref_mt.counter_inc(ref_t, ref_mp.WAVE_TICKS.index, jnp.asarray(4, jnp.int32))
    bits_equal(port_t.counters.view(torch.int32), np.asarray(ref_t.counters).view(np.int32))
    bits_equal(port_t.gauges, ref_t.gauges)
    assert int(port_t.counters[last]) == 3  # (2^32 - 2 + 5) mod 2^32
    assert int(port_t.counters[ref_mp.ADMITTED.index]) == 4


def test_event_log_count_by_type_matches_reference():
    rng = np.random.default_rng(3)
    codes = rng.integers(-1, 12, 64).astype(np.int32)
    ref_log = ref_logs.EventLog.create(64)
    ref_log = dataclasses.replace(ref_log, event_type=jnp.asarray(codes))
    port_log = port_logs.EventLog.create(64, "cpu")
    port_log.event_type.copy_(torch.from_numpy(codes))
    for n_types in (12, 8, 16, 1):
        bits_equal(port_log.count_by_type(n_types), ref_log.count_by_type(n_types))
    empty = port_logs.EventLog.create(16, "cpu")
    assert empty.count_by_type(4).tolist() == [0, 0, 0, 0]
