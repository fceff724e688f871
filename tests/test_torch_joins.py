"""The port's join queue against the reference's, on the CPU.

Each case runs one seeded sequence of `enqueue_join` / `flush_joins` (and
the calls around them) on the JAX package's `HypervisorState` (unarmed:
`HV_WAVE_PALLAS=0`) and on the port's `HypervisorState(device="cpu")`,
where `flush_joins` reaches kernel B4's plain version through its wrapper
in the no-contribution form. The cases mirror
`tests/parity/test_admission.py` (a wave, an untrustworthy lane held to ring 3,
a duplicate across waves, capacity within one wave, a rank that skips
rejected lanes, a bad session state, a multi-session wave, the 8,192
wave) and add bucket padding, sigma's edge values, `last_join_results`,
`leave_agent` with a rejoin, and the accessors.

Held equal bit for bit (tolerance 0) after every step: the returned
statuses and views; the agents, sessions, vouch and elevation tables; the
whole metrics table (counters, gauges, histograms and their sums); the
trace ring's words and cursor; and the host indices (membership keys,
`_slot_of_member`, the free lists and cursors, the staging bookkeeping,
`last_join_results`). Trace ids are made deterministic by patching
`secrets.token_hex`. The thread-safety case runs on the port alone and
checks the tables and host indices against each other.
"""

from __future__ import annotations

import itertools
import secrets
import sys
import threading

import numpy as np
import pytest
import torch

from hypervisor_tpu import config as jax_config
from hypervisor_tpu import models as jax_models
from hypervisor_tpu.ops import admission as jax_admission
from hypervisor_tpu.runtime.checkpoint import state_arrays
from hypervisor_tpu.state import HypervisorState as JaxState
from hypervisor_tpu_torch import config as port_config
from hypervisor_tpu_torch import models as port_models
from hypervisor_tpu_torch import tables as port_tables
from hypervisor_tpu_torch.kernels import wave
from hypervisor_tpu_torch.ops import admission
from hypervisor_tpu_torch.runtime import StagingQueue
from hypervisor_tpu_torch.state import HypervisorState as PortState
from hypervisor_tpu_torch.tables.state import FLAG_ACTIVE
from hypervisor_tpu_torch.tables.state import AgentTable as PAgents
from hypervisor_tpu_torch.tables.state import SessionTable as PSessions

CAP = dict(max_agents=24, max_sessions=8, max_vouch_edges=8, max_sagas=4,
           max_steps_per_saga=2, max_elevations=6, delta_log_capacity=8,
           event_log_capacity=8, trace_log_capacity=32)
_TABLES = ("agents", "sessions", "vouches", "elevations")
_METRICS = ("counters", "gauges", "hist", "hist_sum", "bounds")


def snapshot(st) -> dict:
    """The state's tables, metrics and trace ring as numpy arrays (u32
    words as uint32), either package."""
    if isinstance(st, JaxState):
        out = {k: v for k, v in state_arrays(st).items() if k.split(".")[0] in _TABLES}
        out.update({f"metrics.{c}": np.array(getattr(st.metrics.table, c)) for c in _METRICS})
        out["trace.words"] = np.array(st.tracer.table.words)
        out["trace.cursor"] = np.array(st.tracer.table.cursor)
        return out
    out = port_tables.to_state_arrays(port_tables.StateTables(
        st.agents, st.sessions, st.vouches, st.metrics.table, elevations=st.elevations))
    out = {k: np.array(v, copy=True) for k, v in out.items()}
    out["trace.words"] = st.tracer.table.words.numpy().view(np.uint32).copy()
    out["trace.cursor"] = st.tracer.table.cursor.numpy().copy()
    return out


def host_indices(st) -> dict:
    return {
        "members": sorted(st._members),
        "slot_of_member": sorted(st._slot_of_member.items()),
        "free_agent_slots": list(st._free_agent_slots),
        "free_edge_slots": list(st._free_edge_slots),
        "free_elev_slots": list(st._free_elev_slots),
        "scrubbed_edges": list(st._scrubbed_edges),
        "staged_members": sorted(st._staged_members),
        "pending_rows": sorted(st._pending_rows.items()),
        "last_join_results": sorted(st.last_join_results.items()),
        "cursors": (st._next_agent_slot, st._next_session_slot, st._next_edge_slot,
                    st._next_elev_slot),
    }


def make_states(**cap) -> tuple[JaxState, PortState]:
    cfg = {**CAP, **cap}
    ref = JaxState(jax_config.HypervisorConfig(capacity=jax_config.TableCapacity(**cfg)))
    port = PortState(port_config.HypervisorConfig(capacity=port_config.TableCapacity(**cfg)),
                     device="cpu")
    return ref, port


def models_of(st):
    return jax_models if isinstance(st, JaxState) else port_models


def as_host(value):
    """A returned value in comparable form (arrays as numpy, tensors too)."""
    if isinstance(value, torch.Tensor):
        return value.numpy().copy()
    if isinstance(value, tuple):
        return tuple(as_host(v) for v in value)
    return value


def run_both(sequence, monkeypatch, **cap) -> tuple[list, list]:
    """Run `sequence(st, models, record)` on a reference and a port state;
    `record(label, value)` logs a value plus both states' tables and host
    indices. Returns the two logs."""
    monkeypatch.setenv("HV_WAVE_PALLAS", "0")
    monkeypatch.delenv("HV_TRACE", raising=False)
    monkeypatch.delenv("HV_TRACE_SAMPLE", raising=False)
    logs = []
    for st in make_states(**cap):
        counter = itertools.count()
        monkeypatch.setattr(secrets, "token_hex",
                            lambda nbytes=None, c=counter: f"{next(c):0{2 * nbytes}x}")
        log: list = []

        def record(label, value=None, st=st, log=log):
            log.append((label, as_host(value)))
            log.append((label + ":tables", snapshot(st)))
            log.append((label + ":host", host_indices(st)))

        sequence(st, models_of(st), record)
        logs.append(log)
    return logs[0], logs[1]


def assert_same(label, got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), label
        for key, w in want.items():
            assert_same(f"{label} {key}", got[key], w)
    elif isinstance(want, np.ndarray):
        g = np.asarray(got)
        assert g.dtype == want.dtype and g.shape == want.shape, (label, g.dtype, want.dtype)
        assert g.tobytes() == want.tobytes(), f"{label} diverged"
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), label
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(f"{label}[{i}]", g, w)
    elif isinstance(want, float):
        assert isinstance(got, float), label
        assert np.float64(got).tobytes() == np.float64(want).tobytes(), label  # NaN, -0.0
    else:
        assert got == want, label


def assert_logs_equal(ref_log, port_log) -> dict:
    assert [k for k, _ in port_log] == [k for k, _ in ref_log]
    for (label, want), (_, got) in zip(ref_log, port_log):
        assert_same(label, got, want)
    return dict(port_log)


# ── the cases of tests/parity/test_admission.py ──────────────────────


def _wave_of_joins(st, m, record):
    s = st.create_session("session:a", m.SessionConfig(), now=0.0)
    st.enqueue_join(s, "did:hi", 0.9)
    st.enqueue_join(s, "did:mid", 0.7)
    st.enqueue_join(s, "did:lo", 0.2)
    record("flush", st.flush_joins(now=1.0))
    record("views", (st.participant_count(s), st.agent_row("did:hi"), st.agent_row("did:lo")))


def _untrustworthy(st, m, record):
    s = st.create_session("session:a", m.SessionConfig(), now=0.0)
    st.enqueue_join(s, "did:sus", 0.9, trustworthy=False)
    record("flush", st.flush_joins())
    record("row", st.agent_row("did:sus"))


def _duplicate_across_waves(st, m, record):
    s = st.create_session("session:a", m.SessionConfig(), now=0.0)
    st.enqueue_join(s, "did:a", 0.8)
    record("flush1", st.flush_joins())
    st.enqueue_join(s, "did:a", 0.8)
    record("flush2", st.flush_joins(now=2.0))
    record("count", st.participant_count(s))


def _capacity_in_one_wave(st, m, record):
    s = st.create_session("session:a", m.SessionConfig(max_participants=2), now=0.0)
    for i in range(4):
        st.enqueue_join(s, f"did:a{i}", 0.8)
    record("flush", st.flush_joins())
    record("count", st.participant_count(s))


def _rank_skips_rejected(st, m, record):
    s = st.create_session("session:a", m.SessionConfig(max_participants=2), now=0.0)
    st.enqueue_join(s, "did:a", 0.8)
    record("flush1", st.flush_joins())
    st.enqueue_join(s, "did:a", 0.8)
    st.enqueue_join(s, "did:b", 0.8)
    record("flush2", st.flush_joins())
    record("count", st.participant_count(s))


def _bad_session_state(st, m, record):
    s = st.create_session("session:a", m.SessionConfig(), now=0.0)
    st.set_session_state(s, m.SessionState.ARCHIVED)
    st.enqueue_join(s, "did:a", 0.8)
    record("flush", st.flush_joins())


def _multi_session_wave(st, m, record):
    s1 = st.create_session("session:1", m.SessionConfig(max_participants=1), now=0.0)
    s2 = st.create_session("session:2", m.SessionConfig(), now=0.0)
    st.enqueue_join(s1, "did:a", 0.8)
    st.enqueue_join(s2, "did:b", 0.8)
    st.enqueue_join(s1, "did:c", 0.8)
    record("flush", st.flush_joins())
    record("counts", (st.participant_count(s1), st.participant_count(s2)))


OK, BAD, DUP, CAP_, LOW = (admission.ADMIT_OK, admission.ADMIT_BAD_STATE,
                           admission.ADMIT_DUPLICATE, admission.ADMIT_CAPACITY,
                           admission.ADMIT_SIGMA_LOW)
ADMISSION_CASES = {
    "wave_of_joins": (_wave_of_joins, {"flush": [OK] * 3}),
    "untrustworthy_held_to_ring_3": (_untrustworthy, {"flush": [OK]}),
    "duplicate_across_waves": (_duplicate_across_waves, {"flush1": [OK], "flush2": [DUP]}),
    "capacity_within_one_wave": (_capacity_in_one_wave, {"flush": [OK, OK, CAP_, CAP_]}),
    "capacity_rank_skips_rejected": (_rank_skips_rejected, {"flush2": [DUP, OK]}),
    "bad_session_state": (_bad_session_state, {"flush": [BAD]}),
    "multi_session_wave": (_multi_session_wave, {"flush": [OK, OK, CAP_]}),
}


@pytest.mark.parametrize("case", sorted(ADMISSION_CASES))
def test_admission_case_matches_reference(case, monkeypatch):
    sequence, statuses = ADMISSION_CASES[case]
    port = assert_logs_equal(*run_both(sequence, monkeypatch))
    for label, want in statuses.items():
        assert port[label].tolist() == want, label
    assert jax_admission.ADMIT_CAPACITY == CAP_ and jax_admission.ADMIT_SIGMA_LOW == LOW
    if case == "wave_of_joins":
        count, hi, lo = port["views"]
        assert count == 3 and hi["ring"] == 2 and lo["ring"] == 3  # ring 3: exempt from the floor
    if case == "untrustworthy_held_to_ring_3":
        assert port["row"]["ring"] == 3


def _bulk_wave(st, m, record):
    sessions = [st.create_session(f"session:{i}", m.SessionConfig(max_participants=64), now=0.0)
                for i in range(256)]
    for i in range(8192):
        st.enqueue_join(sessions[i % 256], f"did:bulk{i}", 0.8)
    record("flush", st.flush_joins(now=3.0))
    record("count", st.participant_count(sessions[0]))


def test_8192_wave_matches_reference(monkeypatch):
    port = assert_logs_equal(*run_both(
        _bulk_wave, monkeypatch, max_agents=8192, max_sessions=256))
    assert len(port["flush"]) == 8192 and (port["flush"] == OK).all()
    assert port["count"] == 32


# ── beyond test_admission.py ─────────────────────────────────────────


def _padded(st, m, record):
    crowd = st.create_session("session:crowd", m.SessionConfig(max_participants=3), now=0.0)
    floor = st.create_session("session:floor", m.SessionConfig(min_sigma_eff=0.9), now=0.0)
    for i in range(5):
        st.enqueue_join(crowd, f"did:c{i}", 0.7 + 0.05 * i, trustworthy=i != 1)
    st.enqueue_join(floor, "did:f0", 0.8)
    st.enqueue_join(crowd, "did:c0", 0.7)  # a same-wave duplicate of lane 0
    record("flush_padded", st.flush_joins(now=4.0, pad_to=16))
    st.enqueue_join(floor, "did:f1", 0.95)
    record("flush_exact_bucket", st.flush_joins(now=5.0, pad_to=1))
    for i in range(3):
        st.enqueue_join(floor, f"did:g{i}", 0.95)
    with pytest.raises(ValueError, match="below the staged wave size"):
        st.flush_joins(pad_to=2)
    record("after_refusal")


def test_padded_flush_matches_reference(monkeypatch):
    port = assert_logs_equal(*run_both(_padded, monkeypatch))
    assert port["flush_padded"].tolist() == [OK, OK, OK, CAP_, CAP_, LOW, DUP]
    counters = port["flush_padded:tables"]["metrics.counters"]
    assert counters.any()  # the admitted and refused counters rode the padded wave


def _sigma_edges(st, m, record):
    s = st.create_session("session:edge", m.SessionConfig(min_sigma_eff=0.0), now=0.0)
    values = np.array([-0.0, 0.0, 1.5, np.nan, 1e-42, 0.61, np.inf, -1.0], np.float32)
    for i, v in enumerate(values):
        st.enqueue_join(s, f"did:e{i}", float(v))
    record("flush", st.flush_joins(now=6.0))
    record("rows", [st.agent_row(f"did:e{i}", s) for i in range(len(values))])


def test_sigma_edge_lanes_keep_sigma_raw_bit_for_bit(monkeypatch):
    port = assert_logs_equal(*run_both(_sigma_edges, monkeypatch))
    f32 = port["flush:tables"]["agents.f32"]
    raw, eff = f32[:8, 0].view(np.uint32), f32[:8, 1].view(np.uint32)
    assert raw.tobytes() == eff.tobytes()  # no clamp to 1, -0.0 stays -0.0
    assert eff[0] == 0x80000000 and f32[2, 1] == np.float32(1.5)


def _same_wave_pair(st, m, record):
    s = st.create_session("session:pair", m.SessionConfig(max_participants=4), now=0.0)
    t = st.create_session("session:full", m.SessionConfig(max_participants=1), now=0.0)
    st.enqueue_join(t, "did:x", 0.8)
    st.enqueue_join(s, "did:p", 0.8)
    st.enqueue_join(s, "did:p", 0.8)  # staged duplicate: refused, the key admitted
    st.enqueue_join(t, "did:y", 0.8)  # capacity
    record("flush", st.flush_joins())
    record("results", dict(st.last_join_results))
    st.enqueue_join(s, "did:p", 0.8)
    record("flush_again", st.flush_joins())


def test_last_join_results_match_reference(monkeypatch):
    port = assert_logs_equal(*run_both(_same_wave_pair, monkeypatch))
    assert port["flush"].tolist() == [OK, OK, DUP, CAP_]
    assert sorted(port["results"].values()) == [OK, OK, CAP_]  # best status of the pair
    assert port["flush_again"].tolist() == [DUP]


def _leave_and_rejoin(st, m, record):
    s = st.create_session("session:l", m.SessionConfig(), now=0.0)
    u = st.create_session("session:u", m.SessionConfig(), now=0.0)
    for i in range(3):
        st.enqueue_join(s, f"did:l{i}", 0.8)
    st.enqueue_join(u, "did:l0", 0.8)
    record("flush", st.flush_joins(now=1.0))
    row = st.agent_row("did:l1", s)["slot"]
    other = st.agent_row("did:l0", s)["slot"]
    st.add_vouch(other, row, s, bond=0.2)
    st.add_vouch(row, other, u, bond=0.1)
    st.add_vouch(other, other, u, bond=0.1)  # untouched by the leave
    st.grant_elevation(row, 1, now=1.0, ttl_seconds=50.0)
    st.grant_elevation(other, 1, now=1.0, ttl_seconds=50.0)
    record("before_leave", (st.participant_count(s), st.is_member(s, "did:l1")))
    st.leave_agent(s, "did:l1")
    record("left", (st.participant_count(s), st.is_member(s, "did:l1"),
                    st.agent_row("did:l1", s), st.pop_scrubbed_edges()))
    with pytest.raises(ValueError, match="holds no active device row"):
        st.leave_agent(s, "did:l1")
    st.enqueue_join(s, "did:l3", 0.8)  # takes the freed row
    st.enqueue_join(s, "did:l1", 0.8)  # a rejoin is a duplicate
    record("rejoin", st.flush_joins(now=2.0))
    record("rows", (st.agent_rows("did:l0"), st.agent_row("did:l0"), st.agent_row("did:l3", s)))
    record("regrant", st.grant_elevation(st.agent_row("did:l3", s)["slot"], 1, now=2.0))


def test_leave_agent_and_rejoin_match_reference(monkeypatch):
    port = assert_logs_equal(*run_both(_leave_and_rejoin, monkeypatch))
    assert port["before_leave"] == (3, True)
    count, member, row, scrubbed = port["left"]
    assert count == 2 and member and row is None and scrubbed == [0, 1]
    assert port["rejoin"].tolist() == [OK, DUP]
    assert port["rows"][2]["slot"] == 1  # the next joiner took the freed row
    assert port["regrant"] == 0          # and the freed grant's row


def _accessors(st, m, record):
    s = st.create_session("session:v", m.SessionConfig(), now=0.0)
    st.create_session("session:v2", m.SessionConfig(), now=0.0)
    st.enqueue_join(s, "did:v", 0.8)
    record("flush", st.flush_joins(now=1.0))
    st._slot_of_member.clear()  # the scan path, which refills the cache
    record("scan", (st.agent_row("did:v", s), st.agent_row("did:v", 1), st.agent_row("did:none"),
                    st.agent_rows("did:none"), st.is_member(s, "did:none")))
    record("ids", (st.session_slot_of("session:v2"), st.session_slot_of("session:none"),
                   st.to_device_time(st._epoch_base + 2.5)))


def test_accessors_match_reference(monkeypatch):
    port = assert_logs_equal(*run_both(_accessors, monkeypatch))
    row, elsewhere, unknown, none_rows, none_member = port["scan"]
    assert row["slot"] == 0 and elsewhere is None and unknown is None
    assert none_rows == [] and not none_member
    assert port["ids"] == (1, None, 2.5)


def _agent_table_full(st, m, record):
    s = st.create_session("session:f", m.SessionConfig(max_participants=64), now=0.0)
    for i in range(st.agents.ring.shape[0]):
        st.enqueue_join(s, f"did:f{i}", 0.8)
    with pytest.raises(RuntimeError, match="agent table full"):
        st.enqueue_join(s, "did:over", 0.8)
    record("flush", st.flush_joins())


def test_agent_table_full_matches_reference(monkeypatch):
    port = assert_logs_equal(*run_both(_agent_table_full, monkeypatch))
    assert (port["flush"] == OK).all()


# ── the staging queue and B4's no-contribution form ──────────────────


def test_staging_queue_push_harvest_and_full_epoch():
    q = StagingQueue(capacity=3)
    assert [q.push(0.5 + i, 10 + i, 20 + i, i != 1) for i in range(3)] == [0, 1, 2]
    assert q.push(9.0, 9, 9) == -1
    n, sigma, agent, session, trust = q.harvest()
    assert n == 3 and sigma.tolist() == [0.5, 1.5, 2.5] and agent.tolist() == [10, 11, 12]
    assert session.tolist() == [20, 21, 22] and trust.tolist() == [1, 0, 1]
    sigma[0] = -1.0  # a copy: the next epoch does not see it
    assert q.push(0.25, 1, 2) == 0 and q.harvest()[1].tolist() == [0.25]
    assert q.harvest()[0] == 0


def test_refused_push_stages_nothing_and_claims_no_row():
    st = PortState(port_config.HypervisorConfig(capacity=port_config.TableCapacity(**CAP)),
                   device="cpu")
    s = st.create_session("session:q", port_models.SessionConfig(), now=0.0)
    st._queue = StagingQueue(capacity=1)
    assert st.enqueue_join(s, "did:a", 0.8) == 0
    assert st.enqueue_join(s, "did:b", 0.8) == -1
    assert st._next_agent_slot == 1 and list(st._pending_rows) == [0]
    assert len(st._staged_members) == 1
    assert st.flush_joins().tolist() == [OK] and st.is_member(s, "did:a")
    assert not st.is_member(s, "did:b")


def test_no_contribution_form_matches_reference_admit_batch(monkeypatch):
    """B4's wrapper with contribution=None against the reference's
    `admit_batch(contribution=None)` on a crowded wave with sigma's edge
    values: statuses, rings, sigma_eff and both tables bit for bit."""
    import jax.numpy as jnp

    from hypervisor_tpu.tables.state import AgentTable, SessionTable
    from hypervisor_tpu.tables.struct import replace as jax_replace

    rng = np.random.RandomState(31)
    n, sc, b = 64, 8, 40
    sessions = SessionTable.create(sc)
    sessions = jax_replace(
        sessions, state=sessions.state.at[:6].set(1).at[6].set(4),
        max_participants=sessions.max_participants.at[:].set(4),
        min_sigma_eff=sessions.min_sigma_eff.at[:].set(0.5).at[:4].set(0.95))
    agents = AgentTable.create(n)
    sigma = rng.uniform(0.2, 1.2, b).astype(np.float32)
    sigma[:5] = [-0.0, np.nan, 1.5, 1e-42, np.inf]
    lanes = dict(slot=rng.permutation(n)[:b].astype(np.int32), did=np.arange(b, dtype=np.int32),
                 session_slot=rng.randint(0, sc, b).astype(np.int32), sigma_raw=sigma,
                 trustworthy=rng.uniform(size=b) > 0.2, duplicate=rng.uniform(size=b) > 0.85)
    ref = jax_admission.admit_batch(agents, sessions, *(jnp.asarray(v) for v in lanes.values()),
                                    2.0, contribution=None)
    p_agents = PAgents(
        **{k: torch.from_numpy(np.array(getattr(agents, k))) for k in ("f32", "i32", "ring")})
    p_sessions = PSessions(
        **{k: torch.from_numpy(np.array(getattr(sessions, k)))
           for k in ("i32", "f32", "enable_audit", "has_nonreversible")})
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in lanes.items()}
    status, ring, sigma_eff = wave.admission_block(
        p_agents, p_sessions, t["slot"], t["did"], t["session_slot"], t["sigma_raw"], None, 0.0,
        t["trustworthy"], t["duplicate"], 2.0)
    for got, want in ((status, ref.status), (ring, ref.ring), (sigma_eff, ref.sigma_eff),
                      (p_agents.f32, ref.agents.f32), (p_agents.i32, ref.agents.i32),
                      (p_agents.ring, ref.agents.ring), (p_sessions.i32, ref.sessions.i32)):
        assert got.numpy().tobytes() == np.asarray(want).tobytes()
    assert {OK, BAD, DUP, CAP_, LOW} <= set(status.tolist())


# ── concurrency ──────────────────────────────────────────────────────


def test_concurrent_producers_and_flusher_keep_the_indices_consistent():
    """Four producer threads stage joins (some memberships staged by two
    threads) while a fifth flushes and a sixth moves rings. Every
    accepted push is harvested exactly once, no membership is admitted
    twice, and the free list, `_slot_of_member`, the membership keys and
    the seat counts agree with the agent table."""
    st = PortState(port_config.HypervisorConfig(capacity=port_config.TableCapacity(
        **{**CAP, "max_agents": 512, "max_sessions": 8})), device="cpu")
    sessions = [st.create_session(f"session:t{i}", port_models.SessionConfig(max_participants=64),
                                  now=0.0) for i in range(8)]
    pushed, harvested = [], []
    done = threading.Event()

    def producer(t):
        for i in range(100):
            k = (t * 100 + i) % 300  # threads 0 and 3 overlap on 0..99
            pushed.append(st.enqueue_join(sessions[k % 8], f"did:t{k}", 0.8))

    def flusher():
        while not done.is_set():
            harvested.append(len(st.flush_joins(now=1.0)))

    def demoter():
        while not done.is_set():
            st.set_agent_ring(0, 3, now=1.0)

    producers = [threading.Thread(target=producer, args=(t,)) for t in range(4)]
    others = [threading.Thread(target=flusher), threading.Thread(target=demoter)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads finely
    try:
        for th in producers + others:
            th.start()
        for th in producers:
            th.join(timeout=120)
        done.set()
        for th in others:
            th.join(timeout=120)
    finally:
        done.set()
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in producers + others)
    harvested.append(len(st.flush_joins(now=1.0)))
    assert all(q >= 0 for q in pushed) and sum(harvested) == len(pushed) == 400
    assert not st._pending_rows and not st._staged_members
    live = (st.agents.flags.numpy() & FLAG_ACTIVE) != 0
    keys = list(zip(st.agents.session.numpy()[live].tolist(), st.agents.did.numpy()[live].tolist()))
    assert len(keys) == len(set(keys)) == len(st._members) == 300  # each membership once
    assert {(s << 32) | d for s, d in keys} == st._members
    assert sorted(st._slot_of_member.values()) == np.nonzero(live)[0].tolist()
    assert all(st.agents.did.numpy()[r] == d and st.agents.session.numpy()[r] == s
               for (d, s), r in st._slot_of_member.items())
    free = st._free_agent_slots
    assert len(free) == len(set(free)) and not live[free].any()
    assert len(free) + int(live.sum()) == st._next_agent_slot
    seats = np.bincount(st.agents.session.numpy()[live], minlength=8)
    assert st.sessions.n_participants.numpy()[:8].tolist() == seats.tolist()
