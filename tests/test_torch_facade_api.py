"""The port's `Hypervisor` facade against the reference's, on the CPU.

Each case runs one seeded sequence through the public async API on the
JAX package's `Hypervisor` (unarmed: `HV_WAVE_PALLAS=0`,
`HV_SHA256_PALLAS=0`) and on the port's, built over
`HypervisorState(device="cpu")`, where every kernel the facade reaches
(B4 in `join_session`, B2 in `terminate_session`'s delta flush, B3 in a
`DeltaEngine` root of 64 deltas or more, B8 in `verify_behavior`'s slash)
runs its plain version through its wrapper. The cases are the
counterparts of `tests/integration/test_e2e_lifecycle.py`,
`test_facade_kill.py`, `test_facade_elevation.py`, `test_ledger_gate.py`,
`test_action_gateway.py` and `test_saga_gateway.py`.

Tolerance 0: after every recorded step the returned value (dataclasses,
enums, floats and exceptions by type and message), the event-bus rows
(`device_rows` and every event's dict), the device tables (agents,
sessions, vouches, sagas, elevations, DeltaLog, EventLog) byte for byte,
the whole device metrics table, the host-plane counters, the trace ring,
the ledger's entries, and the facade's host indices must be equal.

Both facades bridge their health planes onto the bus (capacity,
resilience, integrity and incident events), so the bus rows compared
include them; `testing.same_health_on_every_run` keeps the `recompile`
kind off both buses (the packages count compiles differently, ROADMAP
C.2) and both watchdogs unarmed (their deadlines are wall time). Ids and
times are made deterministic the same way for both packages:
`uuid.uuid4` and `secrets.token_hex` count up from 1, `time.time` and
every module's `datetime.now` read one manual clock that only the
sequence advances (by dyadic steps, so the token refill's product is
exact and the reference's fused multiply-add agrees with the port's
separate roundings, ROADMAP C.2).
"""

from __future__ import annotations

import asyncio
import dataclasses
import datetime as _dt
import enum
import importlib
import itertools
import secrets
import sys
import time
import types
import uuid

import numpy as np
import pytest
import torch

import hypervisor_tpu as REF
import hypervisor_tpu_torch as PORT
from hypervisor_tpu import config as jax_config
from hypervisor_tpu.observability import health as jax_health
from hypervisor_tpu.runtime.checkpoint import state_arrays
from hypervisor_tpu.state import HypervisorState as JaxState
from hypervisor_tpu_torch import config as port_config
from hypervisor_tpu_torch import tables as port_tables
from hypervisor_tpu_torch.observability import health as port_health
from hypervisor_tpu_torch.state import HypervisorState as PortState
from hypervisor_tpu_torch.testing import same_health_on_every_run

CAP = dict(max_agents=40, max_sessions=16, max_vouch_edges=24, max_sagas=4,
           max_steps_per_saga=4, max_elevations=8, delta_log_capacity=192,
           event_log_capacity=48, trace_log_capacity=64)
#: 2026-01-01T00:00:00Z, where the manual clock starts.
T0 = 1_767_225_600.0
_METRICS = ("counters", "gauges", "hist", "hist_sum", "bounds")


# ── determinism ──────────────────────────────────────────────────────


class ManualTime:
    """One clock for `time.time` and every `datetime.now` of both packages."""

    def __init__(self) -> None:
        self.t = T0

    def advance(self, seconds: float) -> None:
        self.t += seconds


def install_determinism(mp: pytest.MonkeyPatch, clock: ManualTime) -> None:
    """Patch ids and time for one package run (counters restart at 1)."""
    ids = itertools.count(1)
    words = itertools.count(1)
    # The count sits in the top and the bottom bits, so ids cut from a
    # uuid's first 8 hex digits (locks, elevations) stay distinct too.
    mp.setattr(uuid, "uuid4", lambda: uuid.UUID(int=(lambda n: n << 96 | n)(next(ids))))
    mp.setattr(secrets, "token_hex",
               lambda nbytes=None: f"{next(words):0{2 * (nbytes or 32)}x}")
    mp.setattr(time, "time", lambda: clock.t)
    # Facades left by earlier tests keep their health monitors subscribed
    # to each package's process-wide compile log until they are
    # collected: a recompile in this run would reach their bus bridges
    # and draw from the patched uuid4.
    mp.setattr(jax_health._LOG, "_subscribers", [])
    mp.setattr(port_health._LOG, "_subscribers", [])

    class ManualDatetime(_dt.datetime):
        @classmethod
        def now(cls, tz=None):
            return cls.fromtimestamp(clock.t, tz)

    for name, mod in list(sys.modules.items()):
        if (name.split(".")[0] in ("hypervisor_tpu", "hypervisor_tpu_torch")
                and getattr(mod, "datetime", None) is _dt.datetime):
            mp.setattr(mod, "datetime", ManualDatetime)


# ── the two sides ────────────────────────────────────────────────────


class Side:
    """One package's API for a sequence: its modules, a facade factory
    over small tables, and the log."""

    def __init__(self, pkg, clock: ManualTime) -> None:
        self.pkg = pkg
        self.clock = clock
        self.facades: list = []
        self.log: list = []

    @property
    def is_ref(self) -> bool:
        return self.pkg is REF

    def mod(self, name: str):
        return importlib.import_module(f"{self.pkg.__name__}.{name}")

    def state(self):
        if self.is_ref:
            return JaxState(jax_config.HypervisorConfig(capacity=jax_config.TableCapacity(**CAP)))
        return PortState(port_config.HypervisorConfig(capacity=port_config.TableCapacity(**CAP)),
                         device="cpu")

    def hypervisor(self, **kw):
        hv = self.pkg.Hypervisor(state=self.state(), **kw)
        if hv.event_bus is not None:
            same_health_on_every_run(hv)
        self.facades.append(hv)
        return hv

    def cmvk(self):
        return self.mod("integrations.cmvk_adapter").CMVKAdapter(verifier=Drift())

    def record(self, label: str, value=None) -> None:
        self.log.append((label, norm(value)))
        for i, hv in enumerate(self.facades):
            self.log.append((f"{label}:hv{i}:tables", tables(hv.state)))
            self.log.append((f"{label}:hv{i}:host", facade_host(hv)))


class Drift:
    """An injected CMVK verifier: the drift score is |claimed - observed|."""

    def verify_embeddings(self, embedding_a, embedding_b, **_):
        return types.SimpleNamespace(drift_score=abs(float(embedding_a) - float(embedding_b)),
                                     explanation=None)


def norm(value):
    """A returned value in comparable form, the same for both packages."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return (type(value).__name__,
                {f.name: norm(getattr(value, f.name)) for f in dataclasses.fields(value)})
    if isinstance(value, enum.Enum):
        return (type(value).__name__, value.value)
    if isinstance(value, _dt.datetime):
        return value.isoformat()
    if isinstance(value, BaseException):
        return ("raised", type(value).__name__, str(value))
    if isinstance(value, dict):
        return {str(k): norm(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, set, frozenset)):
        items = sorted(value, key=repr) if isinstance(value, (set, frozenset)) else value
        return [norm(v) for v in items]
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy().copy()
    if isinstance(value, np.ndarray):
        return value.copy()
    if isinstance(value, np.generic):
        return value.item()
    return value


def tables(st) -> dict:
    """Device tables, metrics, host counters and trace ring as numpy."""
    if isinstance(st, JaxState):
        out = dict(state_arrays(st))
        out.update({f"metrics.{c}": np.array(getattr(st.metrics.table, c)) for c in _METRICS})
        out["host_counters"] = st.metrics._h_counters.copy()
        out["trace.words"] = np.array(st.tracer.table.words)
        out["trace.cursor"] = np.array(st.tracer.table.cursor)
        return out
    out = port_tables.to_state_arrays(port_tables.StateTables(
        st.agents, st.sessions, st.vouches, st.metrics.table, delta_log=st.delta_log,
        sagas=st.sagas, elevations=st.elevations, event_log=st.event_log))
    out["host_counters"] = st.metrics._h_counters.copy()
    out["trace.words"] = st.tracer.table.words.numpy().view(np.uint32).copy()
    out["trace.cursor"] = st.tracer.table.cursor.numpy().copy()
    return out


def facade_host(hv) -> dict:
    """The facade's host indices, its ledger and its event bus."""
    out = {
        "edge_of_vouch": sorted(hv._edge_of_vouch.items()),
        "penalized_in": {k: sorted(v) for k, v in sorted(hv._penalized_in.items())},
        "elev_row_of": sorted(hv._elev_row_of.items()),
        "collusion_charged": sorted(map(repr, hv._collusion_charged)),
        "ledger": norm([hv.ledger.get_agent_history(a) for a in sorted(hv.ledger.tracked_agents)]),
        "kills": norm(hv.kill_switch.kill_history),
        "sessions": {sid: (m.slot, m.sso.state.value, m.delta_engine.turn_count,
                           norm(sorted(m.sso.participants, key=lambda p: p.agent_did)))
                     for sid, m in hv._sessions.items()},
        "members": sorted(hv.state._members),
        "free_agent_slots": list(hv.state._free_agent_slots),
        "free_edge_slots": list(hv.state._free_edge_slots),
        "free_elev_slots": list(hv.state._free_elev_slots),
    }
    if hv.event_bus is not None:
        out["bus_rows"] = list(hv.event_bus.device_rows(0))
        out["bus_events"] = [e.to_dict() for e in hv.event_bus.all_events]
    return out


async def attempt(awaitable):
    """The awaited value, or the exception it raised (compared by type
    and message)."""
    try:
        return await awaitable
    except Exception as exc:  # noqa: BLE001 — the exception is the value here
        return exc


def call(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except Exception as exc:  # noqa: BLE001
        return exc


def run_both(sequence) -> tuple[list, list]:
    logs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HV_WAVE_PALLAS", "0")
        mp.setenv("HV_SHA256_PALLAS", "0")
        mp.setenv("HV_ROOFLINE", "0")
        mp.delenv("HV_TRACE", raising=False)
        mp.delenv("HV_TRACE_SAMPLE", raising=False)
        for pkg in (REF, PORT):
            clock = ManualTime()
            with pytest.MonkeyPatch.context() as side_mp:
                install_determinism(side_mp, clock)
                side = Side(pkg, clock)
                asyncio.run(sequence(side))
            logs.append(side.log)
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
        assert type(got) is type(want) and len(got) == len(want), (label, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(f"{label}[{i}]", g, w)
    elif isinstance(want, float):
        assert isinstance(got, float), (label, got)
        assert np.float64(got).tobytes() == np.float64(want).tobytes(), (label, got, want)
    else:
        assert got == want, (label, got, want)


def assert_logs_equal(ref_log, port_log) -> dict:
    assert [k for k, _ in port_log] == [k for k, _ in ref_log]
    for (label, want), (_, got) in zip(ref_log, port_log):
        assert_same(label, got, want)
    return dict(port_log)


# ── helpers shared by the sequences ──────────────────────────────────


def action(s: Side, ring3: bool = False, **kw):
    """The integration tests' reversible write (`ring3`: read-only)."""
    m = s.pkg
    base = dict(action_id="a1", name="write file", execute_api="/x", undo_api="/undo",
                reversibility=m.ReversibilityLevel.FULL)
    if ring3:
        base.update(is_read_only=True)
    base.update(kw)
    return m.ActionDescriptor(**base)


def admin_action(s: Side):
    return action(s, is_admin=True, undo_api=None, reversibility=s.pkg.ReversibilityLevel.NONE)


async def session_with(s: Side, hv, *joins, **config):
    config.setdefault("min_sigma_eff", 0.0)
    ms = await hv.create_session(s.pkg.SessionConfig(**config), creator_did="did:lead")
    for did, sigma in joins:
        await hv.join_session(ms.sso.session_id, did, sigma_raw=sigma)
    return ms


def change(s: Side, i: int):
    return [s.pkg.VFSChange(path=f"/f{i}.md", operation="add", content_hash=f"{i:064x}")]


# ── tests/integration/test_e2e_lifecycle.py ──────────────────────────


async def lifecycle_readme(s: Side):
    """The README's example: create, joins, a vouch before the vouchee
    joins (backfilled), activate, captures, a saga, terminate."""
    m = s.pkg
    bus = m.HypervisorEventBus()
    hv = s.hypervisor(event_bus=bus)
    ms = await hv.create_session(m.SessionConfig(), creator_did="did:mesh:admin")
    sid = ms.sso.session_id
    s.record("created", (sid, ms.slot))
    rings = [await hv.join_session(sid, f"did:mesh:agent-{i}", sigma_raw=sig)
             for i, sig in enumerate((0.85, 0.62, 0.97))]
    s.record("rings", rings)
    s.record("vouch", hv.vouching.vouch("did:mesh:agent-0", "did:mesh:late", sid,
                                        voucher_sigma=0.85))
    s.record("late", await hv.join_session(sid, "did:mesh:late", sigma_raw=0.7))
    await hv.activate_session(sid)
    deltas = [ms.delta_engine.capture("did:mesh:agent-0", change(s, t)) for t in range(3)]
    s.record("deltas", deltas)
    saga = ms.saga.create_saga(sid)
    ms.saga.DEFAULT_RETRY_DELAY_SECONDS = 0.0
    step = ms.saga.add_step(saga.saga_id, "flaky", "did:mesh:agent-0", "/api/flaky",
                            max_retries=2)
    calls = {"n": 0}

    async def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("boom")
        return "ok"

    s.record("saga", (await ms.saga.execute_step(saga.saga_id, step.step_id, flaky),
                      saga.to_dict()))
    root = await hv.terminate_session(sid)
    s.record("terminated", (root, hv.commitment.verify(sid, root),
                            ms.delta_engine.compute_merkle_root(), ms.delta_engine.verify_chain()))
    s.record("events", hv.sync_events_to_device())


async def lifecycle_admission_edges(s: Side):
    """Ring assignment, the duplicate, capacity, sigma's gate, STRONG
    forcing, audit off, unknown sessions and a leave."""
    m = s.pkg
    hv = s.hypervisor()
    ms = await hv.create_session(m.SessionConfig(max_participants=2), "did:mesh:admin")
    sid = ms.sso.session_id
    s.record("good", await hv.join_session(sid, "did:mesh:good", sigma_raw=0.85))
    s.record("weak", await hv.join_session(sid, "did:mesh:weak", sigma_raw=0.30))
    s.record("duplicate", await attempt(hv.join_session(sid, "did:mesh:good", sigma_raw=0.8)))
    s.record("full", await attempt(hv.join_session(sid, "did:mesh:c", sigma_raw=0.8)))
    s.record("nan", await attempt(hv.join_session(sid, "did:mesh:n", sigma_raw=float("nan"))))
    s.record("above_one", await attempt(hv.join_session(sid, "did:mesh:n", sigma_raw=1.5)))
    s.record("unknown", await attempt(hv.join_session("session:none", "did:x", sigma_raw=0.8)))
    await hv.leave_session(sid, "did:mesh:weak")
    s.record("left", await attempt(hv.leave_session(sid, "did:mesh:weak")))
    strong = await hv.create_session(m.SessionConfig(), "did:mesh:admin")
    deploy = m.ActionDescriptor(action_id="deploy", name="Deploy", execute_api="/api/deploy",
                                reversibility=m.ReversibilityLevel.NONE)
    await hv.join_session(strong.sso.session_id, "did:mesh:a", actions=[deploy], sigma_raw=0.8)
    s.record("strong", strong.sso.consistency_mode)
    quiet = await hv.create_session(m.SessionConfig(enable_audit=False), "did:mesh:admin")
    await hv.join_session(quiet.sso.session_id, "did:mesh:q", sigma_raw=0.8)
    await hv.activate_session(quiet.sso.session_id)
    quiet.delta_engine.capture("did:mesh:q", [])
    s.record("audit_off", await hv.terminate_session(quiet.sso.session_id))
    s.record("active", [x.sso.session_id for x in hv.active_sessions])


async def lifecycle_saga_compensation(s: Side):
    """Reverse-order compensation, a timeout, and a tampered chain."""
    hv = s.hypervisor()
    ms = await session_with(s, hv, ("did:mesh:agent-0", 0.8))
    sid = ms.sso.session_id
    await hv.activate_session(sid)
    saga = ms.saga.create_saga(sid)
    steps = [ms.saga.add_step(saga.saga_id, f"step{i}", "did:mesh:agent-0", f"/api/{i}",
                              undo_api=f"/undo/{i}") for i in (1, 2, 3)]
    order = []

    async def ok():
        return "ok"

    async def boom():
        raise RuntimeError("step 3 failed")

    for step in steps[:2]:
        await ms.saga.execute_step(saga.saga_id, step.step_id, ok)
    s.record("failed", await attempt(ms.saga.execute_step(saga.saga_id, steps[2].step_id, boom)))

    async def undo(step):
        order.append(step.action_id)
        return "undone"

    compensated = await ms.saga.compensate(saga.saga_id, undo)
    s.record("compensated", (compensated, order, saga.to_dict()))
    slow = ms.saga.add_step(ms.saga.create_saga(sid).saga_id, "slow", "did:mesh:agent-0",
                            "/api/slow", timeout_seconds=0)

    async def sleepy():
        await asyncio.sleep(0.05)

    s.record("timeout", await attempt(ms.saga.execute_step(
        ms.saga.active_sagas[-1].saga_id, slow.step_id, sleepy)))
    for t in range(4):
        ms.delta_engine.capture("did:mesh:agent-0", change(s, t))
    ms.delta_engine._deltas[1].changes[0].path = "/tampered"
    s.record("tampered", ms.delta_engine.verify_chain())
    ms.delta_engine._deltas[1].changes[0].path = "/f1.md"
    s.record("root", await hv.terminate_session(sid))


async def lifecycle_big_tree_and_expiry(s: Side):
    """A 70-delta session (the engine's root takes the device path: B3's
    plain version), a session past its max duration swept, the GC, and
    the event log mirror wrapping."""
    m = s.pkg
    bus = m.HypervisorEventBus()
    hv = s.hypervisor(event_bus=bus)
    big = await session_with(s, hv, ("did:a", 0.8), ("did:b", 0.9))
    await hv.activate_session(big.sso.session_id)
    for t in range(70):
        big.delta_engine.capture("did:a" if t % 3 else "did:b", change(s, t))
    s.record("device_root", (big.delta_engine.compute_merkle_root(),
                             big.delta_engine.compute_merkle_root(device=False),
                             big.delta_engine.compute_merkle_root(device=True)))
    s.record("big_root", await hv.terminate_session(big.sso.session_id))
    s.record("gc", (hv.gc.history, hv.gc.is_purged(big.sso.session_id)))
    brief = await session_with(s, hv, ("did:c", 0.7), max_duration_seconds=8)
    other = await session_with(s, hv, ("did:d", 0.7))
    s.clock.advance(16.0)
    s.record("expired", await hv.sweep_expired_sessions())
    s.record("states", (brief.sso.state, other.sso.state))
    for _ in range(2):
        await hv.check_action(other.sso.session_id, "did:d", action(s, ring3=True))
    s.record("mirrored", hv.sync_events_to_device())
    s.record("mirrored_again", hv.sync_events_to_device())


# ── tests/integration/test_facade_kill.py ────────────────────────────


async def kill_handoff(s: Side):
    ks = s.mod("security.kill_switch")
    bus = s.pkg.HypervisorEventBus()
    hv = s.hypervisor(event_bus=bus)
    ms = await session_with(s, hv, ("did:victim", 0.8), ("did:sub", 0.9), ("did:third", 0.7))
    sid = ms.sso.session_id
    hv.kill_switch.register_substitute(sid, "did:sub")
    s.record("killed", await hv.kill_agent(
        sid, "did:victim", reason=ks.KillReason.RING_BREACH,
        in_flight_steps=[{"step_id": "s1", "saga_id": "g1"}, {"step_id": "s2", "saga_id": "g1"}]))
    s.record("ghost", await attempt(hv.kill_agent(sid, "did:ghost")))
    s.record("again", await attempt(hv.kill_agent(sid, "did:victim")))
    hv.kill_switch.register_substitute(sid, "did:third")
    s.record("self", await hv.kill_agent(sid, "did:third",
                                         in_flight_steps=[{"step_id": "s3", "saga_id": "g2"}]))
    s.record("malformed", await attempt(hv.kill_agent(
        sid, "did:sub", in_flight_steps=[{"step_id": "ok", "saga_id": "g"}, "oops"])))
    await hv.leave_session(sid, "did:sub")
    s.record("pool", hv.kill_switch.substitutes(sid))
    hv.kill_switch.register_substitute(sid, "did:late")
    await hv.terminate_session(sid)
    s.record("pools", sorted(hv.kill_switch._pools))


async def kill_retires_edges_and_elevations(s: Side):
    m = s.pkg
    hv = s.hypervisor()
    ms = await session_with(s, hv, ("did:victim", 0.8), ("did:other", 0.9))
    sid = ms.sso.session_id
    s.record("vouch", hv.vouching.vouch("did:other", "did:victim", sid, voucher_sigma=0.9))
    s.record("grant", await hv.grant_elevation(sid, "did:victim",
                                               m.ExecutionRing.RING_1_PRIVILEGED))
    s.record("killed", await hv.kill_agent(sid, "did:victim"))
    s.record("held", hv.elevation.get_active_elevation("did:victim", sid))
    # The bond survives host-side and re-mirrors when the victim rejoins
    # another session.
    second = await session_with(s, hv, ("did:victim", 0.8))
    s.record("rejoined", (second.slot, sorted(hv._edge_of_vouch.items())))


async def kill_with_scheduler(s: Side):
    """The kill rewires the victim's device saga step onto the
    substitute through the saga scheduler."""
    hv = s.hypervisor()
    ms = await session_with(s, hv, ("did:victim", 0.8), ("did:sub", 0.9))
    sid = ms.sso.session_id
    hv.kill_switch.register_substitute(sid, "did:sub")
    g = hv.state.create_saga("saga:fk", ms.slot, [{"retries": 0}, {"retries": 0}])
    sched = s.mod("runtime.saga_scheduler").SagaScheduler(hv.state, retry_backoff_seconds=0.0)
    ran = []

    async def dead():
        raise RuntimeError("victim is dead")

    async def sub_exec():
        ran.append("sub")
        return "ok"

    sched.register(g, 0, sub_exec)
    sched.register(g, 1, dead)
    s.record("killed", await hv.kill_agent(
        sid, "did:victim", in_flight_steps=[{"step_id": "s1", "saga_id": "saga:fk"}],
        scheduler=sched, step_index={("saga:fk", "s1"): (g, 1)},
        substitute_executors={"did:sub": sub_exec}))
    await sched.run_until_settled()
    s.record("settled", ran)


# ── tests/integration/test_facade_elevation.py ───────────────────────


async def elevation_grant_and_revoke(s: Side):
    m = s.pkg
    bus = m.HypervisorEventBus()
    hv = s.hypervisor(event_bus=bus)
    ms = await session_with(s, hv, ("did:e", 0.8), ("did:f", 0.7))
    sid = ms.sso.session_id
    s.record("not_more", await attempt(hv.grant_elevation(sid, "did:e",
                                                          m.ExecutionRing.RING_2_STANDARD)))
    s.record("ring0", await attempt(hv.grant_elevation(sid, "did:e", m.ExecutionRing.RING_0_ROOT)))
    grant = await hv.grant_elevation(sid, "did:e", m.ExecutionRing.RING_1_PRIVILEGED,
                                     ttl_seconds=60, reason="deploy")
    s.record("grant", (grant, hv.state.effective_rings(hv.state.now())))
    s.record("twice", await attempt(hv.grant_elevation(sid, "did:e",
                                                       m.ExecutionRing.RING_1_PRIVILEGED)))
    await hv.revoke_elevation(grant.elevation_id)
    s.record("revoked", hv.elevation.get_active_elevation("did:e", sid))
    s.record("unknown", await attempt(hv.revoke_elevation("elev:none")))
    g2 = await hv.grant_elevation(sid, "did:f", m.ExecutionRing.RING_1_PRIVILEGED)
    await hv.leave_session(sid, "did:f")
    s.record("left", (hv.elevation.get(g2.elevation_id), sorted(hv._elev_row_of.items())))
    await hv.grant_elevation(sid, "did:e", m.ExecutionRing.RING_1_PRIVILEGED)
    await hv.activate_session(sid)
    s.record("terminated", await hv.terminate_session(sid))


async def elevation_expiry_and_recycling(s: Side):
    m = s.pkg
    hv = s.hypervisor()
    ms = await session_with(s, hv, ("did:e", 0.8), ("did:f", 0.8), ("did:g", 0.8))
    sid = ms.sso.session_id
    g1 = await hv.grant_elevation(sid, "did:e", m.ExecutionRing.RING_1_PRIVILEGED, ttl_seconds=8)
    await hv.leave_session(sid, "did:e")
    g2 = await hv.grant_elevation(sid, "did:f", m.ExecutionRing.RING_1_PRIVILEGED, ttl_seconds=32)
    await hv.revoke_elevation(g1.elevation_id)
    s.record("stale_handle", (g2, hv.state.effective_rings(hv.state.now())))
    row = hv.state.agent_row("did:g", ms.slot)
    s.record("device_only", hv.state.grant_elevation(row["slot"], 1, now=hv.state.now(),
                                                     ttl_seconds=4.0))
    s.clock.advance(64.0)
    s.record("swept", hv.sweep_elevations())
    s.record("swept_again", hv.sweep_elevations())


async def elevation_demotion_and_drift(s: Side):
    m = s.pkg
    hv = s.hypervisor(cmvk=s.cmvk())
    ms = await session_with(s, hv, ("did:e", 0.8), ("did:low", 0.4))
    sid = ms.sso.session_id
    await hv.grant_elevation(sid, "did:e", m.ExecutionRing.RING_1_PRIVILEGED)
    await hv.update_agent_ring(sid, "did:e", m.ExecutionRing.RING_3_SANDBOX, reason="demote")
    s.record("demoted", (hv.elevation.get_active_elevation("did:e", sid),
                         hv.state.agent_row("did:e", ms.slot)))
    await hv.update_agent_ring(sid, "did:e", m.ExecutionRing.RING_2_STANDARD, reason="restore")
    await hv.grant_elevation(sid, "did:low", m.ExecutionRing.RING_2_STANDARD)
    s.record("floor_drift", await hv.verify_behavior(sid, "did:low", claimed_embedding=0.4,
                                                     observed_embedding=0.0))
    s.record("medium_drift", await hv.verify_behavior(sid, "did:e", claimed_embedding=0.35,
                                                      observed_embedding=0.0))
    s.record("after", (hv.elevation.active_elevations, ms.sso.get_participant("did:e")))


# ── tests/integration/test_ledger_gate.py ────────────────────────────


async def slash_in_fresh_session(s: Side, hv, did, drift=0.95):
    ms = await session_with(s, hv, (did, 0.8))
    result = await hv.verify_behavior(ms.sso.session_id, did, claimed_embedding=drift,
                                      observed_embedding=0.0)
    return ms, result


async def ledger_probation_and_deny(s: Side):
    hv = s.hypervisor(cmvk=s.cmvk())
    s.record("slash1", (await slash_in_fresh_session(s, hv, "did:r"))[1])
    s.record("profile1", hv.ledger.compute_risk_profile("did:r"))
    await slash_in_fresh_session(s, hv, "did:r")
    s.record("profile2", hv.ledger.compute_risk_profile("did:r"))
    ms = await session_with(s, hv)
    s.record("probation", (await hv.join_session(ms.sso.session_id, "did:r", sigma_raw=0.9),
                           hv.state.agent_row("did:r", ms.slot)))
    await slash_in_fresh_session(s, hv, "did:r")
    ms = await session_with(s, hv)
    s.record("denied", await attempt(hv.join_session(ms.sso.session_id, "did:r", sigma_raw=0.9,
                                                     actions=[admin_action(s)])))
    s.record("untouched", (ms.sso.consistency_mode, ms.sso.participant_count))


async def ledger_cascade_and_credit(s: Side):
    """A vouched rogue slashed through B8's plain version: the backer is
    clipped and charged, earns no clean credit; the slash is agent-global
    (the rogue's other sessions blacklist and forfeit their credit)."""
    m = s.pkg
    bus = m.HypervisorEventBus()
    hv = s.hypervisor(cmvk=s.cmvk(), event_bus=bus)
    ms = await session_with(s, hv, ("did:rogue", 0.6), ("did:backer", 0.9), ("did:bystander", 0.7))
    sid = ms.sso.session_id
    other = await session_with(s, hv, ("did:rogue", 0.8), ("did:peer", 0.8))
    archived = await session_with(s, hv, ("did:rogue", 0.8))
    await hv.activate_session(archived.sso.session_id)
    await hv.terminate_session(archived.sso.session_id)
    hv.vouching.vouch("did:backer", "did:rogue", sid, voucher_sigma=0.9, bond_pct=0.5)
    await hv.activate_session(sid)
    s.record("slash", await hv.verify_behavior(sid, "did:rogue", claimed_embedding=0.95,
                                               observed_embedding=0.0))
    s.record("rows", (hv.state.agent_rows("did:rogue"), hv.state.agent_row("did:backer")))
    await hv.activate_session(other.sso.session_id)
    await hv.terminate_session(other.sso.session_id)
    s.record("terminated", await hv.terminate_session(sid))
    for _ in range(3):
        cs = await session_with(s, hv, ("did:clean", 0.8))
        await hv.activate_session(cs.sso.session_id)
        await hv.terminate_session(cs.sso.session_id)
    s.record("credit", hv.ledger.compute_risk_profile("did:clean"))
    s.record("post_mortem", await hv.verify_behavior(sid, "did:bystander", claimed_embedding=0.9,
                                                     observed_embedding=0.0))
    s.record("penalized", sorted(hv._penalized_in))
    s.record("events", hv.sync_events_to_device())


async def ledger_attribution_and_collusion(s: Side):
    m = s.pkg
    bus = m.HypervisorEventBus()
    hv = s.hypervisor(event_bus=bus)
    ms = await session_with(s, hv, ("did:root", 0.8), ("did:enabler", 0.8))
    sid = ms.sso.session_id
    await hv.activate_session(sid)
    s.record("attributed", hv.attribute_fault(
        saga_id="saga:f", session_id=sid,
        agent_actions={
            "did:root": [{"action_id": "a1", "step_id": "s2", "success": False}],
            "did:enabler": [{"action_id": "a0", "step_id": "s1", "success": True,
                             "dependencies": []}],
        },
        failure_step_id="s2", failure_agent_did="did:root"))
    await hv.terminate_session(sid)
    s.record("post_mortem", hv.attribute_fault(
        saga_id="saga:g", session_id=sid,
        agent_actions={"did:root": [{"action_id": "a1", "step_id": "s3", "success": False}]},
        failure_step_id="s3", failure_agent_did="did:root"))
    s.record("unknown", call(hv.attribute_fault, saga_id="x", session_id="session:none",
                             agent_actions={}, failure_step_id="s", failure_agent_did="d"))
    clique = [f"did:c{i}" for i in range(4)]
    pump = await session_with(s, hv, *((did, 0.55) for did in clique), min_sigma_eff=0.5)
    psid = pump.sso.session_id
    for a, b in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3), (3, 0)):
        s.record(f"vouch{a}{b}", call(hv.vouching.vouch, clique[a], clique[b], psid,
                                      voucher_sigma=0.55))
    s.record("collusion", hv.detect_collusion(psid))
    s.record("rescan", hv.detect_collusion())
    s.record("gated", await hv.check_action(psid, "did:c0", action(s)))


# ── tests/integration/test_action_gateway.py ─────────────────────────


async def gateway_gates(s: Side):
    m = s.pkg
    bus = m.HypervisorEventBus()
    hv = s.hypervisor(event_bus=bus)
    ms = await session_with(s, hv, ("did:a", 0.8), ("did:q", 0.8), ("did:s", 0.97),
                            ("did:p", 0.7))
    sid = ms.sso.session_id
    s.record("allowed", await hv.check_action(sid, "did:a", action(s)))
    row = hv.state.agent_row("did:q", ms.slot)
    hv.quarantine.quarantine("did:q", sid, s.mod("liability.quarantine").QuarantineReason.MANUAL,
                             details="hold")
    hv.state.quarantine_rows([row["slot"]], now=hv.state.now())
    s.record("quarantined", (await hv.check_action(sid, "did:q", action(s)),
                             await hv.check_action(sid, "did:q", action(s, ring3=True))))
    deploy = action(s, reversibility=m.ReversibilityLevel.NONE, undo_api=None)
    s.record("refused", await hv.check_action(sid, "did:s", deploy, has_consensus=True))
    await hv.grant_elevation(sid, "did:s", m.ExecutionRing.RING_1_PRIVILEGED)
    s.record("sudo", await hv.check_action(sid, "did:s", deploy, has_consensus=True))
    probes = [await hv.check_action(sid, "did:p", admin_action(s)) for _ in range(12)]
    s.record("probes", probes)
    s.record("tripped", (hv.breach_detector.is_breaker_tripped("did:p", sid),
                         await hv.check_action(sid, "did:p", action(s, ring3=True))))
    s.record("wave", await hv.check_actions(sid, [
        ("did:a", action(s, ring3=True)), ("did:a", action(s), True, False),
        ("did:s", admin_action(s), False, True), ("did:q", action(s))]))
    s.record("bad_member", await attempt(hv.check_actions(sid, [("did:a", action(s)),
                                                                ("did:ghost", action(s))])))
    s.record("empty", await hv.check_actions(sid, []))


async def gateway_rate_limits(s: Side):
    """Ring 3's burst of 10 drains with no refill (the clock stands), a
    sudo grant rates at the elevated ring's budget, and the clock's
    dyadic advance refills."""
    m = s.pkg
    bus = m.HypervisorEventBus()
    hv = s.hypervisor(event_bus=bus)
    ms = await session_with(s, hv, ("did:r", 0.4), ("did:v", 0.4))
    sid = ms.sso.session_id
    s.record("drain", [(await hv.check_action(sid, "did:r", action(s, ring3=True))).allowed
                       for _ in range(12)])
    s.clock.advance(0.5)
    s.record("refill", await hv.check_actions(sid, [("did:r", action(s, ring3=True))] * 4))
    await hv.grant_elevation(sid, "did:v", m.ExecutionRing.RING_2_STANDARD)
    s.record("elevated", [(await hv.check_action(sid, "did:v", action(s, ring3=True))).allowed
                          for _ in range(12)])


# ── tests/integration/test_saga_gateway.py ───────────────────────────


async def saga_gateway(s: Side):
    m = s.pkg
    hv = s.hypervisor()
    ms = await session_with(s, hv, ("did:worker", 0.8), ("did:prober", 0.7))
    sid = ms.sso.session_id
    saga = ms.saga.create_saga(sid)
    s1, s2 = (ms.saga.add_step(saga.saga_id, action_id=f"a{i}", agent_did="did:worker",
                               execute_api="/x", undo_api="/u") for i in (1, 2))
    ran = []

    async def ok():
        ran.append("ran")
        return "ok"

    await ms.saga.execute_step(saga.saga_id, s1.step_id, ok)
    row = hv.state.agent_row("did:worker", ms.slot)
    hv.quarantine.quarantine("did:worker", sid,
                             s.mod("liability.quarantine").QuarantineReason.MANUAL,
                             details="hold")
    hv.state.quarantine_rows([row["slot"]], now=hv.state.now())
    s.record("refused", (await attempt(ms.saga.execute_step(saga.saga_id, s2.step_id, ok)),
                         s2.state, s2.error, list(ran)))
    s.record("refused_again", await attempt(ms.saga.execute_step(saga.saga_id, s2.step_id, ok)))
    hv.quarantine.release("did:worker", sid)
    s.clock.advance(512.0)
    s.record("released", hv.state.quarantine_tick(hv.state.now()))
    s.record("executed", (await ms.saga.execute_step(saga.saga_id, s2.step_id, ok), ran))
    for _ in range(8):
        await hv.check_action(sid, "did:prober", admin_action(s))
    probe = ms.saga.create_saga(sid)
    p1 = ms.saga.add_step(probe.saga_id, action_id="p1", agent_did="did:prober",
                          execute_api="/x", undo_api="/u")
    s.record("breaker", (hv.breach_detector.is_breaker_tripped("did:prober", sid),
                         await attempt(ms.saga.execute_step(probe.saga_id, p1.step_id, ok))))
    external = ms.saga.add_step(probe.saga_id, action_id="p2", agent_did="did:external",
                                execute_api="/x")
    s.record("ungated", await ms.saga.execute_step(probe.saga_id, external.step_id, ok))


# ── tests/integration/test_security_waves.py: the facade's write wave ──


async def write_wave_prewired(s: Side):
    """`ManagedSession.write_wave()` on the state's device: a quarantined
    member refused before any token burns, ring 3's burst, a causally
    stale writer and its read barrier, a released quarantine, and a
    SERIALIZABLE wave that needs write locks."""
    hv = s.hypervisor()
    ms = await session_with(s, hv, ("did:iso", 0.8), ("did:ok", 0.8), ("did:low", 0.4))
    sid = ms.sso.session_id
    await hv.activate_session(sid)
    row = hv.state.agent_row("did:iso", ms.slot)
    hv.state.quarantine_rows([row["slot"]], now=hv.state.now())
    wave = ms.write_wave()
    for i in range(12):
        wave.submit("did:low", f"/burst/{i}", f"b{i}", ring=3)
    wave.submit("did:iso", "/doc.md", "nope", ring=2)
    wave.submit("did:ok", "/doc.md", "yes", ring=2)
    wave.submit("did:ok", "/doc.md", "again", ring=2)
    s.record("first", wave.flush(now=hv.state.now()))
    s.clock.advance(0.5)
    wave.submit("did:low", "/doc.md", "blind", ring=1)
    s.record("stale", wave.flush(now=hv.state.now()))
    wave.observe("did:low", "/doc.md")
    wave.submit("did:low", "/doc.md", "seen", ring=1)
    s.record("fresh", (wave.flush(now=hv.state.now()), ms.sso.vfs.read("/doc.md")))
    s.clock.advance(512.0)
    s.record("released", hv.state.quarantine_tick(hv.state.now()))
    il = s.mod("session.intent_locks")
    locks = il.IntentLockManager()
    locks.acquire("did:ok", sid, "/ser.md", il.LockIntent.WRITE)
    ser = ms.write_wave(isolation=s.mod("session.isolation").IsolationLevel.SERIALIZABLE,
                        lock_manager=locks)
    ser.submit("did:ok", "/ser.md", "locked", ring=2)
    ser.submit("did:iso", "/ser.md", "unlocked", ring=2)
    s.record("serializable", ser.flush(now=hv.state.now()))
    s.record("vfs", ({p: ms.sso.vfs.read(p) for p in ms.sso.vfs.list_files()},
                     [(e.path, e.agent_did) for e in ms.sso.vfs.edit_log]))


# ── seeded random public-API sequences ───────────────────────────────

_RANDOM_OPS = ("create", "join", "join", "join", "vouch", "activate", "capture", "check",
               "checks", "drift", "grant", "revoke", "kill", "leave", "ring", "terminate",
               "sweep", "clock", "sync", "collusion", "write_wave", "write_wave")


async def random_api(s: Side, seed: int):
    """Up to 40 public-API calls drawn from one seed: creates, joins (some
    with admin or irreversible manifests), vouches, activations, captures,
    single and batched checks, CMVK drift, grants and revokes, kills,
    leaves, ring updates, terminates, both sweeps, dyadic clock steps,
    event mirroring, collusion scans and write waves. Every call's return
    (or exception) is recorded, with the tables and host indices."""
    m = s.pkg
    rng = np.random.RandomState(seed)
    hv = s.hypervisor(event_bus=m.HypervisorEventBus(), cmvk=s.cmvk())
    agents = [f"did:r{i}" for i in range(8)]
    live: list[str] = []
    grants: list[str] = []

    def pick(seq):
        return seq[int(rng.randint(len(seq)))]

    for step in range(int(rng.randint(24, 41))):
        op = pick(_RANDOM_OPS)
        if op not in ("create", "sweep", "clock", "sync", "collusion", "revoke") and not live:
            op = "create"
        sid = pick(live) if live else None
        members = sorted(p.agent_did for p in hv.get_session(sid).sso.participants) if sid else []
        # Mostly a member of the session, else anyone (joins: anyone).
        anyone = op == "join" or not members or rng.uniform() < 0.2
        did = pick(agents) if anyone else pick(members)
        if op == "create":
            config = m.SessionConfig(max_participants=int(rng.randint(2, 6)),
                                     min_sigma_eff=float(pick([0.0, 0.5])))
            ms = await hv.create_session(config, creator_did="did:lead")
            live.append(ms.sso.session_id)
            out = (ms.sso.session_id, ms.slot)
        elif op == "join":
            kind = int(rng.randint(3))
            actions = [None, [admin_action(s)],
                       [action(s, reversibility=m.ReversibilityLevel.NONE, undo_api=None)]][kind]
            out = await attempt(hv.join_session(sid, did, actions=actions,
                                                sigma_raw=float(pick([0.3, 0.55, 0.8, 0.95]))))
        elif op == "vouch":
            out = call(hv.vouching.vouch, did, pick(agents), sid, voucher_sigma=0.9)
        elif op == "activate":
            out = await attempt(hv.activate_session(sid))
        elif op == "capture":
            engine = hv.get_session(sid).delta_engine
            out = [call(engine.capture, did, change(s, int(rng.randint(1000))))
                   for _ in range(int(rng.randint(1, 4)))]
        elif op == "check":
            out = await attempt(hv.check_action(sid, did, action(s, ring3=bool(rng.randint(2)))))
        elif op == "checks":
            out = await attempt(hv.check_actions(sid, [
                (pick(members or agents), pick([action(s), action(s, ring3=True),
                                                admin_action(s)]))
                for _ in range(int(rng.randint(1, 5)))]))
        elif op == "drift":
            out = await attempt(hv.verify_behavior(
                sid, did, claimed_embedding=float(pick([0.1, 0.35, 0.6, 0.95])),
                observed_embedding=0.0))
        elif op == "grant":
            out = await attempt(hv.grant_elevation(
                sid, did, m.ExecutionRing(int(rng.randint(1, 3))),
                ttl_seconds=int(pick([8, 60]))))
            if not isinstance(out, BaseException):
                grants.append(out.elevation_id)
        elif op == "revoke":
            out = await attempt(hv.revoke_elevation(pick(grants) if grants else "elev:none"))
        elif op == "kill":
            out = await attempt(hv.kill_agent(sid, did))
        elif op == "leave":
            out = await attempt(hv.leave_session(sid, did))
        elif op == "ring":
            out = await attempt(hv.update_agent_ring(sid, did, m.ExecutionRing(
                int(rng.randint(1, 4))), reason="random"))
        elif op == "terminate":
            out = await attempt(hv.terminate_session(sid))
            if not isinstance(out, BaseException):
                live.remove(sid)
        elif op == "sweep":
            out = (await hv.sweep_expired_sessions(), hv.sweep_elevations())
            live = [x for x in live if hv.get_session(x).sso.state.value != "archived"]
        elif op == "clock":
            s.clock.advance(float(pick([0.5, 4.0, 64.0])))
            out = hv.state.now()
        elif op == "sync":
            out = hv.sync_events_to_device()
        elif op == "collusion":
            out = hv.detect_collusion()
        else:  # write_wave
            ms = hv.get_session(sid)
            wave = ms.write_wave()
            for i in range(int(rng.randint(1, 9))):
                writer = pick(members or agents)
                if rng.uniform() < 0.25:
                    wave.observe(writer, f"/w{i % 3}")
                wave.submit(writer, f"/w{i % 3}", f"{step}.{i}", ring=int(rng.randint(0, 4)))
            out = (wave.flush(now=hv.state.now()),
                   {p: ms.sso.vfs.read(p) for p in ms.sso.vfs.list_files()})
        s.record(f"{step}:{op}", out)


SEQUENCES = {
    f.__name__: f for f in (
        lifecycle_readme, lifecycle_admission_edges, lifecycle_saga_compensation,
        lifecycle_big_tree_and_expiry, kill_handoff, kill_retires_edges_and_elevations,
        kill_with_scheduler, elevation_grant_and_revoke, elevation_expiry_and_recycling,
        elevation_demotion_and_drift, ledger_probation_and_deny, ledger_cascade_and_credit,
        ledger_attribution_and_collusion, gateway_gates, gateway_rate_limits, saga_gateway,
        write_wave_prewired,
    )
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_facade_sequence_matches_reference(name):
    ref_log, port_log = run_both(SEQUENCES[name])
    assert_logs_equal(ref_log, port_log)


@pytest.mark.parametrize("seed", range(6))
def test_random_api_sequence_matches_reference(seed):
    ref_log, port_log = run_both(lambda side: random_api(side, seed))
    assert_logs_equal(ref_log, port_log)
    ops = {label.split(":")[1] for label, _ in port_log if label.count(":") == 1}
    assert "write_wave" in ops or seed != 0


async def left_participant(s: Side):
    m = s.pkg
    hv = s.hypervisor()
    ms = await session_with(s, hv, ("did:stay", 0.8), ("did:gone", 0.8))
    sid = ms.sso.session_id
    await hv.leave_session(sid, "did:gone")
    s.record("check", await attempt(hv.check_action(sid, "did:gone", action(s))))
    s.record("checks", await attempt(hv.check_actions(sid, [("did:stay", action(s)),
                                                           ("did:gone", action(s))])))
    grant = await attempt(hv.grant_elevation(sid, "did:gone", m.ExecutionRing.RING_1_PRIVILEGED))
    s.record("grant", (grant, hv.elevation.get_active_elevation("did:gone", sid),
                       sorted(hv._elev_row_of.items()),
                       hv.state.effective_rings(hv.state.now())))


def test_left_participant_keeps_the_reference_behaviour():
    """Held by design (ROADMAP C.2): for a participant who has left, both
    facades raise "no live device row ... plane divergence" from
    `check_action(s)` and grant an elevation on the host only (no device
    row, so no device grant)."""
    ref_log, port_log = run_both(left_participant)
    log = assert_logs_equal(ref_log, port_log)
    for key in ("check", "checks"):
        kind, exc_type, message = log[key]
        assert (kind, exc_type) == ("raised", "RuntimeError")
        assert "no live device row" in message and "plane divergence" in message
    grant, held, elev_rows, _rings = log["grant"]
    assert grant[0] == "RingElevation" and held == grant
    assert elev_rows == []  # granted on the host, no device row claimed


def test_readme_lifecycle_root_commits_and_verifies():
    """The README sequence's port run on its own terms: a 64-hex root
    that the commitment engine verifies, equal to the host chain's."""
    _, port_log = run_both(lifecycle_readme)
    root, verified, host_root, chain_ok = dict(port_log)["terminated"]
    assert len(root) == 64 and verified and chain_ok and root == host_root


# ── the refused entries ──────────────────────────────────────────────


def test_unported_entries_name_a_later_slice():
    """The name this test had while the multi-device runtime refused: the
    consistency runtime is ported (`tests/test_torch_consistency.py`
    holds it to the reference), cached per mesh, and a `mesh` that is not
    a mesh is refused with the reference's own error.
    The serving front door, the autopilot and the whole fleet are ported:
    `tests/test_torch_serving.py`, `tests/test_torch_autopilot.py`,
    `tests/test_torch_fleet.py`, `tests/test_torch_failover.py` and
    `tests/test_torch_rebalance.py` hold them to the reference; with none
    attached, the API's fleet routes answer the reference's 503."""
    from hypervisor_tpu_torch import fleet
    from hypervisor_tpu_torch.api import ApiError, HypervisorService
    from hypervisor_tpu_torch.fleet import failover

    from hypervisor_tpu_torch.parallel import make_mesh
    from hypervisor_tpu_torch.runtime.consistency import ConsistencyRuntime

    hv = PORT.Hypervisor(device="cpu")
    errors = []
    for facade in (REF.Hypervisor(), hv):
        with pytest.raises(AttributeError) as err:
            facade.consistency_runtime(mesh=None)
        errors.append(str(err.value))
    assert errors[1] == errors[0] == "'NoneType' object has no attribute 'devices'"
    rt = hv.consistency_runtime(make_mesh(8, platform="cpu"))
    assert isinstance(rt, ConsistencyRuntime) and rt.state is hv.state
    assert hv.consistency_runtime(make_mesh(8, platform="cpu")) is rt
    assert fleet.FailoverController is failover.FailoverController
    assert fleet.FailoverController.__module__ == "hypervisor_tpu_torch.fleet.failover"
    svc = HypervisorService(hypervisor=hv)
    assert asyncio.run(svc.debug_autopilot()) == {"enabled": False}
    assert asyncio.run(svc.debug_fleet()) == {"enabled": False}
    with pytest.raises(ApiError, match="no fleet attached") as err:
        asyncio.run(svc.fleet_workers())
    assert err.value.status == 503


def test_default_hypervisor_runs_on_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert PORT.Hypervisor().state.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PORT.Hypervisor()
    assert PORT.Hypervisor(device="cpu").state.device.type == "cpu"
