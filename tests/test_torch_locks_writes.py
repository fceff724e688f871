"""The lock and write waves against the reference's, on the CPU.

Three layers, every value held at tolerance 0 (bit for bit):

  * the ops: `ops.locks` (`conflict_gate`, `transitive_closure`,
    `deadlock_sweep`, `contention_counts`) and `ops.clock_ops`
    (`happens_before`, `is_concurrent`, `merge`, `batched_write_prepass`)
    on seeded inputs, against the JAX package's functions on the same
    numpy inputs;
  * seeded `LockWave` and `WriteWave` sequences run on both packages (the
    port with `device="cpu"`), with ids and times patched the same way
    (`test_torch_facade_api.install_determinism`): statuses, granted
    locks, blocker sets, the lock manager's tables, deadlock reports,
    contention counts, VFS contents, clock matrices and token columns.
    Write sequences move `now` in dyadic steps, where the reference's
    jitted refill (a fused multiply-add on XLA:CPU) and the port's
    separate roundings agree; `test_write_wave_refill_off_the_dyadic_grid_
    differs_from_the_jitted_reference` shows the one-ulp difference off
    that grid (ROADMAP C.2);
  * counterparts of `tests/unit/test_locks_batched.py`, the write-wave
    cases of `tests/integration/test_security_waves.py` (`TestWriteWave`,
    `test_write_wave_refuses_quarantined_writer`,
    `test_managed_session_write_wave_prewired`, `TestIsolationLevels`),
    `tests/integration/test_device_plane.py::TestStatusMapping` and
    `tests/unit/test_hypothesis_properties.py::TestClockDualPlaneProperties`,
    on the port.
"""

from __future__ import annotations

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import hypervisor_tpu as REF
import hypervisor_tpu_torch as PORT
from hypervisor_tpu.ops import clock_ops as jax_clock
from hypervisor_tpu.ops import locks as jax_locks
from hypervisor_tpu.ops import rate_limit as jax_rate
from hypervisor_tpu.runtime import lock_wave as jax_lock_wave
from hypervisor_tpu.runtime import write_wave as jax_write_wave
from hypervisor_tpu_torch.ops import clock_ops, locks
from hypervisor_tpu_torch.runtime.lock_wave import (
    LOCK_CONTENTION,
    LOCK_DEADLOCK,
    LOCK_GRANTED,
    LockWave,
)
from hypervisor_tpu_torch.runtime.write_wave import (
    WRITE_CONFLICT,
    WRITE_LOCK_REQUIRED,
    WRITE_OK,
    WRITE_QUARANTINED,
    WRITE_RATE_LIMITED,
    WriteWave,
)
from hypervisor_tpu_torch.session.intent_locks import IntentLockManager, LockIntent
from hypervisor_tpu_torch.session.isolation import IsolationLevel
from hypervisor_tpu_torch.session.vfs import SessionVFS
from tests.test_torch_facade_api import ManualTime, assert_logs_equal, install_determinism, norm

S = "session:lk"


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    g = got.cpu().numpy()
    assert g.dtype == want.dtype and g.shape == want.shape, (g.dtype, want.dtype, g.shape)
    assert g.tobytes() == want.tobytes()


def _pair(arr: np.ndarray):
    return torch.from_numpy(np.array(arr)), jnp.asarray(arr)


# ── the ops against the reference's jnp functions ────────────────────


@pytest.mark.parametrize("seed", range(4))
def test_conflict_gate_matches_reference(seed):
    rng = np.random.RandomState(seed)
    cap, held, b, n_agents = 32, 20, 16, 12
    hp = np.full(cap, -1, np.int32)
    ha = np.full(cap, -1, np.int32)
    hi = np.zeros(cap, np.int8)
    hact = np.zeros(cap, bool)
    hp[:held] = rng.randint(0, 6, held)
    ha[:held] = rng.randint(0, n_agents, held)
    hi[:held] = rng.randint(0, 3, held)
    hact[:held] = rng.uniform(size=held) < 0.8
    rp = np.full(b, -2, np.int32)
    ra = np.full(b, -2, np.int32)
    ri = np.zeros(b, np.int8)
    rp[:12] = rng.randint(0, 7, 12)
    ra[:12] = rng.randint(0, n_agents, 12)
    ri[:12] = rng.randint(0, 3, 12)
    args = [_pair(a) for a in (hp, ha, hi, hact, rp, ra, ri)]
    got = locks.conflict_gate(*(t for t, _ in args), n_agents=n_agents)
    want = jax_locks.conflict_gate(*(j for _, j in args), n_agents=n_agents)
    for name in ("blocked", "blockers", "n_conflicts"):
        _same(getattr(got, name), getattr(want, name))
    assert bool(got.blocked.any())


def _random_wait(rng, n: int, density: float) -> np.ndarray:
    wait = rng.uniform(size=(n, n)) < density
    if n > 3:  # plant one long cycle
        ring = rng.permutation(n)[: min(n, 5)]
        wait[ring, np.roll(ring, 1)] = True
    return wait


@pytest.mark.parametrize("n", [1, 2, 3, 8, 33, 64])
def test_transitive_closure_matches_reference(n):
    rng = np.random.RandomState(n)
    wait = _random_wait(rng, n, 1.5 / n)
    t, j = _pair(wait)
    _same(locks.transitive_closure(t), jax_locks.transitive_closure(j))
    assert locks.closure_squarings(n) == max(1, int(np.ceil(np.log2(max(n, 2)))))


@pytest.mark.parametrize("seed,density", [(0, 0.0), (1, 0.02), (2, 0.05), (3, 0.1)])
def test_deadlock_sweep_matches_reference(seed, density):
    """Sigma drawn from three values so the lowest ties: the victim is the
    first lowest-sigma row on a cycle, as `jnp.argmin` picks."""
    rng = np.random.RandomState(seed)
    n, b = 40, 9
    wait = _random_wait(rng, n, density) if density else np.zeros((n, n), bool)
    sigma = rng.choice(np.array([0.3, 0.5, 0.9], np.float32), n)
    req_agent = rng.randint(0, n, b).astype(np.int32)
    blockers = rng.uniform(size=(b, n)) < 0.05
    blockers[0, req_agent[0]] = True  # a request its own agent blocks
    args = [_pair(a) for a in (wait, req_agent, blockers, sigma)]
    got = locks.deadlock_sweep(*(t for t, _ in args))
    want = jax_locks.deadlock_sweep(*(j for _, j in args))
    for name in ("on_cycle", "would_deadlock", "victim"):
        _same(getattr(got, name), getattr(want, name))
    assert (int(got.victim) >= 0) == bool(density) == bool(got.on_cycle.any())


@pytest.mark.parametrize("seed", range(3))
def test_contention_counts_matches_reference(seed):
    rng = np.random.RandomState(seed)
    cap, n_paths, n_agents = 64, 10, 9
    hp = rng.randint(0, n_paths, cap).astype(np.int32)
    ha = rng.randint(0, n_agents, cap).astype(np.int32)
    hact = rng.uniform(size=cap) < 0.7
    hp[-4:], ha[-4:], hact[-4:] = -1, -1, False
    args = [_pair(a) for a in (hp, ha, hact)]
    got = locks.contention_counts(*(t for t, _ in args), n_paths=n_paths, n_agents=n_agents)
    want = jax_locks.contention_counts(*(j for _, j in args), n_paths=n_paths, n_agents=n_agents)
    _same(got, want)


def test_clock_relations_match_reference():
    rng = np.random.RandomState(11)
    a = rng.randint(0, 3, (200, 5)).astype(np.int32)
    b = rng.randint(0, 3, (200, 5)).astype(np.int32)
    b[:40] = a[:40] + rng.randint(0, 2, (40, 5))  # some that happen after
    (ta, ja), (tb, jb) = _pair(a), _pair(b)
    _same(clock_ops.happens_before(ta, tb), jax_clock.happens_before(ja, jb))
    _same(clock_ops.is_concurrent(ta, tb), jax_clock.is_concurrent(ja, jb))
    _same(clock_ops.merge(ta, tb), jax_clock.merge(ja, jb))


@pytest.mark.parametrize("seed,strict", [(0, True), (1, True), (2, False), (3, True)])
def test_batched_write_prepass_matches_reference(seed, strict):
    rng = np.random.RandomState(seed)
    p, n, w = 12, 8, 6
    path_clocks = rng.randint(0, 3, (p, n)).astype(np.int32)
    path_clocks[:3] = 0  # empty paths always admit
    agent_clocks = rng.randint(0, 3, (n, n)).astype(np.int32)
    wp = rng.permutation(p)[:w].astype(np.int32)
    wa = rng.permutation(n)[:w].astype(np.int32)
    args = [_pair(a) for a in (path_clocks, agent_clocks, wp, wa)]
    got = clock_ops.batched_write_prepass(*(t for t, _ in args), strict)
    want = jax_clock.batched_write_prepass(*(j for _, j in args), strict)
    for name in ("allowed", "path_clocks", "agent_clocks", "conflicts"):
        _same(getattr(got, name), getattr(want, name))
    # The inputs are left as they were.
    assert np.array_equal(args[0][0].numpy(), path_clocks)


# ── seeded wave sequences on both packages ───────────────────────────


def run_both(sequence, *params) -> None:
    """Run `sequence(pkg_modules, record, *params)` for each package with
    ids and time patched, and hold the two logs equal."""
    logs = []
    for pkg in (REF, PORT):
        with pytest.MonkeyPatch.context() as mp:
            install_determinism(mp, ManualTime())
            log: list = []
            mods = _Modules(pkg)
            sequence(mods, lambda label, value: log.append((label, norm(value))), *params)
            logs.append(log)
    return assert_logs_equal(*logs)


class _Modules:
    """One package's lock and write waves, built on the CPU for the port."""

    def __init__(self, pkg) -> None:
        self.is_ref = pkg is REF
        self.lw = jax_lock_wave if self.is_ref else PORT.runtime.lock_wave
        self.ww = jax_write_wave if self.is_ref else PORT.runtime.write_wave
        self.pkg = pkg

    def mod(self, name):
        import importlib

        return importlib.import_module(f"{self.pkg.__name__}.{name}")

    def lock_wave(self, **kw):
        if not self.is_ref:
            kw["device"] = "cpu"
        return self.lw.LockWave(**kw)

    def write_wave(self, vfs, **kw):
        if not self.is_ref:
            kw["device"] = "cpu"
        return self.ww.WriteWave(vfs, **kw)


def manager_tables(manager) -> dict:
    return {
        "locks": {k: norm(v) for k, v in manager._locks.items()},
        "by_resource": {k: list(v) for k, v in manager._by_resource.items()},
        "wait_for": {k: sorted(v) for k, v in manager._wait_for.items()},
    }


def lock_sequence(m: _Modules, record, seed: int) -> None:
    """Three seeded request waves over 12 agents and 10 paths with repeats
    (several occurrence batches), declared wait cycles between them, the
    standing-cycle report, contention counts and agent releases."""
    rng = np.random.RandomState(seed)
    intents = m.mod("session.intent_locks").LockIntent
    wave = m.lock_wave(max_agents=16, max_paths=32)
    agents = [f"did:a{i}" for i in range(12)]
    for i, did in enumerate(agents):
        wave.observe_sigma(did, float(rng.choice([0.3, 0.5, 0.5, 0.9])))
    kinds = [intents.READ, intents.WRITE, intents.EXCLUSIVE]
    for round_ in range(3):
        for _ in range(int(rng.randint(10, 30))):
            wave.submit(str(rng.choice(agents)), S, f"/p{rng.randint(0, 10)}",
                        kinds[int(rng.choice(3, p=[0.6, 0.3, 0.1]))],
                        saga_step_id=None if rng.uniform() < 0.5 else f"step{round_}")
        report = wave.flush()
        record(f"flush{round_}", (report.status, report.locks, report.blockers))
        record(f"manager{round_}", manager_tables(wave.manager))
        cycle = [str(a) for a in rng.choice(agents, int(rng.randint(2, 5)), replace=False)]
        for a, b in zip(cycle, cycle[1:] + cycle[:1]):
            wave.manager.declare_wait(a, {b})
        record(f"report{round_}", wave.deadlock_report())
        record(f"contention{round_}", wave.contention_counts())
        victim = wave.deadlock_report().victim
        if victim is not None:
            record(f"released{round_}", wave.manager.release_agent_locks(victim, S))
            wave.manager._wait_for.pop(victim, None)
        record(f"after{round_}", (wave.deadlock_report(), manager_tables(wave.manager)))


@pytest.mark.parametrize("seed", range(4))
def test_lock_wave_sequence_matches_reference(seed):
    log = run_both(lock_sequence, seed)
    codes = np.concatenate([log[f"flush{r}"][0] for r in range(3)])
    assert {LOCK_GRANTED, LOCK_CONTENTION} <= set(codes.tolist())


def wave_tables(wave) -> dict:
    return {name: np.array(getattr(wave, name)) if not isinstance(getattr(wave, name), torch.Tensor)
            else getattr(wave, name).cpu().numpy()
            for name in ("_path_clocks", "_agent_clocks", "_rl_tokens", "_rl_stamp", "_rl_ring",
                         "_rl_primed")}


def write_sequence(m: _Modules, record, seed: int, isolation: str) -> None:
    """Four seeded write waves of 6 writers over 8 paths, rings 0-3 (ring
    3's burst of 10 runs out), read barriers before some writes, two
    quarantined writers, and `now` in dyadic steps."""
    rng = np.random.RandomState(seed)
    iso = m.mod("session.isolation").IsolationLevel
    il = m.mod("session.intent_locks")
    vfs = m.mod("session.vfs").SessionVFS(f"session:w{seed}")
    held = {"did:w4"}
    kw = {"max_paths": 16, "max_writers": 8, "is_quarantined": lambda did: did in held}
    manager = None
    if isolation != "none":
        kw["isolation"] = getattr(iso, isolation)
    if isolation == "SERIALIZABLE":
        manager = il.IntentLockManager()
        kw["lock_manager"] = manager
    wave = m.write_wave(vfs, **kw)
    writers = [f"did:w{i}" for i in range(6)]
    if manager is not None:  # half the writers hold write locks on two paths each
        for k, did in enumerate(writers[:3]):
            for path in (f"/p{2 * k}", f"/p{2 * k + 1}"):
                manager.acquire(did, vfs.session_id, path, il.LockIntent.WRITE)
    now = 0.0
    for round_ in range(4):
        for i in range(int(rng.randint(8, 24))):
            did = str(rng.choice(writers, p=[0.4] + [0.12] * 5))
            path = f"/p{rng.randint(0, 8)}"
            if rng.uniform() < 0.3:
                wave.observe(did, path)
            ring = 3 if did == "did:w0" else int(rng.randint(0, 4))
            wave.submit(did, path, f"v{round_}.{i}", ring=ring)
        if round_ == 2:
            held.add("did:w1")
        now += float(rng.choice([0.0, 0.125, 0.5, 2.0]))
        report = wave.flush(now=now)
        record(f"flush{round_}", report)
        record(f"vfs{round_}", ({p: vfs.read(p) for p in vfs.list_files()},
                                [(e.path, e.agent_did, e.operation) for e in vfs.edit_log]))
        record(f"tables{round_}", wave_tables(wave))


@pytest.mark.parametrize("seed,isolation", [
    (0, "none"), (1, "none"), (2, "READ_COMMITTED"), (3, "SNAPSHOT"), (4, "SERIALIZABLE"),
])
def test_write_wave_sequence_matches_reference(seed, isolation):
    run_both(write_sequence, seed, isolation)


def _refill_off_grid(m: _Modules, record) -> None:
    vfs = m.mod("session.vfs").SessionVFS("session:offgrid")
    wave = m.write_wave(vfs)
    for i in range(161):  # ring 0: a burst of 200, 39 left at f32(0.9)
        wave.submit("did:r", f"/f{i % 8}", "x", ring=0)
    record("spend", wave.flush(now=0.9))
    wave.submit("did:r", "/g", "y", ring=0)
    record("refill", wave.flush(now=1.0))
    record("tables", wave_tables(wave))


def test_write_wave_refill_off_the_dyadic_grid_differs_from_the_jitted_reference():
    """The reference's WriteWave runs a jitted consume, whose XLA:CPU
    program fuses tokens + elapsed * rate into one multiply-add; the port
    rounds the product and the sum apart, as the reference's source is
    written (ROADMAP C.2). At 39 tokens, stamp f32(0.9) and now 1.0 the
    refilled bucket then differs by one ulp; every status, the VFS and
    every other column stay equal."""
    logs = []
    for pkg in (REF, PORT):
        log: list = []
        _refill_off_grid(_Modules(pkg), lambda label, value: log.append((label, norm(value))))
        logs.append(dict(log))
    ref, port = logs
    assert_logs_equal(list({k: ref[k] for k in ("spend", "refill")}.items()),
                      list({k: port[k] for k in ("spend", "refill")}.items()))
    want, got = dict(ref["tables"]), dict(port["tables"])
    w_tok, g_tok = want.pop("_rl_tokens"), got.pop("_rl_tokens")
    eager = jax_rate.consume(jnp.asarray([39.0], jnp.float32), jnp.asarray([0.9], jnp.float32),
                             jnp.asarray([0], jnp.int8), 1.0, 1.0).tokens
    assert g_tok[0] == np.asarray(eager)[0] == np.float32(48.0)
    assert w_tok[0] == np.nextafter(g_tok[0], np.float32(np.inf))
    assert g_tok[1:].tobytes() == w_tok[1:].tobytes()
    assert_logs_equal(list(want.items()), list(got.items()))


# ── tests/unit/test_locks_batched.py ─────────────────────────────────


def _t(values, dtype):
    return torch.tensor(values, dtype=dtype)


def test_conflict_gate_read_read_coexists_write_conflicts():
    res = locks.conflict_gate(
        held_path=_t([0, 1], torch.int32), held_agent=_t([0, 1], torch.int32),
        held_intent=_t([0, 1], torch.int8), held_active=_t([True, True], torch.bool),
        req_path=_t([0, 0, 1], torch.int32), req_agent=_t([2, 2, 2], torch.int32),
        req_intent=_t([0, 1, 0], torch.int8), n_agents=4)
    assert res.blocked.tolist() == [False, True, True]
    assert res.blockers[1].tolist() == [True, False, False, False]


def test_conflict_gate_own_locks_never_conflict():
    res = locks.conflict_gate(
        held_path=_t([0], torch.int32), held_agent=_t([2], torch.int32),
        held_intent=_t([2], torch.int8), held_active=_t([True], torch.bool),
        req_path=_t([0], torch.int32), req_agent=_t([2], torch.int32),
        req_intent=_t([1], torch.int8), n_agents=4)
    assert not bool(res.blocked[0])


def test_conflict_gate_inactive_locks_ignored():
    res = locks.conflict_gate(
        held_path=_t([0], torch.int32), held_agent=_t([0], torch.int32),
        held_intent=_t([2], torch.int8), held_active=_t([False], torch.bool),
        req_path=_t([0], torch.int32), req_agent=_t([1], torch.int32),
        req_intent=_t([2], torch.int8), n_agents=2)
    assert not bool(res.blocked[0])


def _closure_members(edges, n=4):
    wait = np.zeros((n, n), bool)
    for a, b in edges:
        wait[a, b] = True
    sweep = locks.deadlock_sweep(torch.from_numpy(wait), torch.zeros(1, dtype=torch.int32),
                                 torch.zeros((1, n), dtype=torch.bool),
                                 torch.from_numpy(np.linspace(0.9, 0.3, n).astype(np.float32)))
    return sweep.on_cycle.numpy(), int(sweep.victim)


def test_deadlock_sweep_two_cycle_detected():
    on, victim = _closure_members([(0, 1), (1, 0)])
    assert on.tolist() == [True, True, False, False]
    assert victim == 1  # lower sigma of the two members


def test_deadlock_sweep_long_cycle_detected():
    on, _ = _closure_members([(0, 1), (1, 2), (2, 3), (3, 0)])
    assert on.all()


def test_deadlock_sweep_chain_without_cycle_clean():
    on, victim = _closure_members([(0, 1), (1, 2)])
    assert not on.any() and victim == -1


def test_deadlock_sweep_request_closing_cycle_flagged():
    wait = np.zeros((3, 3), bool)
    wait[1, 0] = True
    blockers = np.zeros((2, 3), bool)
    blockers[0, 1] = True   # request 0 (agent 0) blocked by agent 1
    blockers[1, 2] = True   # request 1 (agent 0) blocked by agent 2
    sweep = locks.deadlock_sweep(torch.from_numpy(wait), _t([0, 0], torch.int32),
                                 torch.from_numpy(blockers), torch.full((3,), 0.5))
    assert sweep.would_deadlock.tolist() == [True, False]


def test_contention_counts_distinct_holders_per_path():
    counts = locks.contention_counts(
        held_path=_t([0, 0, 0, 1], torch.int32), held_agent=_t([0, 1, 0, 2], torch.int32),
        held_active=_t([True] * 4, torch.bool), n_paths=3, n_agents=4)
    assert counts.tolist() == [2, 1, 0]


def test_lock_wave_matches_sequential_manager():
    requests = [
        ("did:a", "/x", LockIntent.READ),
        ("did:b", "/x", LockIntent.READ),     # READ+READ coexists
        ("did:c", "/x", LockIntent.WRITE),    # contends
        ("did:a", "/y", LockIntent.EXCLUSIVE),
        ("did:b", "/y", LockIntent.READ),     # contends
    ]
    seq = IntentLockManager()
    seq_out = []
    for did, path, intent in requests:
        try:
            seq.acquire(did, S, path, intent)
            seq_out.append(LOCK_GRANTED)
        except Exception:
            seq_out.append(LOCK_CONTENTION)
    wave = LockWave(device="cpu")
    for did, path, intent in requests:
        wave.submit(did, S, path, intent)
    report = wave.flush()
    assert report.status.tolist() == seq_out
    assert report.blockers[2] == {"did:a", "did:b"}
    assert wave.manager.active_lock_count == seq.active_lock_count


def test_lock_wave_deadlock_refusal():
    wave = LockWave(device="cpu")
    wave.manager.declare_wait("did:b", {"did:a"})
    wave.manager.acquire("did:b", S, "/r", LockIntent.EXCLUSIVE)
    wave.submit("did:a", S, "/r", LockIntent.WRITE)
    assert wave.flush().status.tolist() == [LOCK_DEADLOCK]


def test_lock_wave_cross_path_deadlock_inside_one_batch():
    wave = LockWave(device="cpu")
    wave.manager.acquire("did:y", S, "/p1", LockIntent.EXCLUSIVE)
    wave.manager.acquire("did:x", S, "/p2", LockIntent.EXCLUSIVE)
    wave.submit("did:x", S, "/p1", LockIntent.WRITE)
    wave.submit("did:y", S, "/p2", LockIntent.WRITE)
    assert wave.flush().status.tolist() == [LOCK_CONTENTION, LOCK_DEADLOCK]
    assert wave.deadlock_report().on_cycle == []


def test_lock_wave_deadlock_report_names_lowest_sigma_victim():
    wave = LockWave(device="cpu")
    wave.observe_sigma("did:hi", 0.9)
    wave.observe_sigma("did:lo", 0.4)
    wave.manager.declare_wait("did:hi", {"did:lo"})
    wave.manager.declare_wait("did:lo", {"did:hi"})
    report = wave.deadlock_report()
    assert set(report.on_cycle) == {"did:hi", "did:lo"}
    assert report.victim == "did:lo"


def test_lock_wave_contention_counts_roundtrip():
    wave = LockWave(device="cpu")
    wave.submit("did:a", S, "/shared", LockIntent.READ)
    wave.submit("did:b", S, "/shared", LockIntent.READ)
    wave.submit("did:c", S, "/solo", LockIntent.WRITE)
    wave.flush()
    counts = wave.contention_counts()
    assert counts["/shared"] == 2 and counts["/solo"] == 1
    assert wave.manager.contention_points == ["/shared"]


def test_lock_wave_empty_flush():
    assert len(LockWave(device="cpu").flush().status) == 0


def test_lock_wave_capacity_guard():
    wave = LockWave(max_agents=1, device="cpu")
    wave.submit("did:a", S, "/x", LockIntent.READ)
    wave.submit("did:b", S, "/x", LockIntent.READ)
    with pytest.raises(RuntimeError, match="agent capacity"):
        wave.flush()


def test_deadlock_victim_feeds_kill_switch():
    from hypervisor_tpu_torch.security.kill_switch import KillReason, KillSwitch

    wave = LockWave(device="cpu")
    wave.observe_sigma("did:loop1", 0.8)
    wave.observe_sigma("did:loop2", 0.5)
    wave.manager.declare_wait("did:loop1", {"did:loop2"})
    wave.manager.declare_wait("did:loop2", {"did:loop1"})
    victim = wave.deadlock_report().victim
    assert victim == "did:loop2"
    record = KillSwitch().kill(victim, S, KillReason.MANUAL)
    assert record.agent_did == "did:loop2"
    assert wave.manager.release_agent_locks(victim, S) == 0  # only wait edges
    wave.manager._wait_for.pop(victim, None)
    assert wave.deadlock_report().victim is None


# ── tests/integration/test_security_waves.py: the write wave ─────────


def _wave(vfs, **kw) -> WriteWave:
    return WriteWave(vfs, device="cpu", **kw)


def test_write_wave_applies_and_attributes():
    vfs = SessionVFS("s1")
    wave = _wave(vfs)
    for i in range(4):
        wave.submit(f"did:a{i}", f"/f{i}.txt", f"content {i}")
    report = wave.flush(now=0.0)
    assert report.applied == 4 and not report.conflicts
    assert vfs.read("/f2.txt") == "content 2"
    assert vfs.edit_log[-1].agent_did == "did:a3"


def test_write_wave_stale_writer_rejected_fresh_after_observe():
    vfs = SessionVFS("s1")
    wave = _wave(vfs)
    wave.submit("did:w1", "/doc", "v1")
    assert wave.flush(now=0.0).applied == 1
    wave.submit("did:w2", "/doc", "v2-blind")
    report = wave.flush(now=1.0)
    assert report.status[0] == WRITE_CONFLICT
    assert vfs.read("/doc") == "v1"
    wave.observe("did:w2", "/doc")
    wave.submit("did:w2", "/doc", "v2-seen")
    assert wave.flush(now=2.0).applied == 1
    assert vfs.read("/doc") == "v2-seen"


def test_write_wave_same_wave_same_path_orders_sequentially():
    vfs = SessionVFS("s1")
    wave = _wave(vfs)
    wave.submit("did:w1", "/log", "first")
    wave.submit("did:w1", "/log", "second")
    assert list(wave.flush(now=0.0).status) == [WRITE_OK, WRITE_OK]
    assert vfs.read("/log") == "second"


def test_write_wave_rate_limit_gates_wave():
    vfs = SessionVFS("s1")
    wave = _wave(vfs)
    burst = int(PORT.DEFAULT_CONFIG.rate_limit.ring_bursts[3])  # ring 3 = 10
    for i in range(burst + 3):
        wave.submit("did:spammy", f"/f{i}", "x", ring=3)
    report = wave.flush(now=0.0)
    assert report.applied == burst and report.rate_limited == 3
    assert (report.status[burst:] == WRITE_RATE_LIMITED).all()


def test_write_wave_concurrent_writers_different_paths_all_land():
    vfs = SessionVFS("s1")
    wave = _wave(vfs)
    for i in range(8):
        wave.submit(f"did:w{i}", f"/own/{i}", f"v{i}", ring=1)
    assert wave.flush(now=0.0).applied == 8


def test_write_wave_refuses_quarantined_writer():
    vfs = SessionVFS("session:qw")
    held = {"did:frozen"}
    wave = _wave(vfs, is_quarantined=lambda did: did in held)
    wave.submit("did:frozen", "/a", "x", ring=2)
    wave.submit("did:free", "/b", "y", ring=2)
    report = wave.flush(now=0.0)
    assert report.status.tolist() == [WRITE_QUARANTINED, WRITE_OK]
    assert report.quarantined == 1 and report.applied == 1
    assert vfs.read("/b") == "y" and vfs.read("/a") is None


def test_managed_session_write_wave_prewired():
    """`ManagedSession.write_wave()` refuses device-quarantined writers
    with no predicate assembled by hand, on the state's device."""

    async def run():
        hv = PORT.Hypervisor(device="cpu")
        ms = await hv.create_session(PORT.SessionConfig(), creator_did="did:lead")
        sid = ms.sso.session_id
        await hv.join_session(sid, "did:iso", sigma_raw=0.8)
        await hv.join_session(sid, "did:ok", sigma_raw=0.8)
        await hv.activate_session(sid)
        row = hv.state.agent_row("did:iso")
        hv.state.quarantine_rows([row["slot"]], now=hv.state.now())
        wave = ms.write_wave()
        assert wave.device.type == "cpu" and wave._path_clocks.device.type == "cpu"
        wave.submit("did:iso", "/doc.md", "nope", ring=2)
        wave.submit("did:ok", "/doc.md", "yes", ring=2)
        report = wave.flush(now=hv.state.now())
        assert report.status.tolist() == [WRITE_QUARANTINED, WRITE_OK]
        assert ms.sso.vfs.read("/doc.md") == "yes"
        hv.state.quarantine_tick(now=hv.state.now() + 301.0)
        wave2 = ms.write_wave()
        wave2.submit("did:iso", "/doc2.md", "back", ring=2)
        assert wave2.flush(now=hv.state.now()).status.tolist() == [WRITE_OK]

    asyncio.run(run())


def test_isolation_snapshot_tolerates_causally_stale_writers():
    vfs = SessionVFS("session:iso-snap")
    wave = _wave(vfs, isolation=IsolationLevel.SNAPSHOT)
    wave.submit("did:w1", "/doc", "v1")
    assert wave.flush(now=0.0).applied == 1
    wave.submit("did:w2", "/doc", "v2-blind")
    report = wave.flush(now=1.0)
    assert report.status.tolist() == [WRITE_OK] and report.conflicts == 0
    assert vfs.read("/doc") == "v2-blind"


def test_isolation_read_committed_still_rejects_stale():
    vfs = SessionVFS("session:iso-rc")
    wave = _wave(vfs, isolation=IsolationLevel.READ_COMMITTED)
    wave.submit("did:w1", "/doc", "v1")
    wave.flush(now=0.0)
    wave.submit("did:w2", "/doc", "v2-blind")
    assert wave.flush(now=1.0).status.tolist() == [WRITE_CONFLICT]


def test_isolation_serializable_requires_write_lock():
    with pytest.raises(ValueError, match="lock_manager"):
        _wave(SessionVFS("x"), isolation=IsolationLevel.SERIALIZABLE)
    lock_mgr = IntentLockManager()
    vfs = SessionVFS("session:iso-ser")
    sid = vfs.session_id
    wave = _wave(vfs, isolation=IsolationLevel.SERIALIZABLE, lock_manager=lock_mgr)
    wave.submit("did:w1", "/doc", "v1")
    report = wave.flush(now=0.0)
    assert report.status.tolist() == [WRITE_LOCK_REQUIRED] and report.lock_required == 1
    lock_mgr.acquire("did:w1", sid, "/doc", LockIntent.READ)
    wave.submit("did:w1", "/doc", "v1")
    assert wave.flush(now=1.0).status.tolist() == [WRITE_LOCK_REQUIRED]
    lock_mgr.release_agent_locks("did:w1", sid)
    lock_mgr.acquire("did:w1", "session:other", "/doc", LockIntent.WRITE)
    wave.submit("did:w1", "/doc", "v1")
    assert wave.flush(now=2.0).status.tolist() == [WRITE_LOCK_REQUIRED]
    lock_mgr.acquire("did:w1", sid, "/doc", LockIntent.WRITE)
    wave.submit("did:w1", "/doc", "v1")
    assert wave.flush(now=3.0).status.tolist() == [WRITE_OK]
    assert vfs.read("/doc") == "v1"


def test_waves_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        assert LockWave().device.type == "cuda"
        assert WriteWave(SessionVFS("s")).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LockWave()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WriteWave(SessionVFS("s"))


# ── tests/integration/test_device_plane.py::TestStatusMapping ────────


def test_status_admission_codes_raise_reference_exceptions():
    from hypervisor_tpu_torch.ops import admission
    from hypervisor_tpu_torch.session import SessionLifecycleError, SessionParticipantError
    from hypervisor_tpu_torch.utils import status as S_

    S_.raise_for_status([0, 0, 0])
    with pytest.raises(SessionParticipantError, match="did:dup already"):
        S_.raise_for_status([0, admission.ADMIT_DUPLICATE], who=["did:a", "did:dup"])
    with pytest.raises(SessionLifecycleError):
        S_.raise_for_status([admission.ADMIT_BAD_STATE])
    with pytest.raises(RuntimeError, match="unknown status"):
        S_.raise_for_status([99])


def test_status_write_and_lock_tables():
    from hypervisor_tpu_torch.session.intent_locks import DeadlockError
    from hypervisor_tpu_torch.utils import status as S_

    with pytest.raises(S_.QuarantinedError):
        S_.raise_for_status([WRITE_QUARANTINED], table=S_.WRITE_ERRORS)
    with pytest.raises(DeadlockError):
        S_.raise_for_status([LOCK_DEADLOCK], table=S_.LOCK_ERRORS)
    assert sorted(S_.WRITE_ERRORS) == [WRITE_RATE_LIMITED, WRITE_CONFLICT, WRITE_QUARANTINED,
                                       WRITE_LOCK_REQUIRED]


def test_status_describe_labels():
    from hypervisor_tpu_torch.ops import admission
    from hypervisor_tpu_torch.utils import status as S_

    assert S_.describe([0, admission.ADMIT_CAPACITY, 42]) == [
        "ok", "SessionParticipantError", "unknown(42)"]


# ── test_hypothesis_properties.py::TestClockDualPlaneProperties ──────

_CLOCK_OPS = st.lists(
    st.tuples(st.sampled_from(["read", "write"]), st.integers(0, 2), st.integers(0, 2)),
    min_size=1, max_size=24,
)


@settings(max_examples=50, deadline=None)
@given(_CLOCK_OPS)
def test_clock_conflict_streams_match_host_and_reference(ops):
    """For any sequence of reads and strict writes, the port's host
    VectorClockManager, the port's WriteWave and the reference's WriteWave
    accept and reject the same writes."""
    from hypervisor_tpu.session.vfs import SessionVFS as JaxVFS
    from hypervisor_tpu_torch.session.vector_clock import (
        CausalViolationError,
        VectorClockManager,
    )

    host = VectorClockManager()
    wave = WriteWave(SessionVFS("session:ck"), strict=True, device="cpu")
    ref = jax_write_wave.WriteWave(JaxVFS("session:ck"), strict=True)
    agents = [f"did:c{i}" for i in range(3)]
    paths = [f"/p{i}" for i in range(3)]
    n_write = 0
    for op, who, where in ops:
        agent, path = agents[who], paths[where]
        if op == "read":
            host.read(path, agent)
            wave.observe(agent, path)
            ref.observe(agent, path)
            continue
        n_write += 1
        try:
            host.write(path, agent, strict=True)
            host_ok = True
        except CausalViolationError:
            host_ok = False
        for w in (wave, ref):
            w.submit(agent, path, f"v{n_write}", ring=0)  # a large budget
        dev_ok = wave.flush(now=float(n_write)).status[0] == WRITE_OK
        ref_ok = ref.flush(now=float(n_write)).status[0] == WRITE_OK
        assert bool(dev_ok) == host_ok == bool(ref_ok), (ops, op, who, where)
