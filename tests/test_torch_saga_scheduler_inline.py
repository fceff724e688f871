"""The saga scheduler's inline path, against the JAX package's scheduler.

The port's `SagaScheduler` steps each executor once inline and hands to
the event loop only the ones that suspend; the JAX package's scheduler
awaits every executor in a task of its own under `asyncio.wait_for`.
Each case runs one sequence on both (the port on `device="cpu"`, the
reference unarmed) and holds the port to the reference: every SagaTable
column, the metrics counters and the TraceLog words, the scheduler's
results, errors and attempt counts, and the order in which executors
start. The port's `saga.*` counters are held to what the executors saw.

* One round mix: executors that return, raise, raise `TimeoutError`
  themselves, suspend and return, suspend past their timeout, suspend and
  raise, retry, compensate with an undo that suspends, a missing undo, an
  isolation-gate refusal and a fan-out group; with no backoff and with
  one above zero.
* A step that sleeps 0.05 s under a 0.01 s timeout times out when the
  rest of the round's inline pass outlasts its sleep.
* A `ContextVar` one executor sets is not seen by the next, nor by the
  caller; a suspended executor keeps its own.
* What an executor binds to `asyncio.current_task()` on its first step
  (an `asyncio.timeout` of its own) is the task that finishes it.
"""

from __future__ import annotations

import asyncio
import contextvars
import itertools
import secrets
import time

import numpy as np
import pytest

from hypervisor_tpu import config as jax_config
from hypervisor_tpu.state import HypervisorState as JaxState
from hypervisor_tpu.tables.state import FLAG_ACTIVE, FLAG_QUARANTINED
from hypervisor_tpu_torch.observability import profiling
from tests.test_torch_saga import CAP, _fan_definition, _Port, _Ref, port_state

QUARANTINED_ROW = 5
COUNTERS = ("saga.attempts", "saga.retries", "saga.timeouts", "saga.undo_attempts",
            "saga.gate_refusals", "saga.inline", "saga.suspended")


@pytest.fixture
def fresh_ids(monkeypatch):
    """Trace ids that count from 0; calling the fixture's value restarts them."""
    ids = {"next": itertools.count()}
    monkeypatch.setenv("HV_WAVE_PALLAS", "0")
    monkeypatch.delenv("HV_TRACE", raising=False)
    monkeypatch.delenv("HV_TRACE_SAMPLE", raising=False)
    monkeypatch.setattr(secrets, "token_hex",
                        lambda nbytes=None: f"{next(ids['next']):0{2 * nbytes}x}")

    def restart():
        ids["next"] = itertools.count()
    return restart


def _settle(side, sched) -> dict:
    """Run the scheduler to the end; the port's `saga.*` tallies over it."""
    before = profiling.span_totals()["counters"]
    asyncio.run(sched.run_until_settled())
    after = profiling.span_totals()["counters"]
    return {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS}


class _Log:
    """Executors that log each start as `tag#attempt` in one shared list."""

    def __init__(self) -> None:
        self.ran: list = []
        self.late: list = []   # what ran after a suspension, sorted when compared

    def executor(self, tag, *, sleep=None, raises=None, first=None, then=None):
        """Returns `then` (or a text of the tag), or raises `raises`;
        `first` is what the first attempt does before that ('raise': fail,
        'sleep': sleep 1 s); `sleep` suspends before the outcome (0 is one
        pass of the loop)."""
        runs = {"n": 0}

        async def run():
            runs["n"] += 1
            n = runs["n"]
            self.ran.append(f"{tag}#{n}")
            if n == 1 and first == "raise":
                raise RuntimeError(f"{tag} transient")
            if n == 1 and first == "sleep":
                await asyncio.sleep(1.0)
                self.late.append(f"{tag}#{n} woke")
            if sleep is not None:
                await asyncio.sleep(sleep)
                self.late.append(f"{tag}#{n} woke")
            if raises is not None:
                raise raises
            return then if then is not None else f"{tag} ok"

        return run


def _mixed(side, backoff: float) -> dict:
    st = side.st
    log = _Log()
    ex = log.executor
    sess = st.create_session("s:mix", side.models.SessionConfig())
    sched = side.scheduler(st, retry_backoff_seconds=backoff)
    side.set_flags(QUARANTINED_ROW, FLAG_ACTIVE | FLAG_QUARANTINED)
    slots = {}

    def saga(name, steps):
        slots[name] = st.create_saga(f"saga:{name}", sess, steps)
        return slots[name]

    g = saga("returns", [{"has_undo": True}, {}])
    sched.register(g, 0, ex("returns.0"), undo=ex("undo returns.0"))
    sched.register(g, 1, ex("returns.1", then=7))
    g = saga("raises", [{"has_undo": True}, {"retries": 1}])
    sched.register(g, 0, ex("raises.0"), undo=ex("undo raises.0", sleep=0))
    sched.register(g, 1, ex("raises.1", raises=RuntimeError("permanent")))
    g = saga("own_timeout", [{"retries": 1}])
    sched.register(g, 0, ex("own_timeout.0", raises=TimeoutError("its own")))
    g = saga("suspends", [{"timeout": 5.0}, {}])
    sched.register(g, 0, ex("suspends.0", sleep=0.001))
    sched.register(g, 1, ex("suspends.1", sleep=0))
    g = saga("late", [{"retries": 1, "timeout": 0.01}, {}])
    sched.register(g, 0, ex("late.0", first="sleep"))
    sched.register(g, 1, ex("late.1"))
    g = saga("suspends_raises", [{"has_undo": True}, {"timeout": 5.0}])
    sched.register(g, 0, ex("suspends_raises.0"), undo=ex("undo suspends_raises.0", sleep=0.001))
    sched.register(g, 1, ex("suspends_raises.1", sleep=0, raises=ValueError("late failure")))
    g = saga("retry", [{"retries": 2}, {"has_undo": True}])
    sched.register(g, 0, ex("retry.0", first="raise"))
    sched.register(g, 1, ex("retry.1"), undo=ex("undo retry.1"))
    g = saga("no_undo", [{"has_undo": True}, {}])
    sched.register(g, 0, ex("no_undo.0"))  # an undo API on the table, none wired
    sched.register(g, 1, ex("no_undo.1", raises=RuntimeError("down")))
    g = saga("gated", [{"retries": 1}])
    sched.register(g, 0, ex("gated.0"), agent_slot=QUARANTINED_ROW)
    definition = _fan_definition(side, "all_must_succeed", 3, True, "saga:fan")
    g = slots["fan"] = st.create_saga_from_dsl(definition, sess)
    sched.register_definition(g, definition, {
        "b0": ex("fan.b0"), "b1": ex("fan.b1", sleep=0.001), "b2": ex("fan.b2", sleep=0),
        "finish": ex("fan.finish")}, undos={f"b{i}": ex(f"undo fan.b{i}") for i in range(3)})
    tallies = _settle(side, sched)
    return {"snapshot": side.snapshot(), "results": dict(sched.results),
            "errors": dict(sched.errors), "attempts": dict(sched._attempts), "ran": log.ran,
            "late": sorted(log.late), "slots": slots, "tallies": tallies}


def _both(run, restart_ids):
    ref = run(_Ref())
    restart_ids()
    return ref, run(_Port())


def _same(ref: dict, port: dict) -> None:
    for key in ("results", "errors", "attempts", "ran", "late", "slots"):
        assert port[key] == ref[key], key
    assert sorted(port["snapshot"]) == sorted(ref["snapshot"])
    for name, want in ref["snapshot"].items():
        got = np.asarray(port["snapshot"][name])
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), f"{name} diverged"


@pytest.mark.parametrize("backoff", [0.0, 0.002])
def test_a_mixed_round_matches_the_reference(fresh_ids, backoff):
    ref, port = _both(lambda side: _mixed(side, backoff), fresh_ids)
    _same(ref, port)
    ran, errors, s = port["ran"], port["errors"], port["slots"]
    # A round's retries start after its first attempts, wherever they stand
    # in the work list (own_timeout's row comes before suspends').
    assert s["own_timeout"] < s["suspends"]
    assert ran.index("suspends.1#1") < ran.index("own_timeout.0#2")
    assert errors[(s["own_timeout"], 0)] == "its own"
    assert errors[(s["late"], 0)] == ""           # the step timed out
    assert errors[(s["suspends_raises"], 1)] == "late failure"
    assert errors[(s["no_undo"], 0)] == "No undo API"
    assert errors[(s["gated"], 0)] == "agent is quarantined (read-only isolation)"
    assert port["results"][(s["returns"], 1)] == 7
    assert port["results"][(s["late"], 0)] == "late.0 ok"

    t = port["tallies"]
    forward = [r for r in ran if not r.startswith("undo ")]
    assert t["saga.attempts"] == len(forward)
    assert t["saga.retries"] == sum(not r.endswith("#1") for r in forward)
    assert t["saga.undo_attempts"] == len(ran) - len(forward)
    assert t["saga.gate_refusals"] == 2
    assert t["saga.timeouts"] == 3               # two of its own, one past its timeout
    assert t["saga.inline"] + t["saga.suspended"] == t["saga.attempts"] + t["saga.undo_attempts"]
    # What suspends: suspends.0/.1, late.0#1, suspends_raises.1, its undo,
    # the undo of raises.0, fan.b1 and fan.b2; with a backoff, every retry.
    assert t["saga.suspended"] == 8 + (t["saga.retries"] if backoff else 0)


def _long_pass(side, n_inline: int) -> dict:
    """One round: a step that sleeps 0.05 s under a 0.01 s timeout, then
    `n_inline` executors that settle inline, the last of which holds the
    thread for 0.06 s, so the pass outlasts the sleep."""
    st = side.st
    sess = st.create_session("s:long", side.models.SessionConfig())
    sched = side.scheduler(st, retry_backoff_seconds=0.0)
    seen = {"woke": False, "t0": None, "t1": None}

    async def sleeper():
        seen["t0"] = time.perf_counter()
        await asyncio.sleep(0.05)
        seen["woke"] = True
        return "late"

    async def quick():
        return "ok"

    async def hold():
        time.sleep(0.06)
        seen["t1"] = time.perf_counter()
        return "held"

    first = st.create_saga("saga:sleeper", sess, [{"timeout": 0.01}])
    sched.register(first, 0, sleeper)
    if hasattr(st, "create_sagas"):
        rows = st.create_sagas([f"saga:q{i}" for i in range(n_inline)], [sess] * n_inline,
                               [[{}]] * n_inline).tolist()
    else:
        rows = [st.create_saga(f"saga:q{i}", sess, [{}]) for i in range(n_inline)]
    for row in rows[:-1]:
        sched.register(row, 0, quick)
    sched.register(rows[-1], 0, hold)
    tallies = _settle(side, sched)
    assert seen["t1"] - seen["t0"] > 0.05, "the inline pass did not outlast the sleep"
    return {"errors": dict(sched.errors), "results": dict(sched.results),
            "woke": seen["woke"], "first": first, "tallies": tallies}


@pytest.mark.parametrize("side, n_inline", [("ref", 64), ("port", 4000)])
def test_a_timeout_counts_from_the_step_start_not_from_the_end_of_the_pass(
        fresh_ids, side, n_inline):
    run = object.__new__(_Ref if side == "ref" else _Port)
    cap = {**CAP, "max_sagas": n_inline + 8}
    run.st = port_state(cap) if side == "port" else JaxState(jax_config.HypervisorConfig(
        capacity=jax_config.TableCapacity(**cap, max_elevations=8, event_log_capacity=16)))
    out = _long_pass(run, n_inline)
    key = (out["first"], 0)
    assert out["errors"] == {key: ""} and key not in out["results"]
    assert not out["woke"]                        # cancelled, not left running
    assert len(out["results"]) == n_inline
    if side == "port":
        assert out["tallies"]["saga.timeouts"] == 1
        assert out["tallies"]["saga.suspended"] == 1
        assert out["tallies"]["saga.inline"] == n_inline


VAR = contextvars.ContextVar("saga_test_var", default="unset")


def _context(side) -> dict:
    st = side.st
    sess = st.create_session("s:ctx", side.models.SessionConfig())
    sched = side.scheduler(st, retry_backoff_seconds=0.0)
    seen = []

    def setter(tag, suspend):
        async def run():
            seen.append((tag, "start", VAR.get()))
            VAR.set(tag)
            if suspend:
                await asyncio.sleep(0)
                seen.append((tag, "resumed", VAR.get()))
            return tag
        return run

    for i, suspend in enumerate((False, True, False, True, False)):
        g = st.create_saga(f"saga:ctx{i}", sess, [{}])
        sched.register(g, 0, setter(f"e{i}", suspend))
    VAR.set("caller")
    asyncio.run(sched.run_until_settled())
    after = VAR.get()
    VAR.set("unset")
    return {"seen": seen, "after": after, "results": dict(sched.results)}


def test_a_context_var_set_by_one_executor_is_not_seen_by_the_next(fresh_ids):
    ref, port = _both(_context, fresh_ids)
    assert port == ref
    starts = [v for _, what, v in port["seen"] if what == "start"]
    assert starts == ["caller"] * 5
    assert all(v == tag for tag, what, v in port["seen"] if what == "resumed")
    assert port["after"] == "caller"


def _own_task(side) -> dict:
    """Executors that open an `asyncio.timeout` of their own on their first
    step and suspend past it; one more that records its task."""
    st = side.st
    sess = st.create_session("s:task", side.models.SessionConfig())
    sched = side.scheduler(st, retry_backoff_seconds=0.0)
    tasks = {}

    def bounded(tag, limit):
        async def run():
            tasks[tag] = asyncio.current_task()
            async with asyncio.timeout(limit):
                await asyncio.sleep(0.2)
            return tag
        return run

    for i, limit in enumerate((0.01, 1.0, 0.02)):
        g = st.create_saga(f"saga:task{i}", sess, [{"timeout": 5.0}])
        sched.register(g, 0, bounded(f"t{i}", limit))
    caller = {}

    async def main():
        caller["task"] = asyncio.current_task()
        return await sched.run_until_settled()

    asyncio.run(main())
    distinct = len({id(t) for t in tasks.values()} | {id(caller["task"])})
    return {"errors": dict(sched.errors), "results": dict(sched.results), "distinct": distinct,
            "states": side.snapshot()["sagas.saga_state"].tolist()}


def test_an_executors_own_timeout_binds_to_the_task_that_finishes_it(fresh_ids):
    ref, port = _both(_own_task, fresh_ids)
    assert port == ref
    assert len(port["errors"]) == 2 and set(port["errors"].values()) == {""}
    assert list(port["results"].values()) == ["t1"]
    assert port["distinct"] == 4   # one task per suspended executor, none the caller's
