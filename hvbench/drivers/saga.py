"""The saga plane: `SagaScheduler.run_until_settled` over the device
SagaTable, 10,000 concurrent sagas a call.

Set-up builds one state of the configuration's tables with its standing
actors (`facade_wave.place_actors`) and one standing session a saga of a
call (`create_sessions_batch`). A call, back to back:

  * creates the call's sagas, one on each standing session, in one
    `create_sagas` block (the sequential sagas) and one
    `create_sagas_from_dsl` block (the fan-out sagas);
  * wires their executors on a fresh `SagaScheduler` (no backoff), each
    step gated on its session's actor row;
  * runs `run_until_settled` on one event loop, then
    `torch.cuda.synchronize()`: the call's latency.

The executors are async stubs whose outcomes the seed decides
(`SagaTraffic`), as the upstream's benchmark stubs them: a step raises on
its first attempt, sleeps past its 0.01 s timeout on its first attempt,
always raises, or returns; a fan-out branch succeeds or raises; an undo
returns. Each counts its calls.

A kept call (`keep`) holds its sagas' rows of the table (all terminal, so
no later call moves them), its executors' counts, the rounds it took and
the recorder's `saga.*` counters over the call.

With spans on, the harness wraps the creation (`saga_create`), the
scheduler's reads of the table (`saga_reads`: `sagas_settled`,
`saga_work`, `fanout_dispatch`, `saga_timeouts`, `isolation_gate`), its
bookings (`saga_book`: `saga_round`, `fanout_settle`) and the whole of
`run_until_settled` (`scheduler`).
"""

from __future__ import annotations

import asyncio
import dataclasses
import functools
import json
import sys
import time
from collections import Counter

import numpy as np

from hvbench.drivers.facade_wave import hypervisor_config, place_actors
from hvbench.reference import Precision, differ
from hvbench.reference import saga as ref
from hvbench.trace import maybe_span

#: The columns of a saga's row that are compared.
ROW_FIELDS = ("step_state", "retries_left", "saga_state", "cursor")
READS = ("sagas_settled", "saga_work", "fanout_dispatch", "saga_timeouts", "isolation_gate")
BOOKINGS = ("saga_round", "fanout_settle")
POLICIES = ("all_must_succeed", "any_must_succeed", "majority_must_succeed")
POLICY_CODES = {"all_must_succeed": ref.POLICY_ALL, "majority_must_succeed": ref.POLICY_MAJORITY,
                "any_must_succeed": ref.POLICY_ANY}


class SagaTraffic:
    """The sagas of every call, made from the seed.

    Call c creates `sagas` sagas: the first N - N/`dsl_every` are
    sequential sagas of the traffic's `steps`, each of a kind drawn with
    the traffic's `kinds` shares (clean; one step raises once; one step
    times out once; the last step runs out of attempts; the same with no
    undo on the step `no_undo_step`), the failing step of the first two
    drawn from `fail_steps`; the rest are fan-out sagas, a group of
    `branches` branches under the policies ALL, ANY and MAJORITY in turn
    (each branch succeeding with probability `branch_success`) and then
    `dsl_tail` sequential steps."""

    def __init__(self, config: dict, traffic: dict, seed: int) -> None:
        self.seed = int(seed)
        self.n = int(traffic["sagas"])
        self.n_dsl = self.n // int(traffic["dsl_every"])
        self.n_seq = self.n - self.n_dsl
        self.m = int(config["capacity"]["max_steps_per_saga"])
        self.steps = traffic["steps"]
        self.kinds = traffic["kinds"]
        self.fail_steps = np.asarray(traffic["fail_steps"], np.int64)
        self.no_undo_step = int(traffic["no_undo_step"])
        self.timeout_s = float(traffic["timeout_s"])
        self.branches = int(traffic["branches"])
        self.branch_success = float(traffic["branch_success"])
        self.dsl_tail = int(traffic["dsl_tail"])
        # One step list object a variant: rows of one variant share it.
        s = len(self.steps)
        base = [dict(st) for st in self.steps]
        no_undo = [dict(st) for st in self.steps]
        no_undo[self.no_undo_step]["has_undo"] = False
        timed = []
        for j in range(s):
            v = [dict(st) for st in self.steps]
            v[j]["timeout"] = self.timeout_s
            timed.append(v)
        self.variants = {"base": base, "no_undo": no_undo,
                         **{f"timeout{j}": v for j, v in enumerate(timed)}}

    def kind_names(self) -> list:
        return [k["name"] for k in self.kinds]

    def draw(self, c: int) -> dict:
        """Call c's draws: each sequential saga's kind and failing step,
        each fan-out branch's outcome."""
        g = np.random.default_rng(np.random.SeedSequence([self.seed, 4, int(c)]))
        p = np.array([k["share"] for k in self.kinds], np.float64)
        kind = g.choice(len(self.kinds), self.n_seq, p=p / p.sum())
        fail = self.fail_steps[g.integers(0, len(self.fail_steps), self.n_seq)]
        branch_ok = g.uniform(size=(self.n_dsl, self.branches)) < self.branch_success
        return {"kind": kind, "fail_step": fail, "branch_ok": branch_ok}

    def seq_steps(self, d: dict) -> list:
        """The step list object of each sequential saga."""
        names = self.kind_names()
        out = []
        for k, f in zip(d["kind"].tolist(), d["fail_step"].tolist()):
            name = names[k]
            if name == "escalate":
                out.append(self.variants["no_undo"])
            elif name == "timeout_once":
                out.append(self.variants[f"timeout{f}"])
            else:
                out.append(self.variants["base"])
        return out

    def dsl_spec(self, policy: str) -> dict:
        """The DSL definition of a fan-out saga (its saga id set per saga)."""
        b = [{"id": f"b{i}", "action_id": f"svc.branch{i}", "agent": "did:saga",
              "undo_api": f"/undo/b{i}"} for i in range(self.branches)]
        t = [{"id": f"t{i}", "action_id": f"svc.tail{i}", "agent": "did:saga",
              "undo_api": f"/undo/t{i}"} for i in range(self.dsl_tail)]
        return {"name": "fanout", "session_id": "saga", "saga_id": "saga:template",
                "steps": b + t,
                "fan_out": [{"policy": policy, "branches": [s["id"] for s in b]}]}

    def modes(self, d: dict) -> np.ndarray:
        """i8[N, M]: each forward executor's behaviour (`ref.OK` ...)."""
        names = self.kind_names()
        mode = np.zeros((self.n, self.m), np.int8)
        kind = np.array(names, object)[d["kind"]]
        seq = np.arange(self.n_seq)
        last = len(self.steps) - 1
        for name, code in (("fail_once", ref.FAIL_FIRST), ("timeout_once", ref.TIMEOUT_FIRST)):
            sel = seq[kind == name]
            mode[sel, d["fail_step"][sel]] = code
        sel = seq[(kind == "compensate") | (kind == "escalate")]
        mode[sel, last] = ref.FAIL_ALWAYS
        mode[self.n_seq:, :self.branches] = np.where(d["branch_ok"], ref.OK, ref.FAIL_ALWAYS)
        return mode

    def plan(self, c: int) -> dict:
        """Call c as the reference takes it: every saga's row, its
        executors' behaviour (`ref.OK` ...) and its fan-out groups."""
        d = self.draw(c)
        n, m = self.n, self.m
        retries = np.zeros((n, m), np.int8)
        has_undo = np.zeros((n, m), bool)
        n_steps = np.zeros(n, np.int32)
        for i, sts in enumerate(self.seq_steps(d)):
            n_steps[i] = len(sts)
            for j, st in enumerate(sts):
                retries[i, j] = st.get("retries", 0)
                has_undo[i, j] = st.get("has_undo", False)
        groups = {}
        k = self.branches + self.dsl_tail
        for e in range(self.n_dsl):
            i = self.n_seq + e
            n_steps[i] = k
            has_undo[i, :k] = True
            groups[i] = [(POLICY_CODES[POLICIES[e % 3]], list(range(self.branches)))]
        return {"retries": retries, "has_undo": has_undo, "n_steps": n_steps,
                "mode": self.modes(d), "undo": has_undo.copy(), "groups": groups}


class Executors:
    """One call's executor stubs and their counts."""

    def __init__(self, mode: np.ndarray, sleep_s: float) -> None:
        self.mode = mode
        self.sleep_s = sleep_s
        self.attempts = np.zeros(mode.shape, np.int32)
        self.undos = np.zeros(mode.shape, np.int32)

    async def forward(self, i: int, j: int):
        n = self.attempts[i, j] = self.attempts[i, j] + 1
        mode = self.mode[i, j]
        if mode == ref.FAIL_ALWAYS or (mode == ref.FAIL_FIRST and n == 1):
            raise RuntimeError(f"saga {i} step {j} attempt {n} failed")
        if mode == ref.TIMEOUT_FIRST and n == 1:
            await asyncio.sleep(self.sleep_s)
        return int(n)

    async def undo(self, i: int, j: int):
        self.undos[i, j] += 1
        return "undone"


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, spans=None) -> None:
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.spans = device, spans
        self.gen = SagaTraffic(config, traffic, seed)
        self.sessions_per_call = self.gen.n
        self.calls = 0
        self.last = None
        self.rounds: list = []
        self.readback: list = []
        self.setup_stages: dict = {}

    def sync(self) -> None:
        import torch

        if self.state.device.type == "cuda":
            torch.cuda.synchronize(self.state.device)

    def setup(self) -> None:
        from hypervisor_tpu_torch.models import SessionConfig
        from hypervisor_tpu_torch.saga.dsl import SagaDSLParser
        from hypervisor_tpu_torch.state import HypervisorState

        t = time.perf_counter()
        self.state = HypervisorState(hypervisor_config(self.config), device=self.device)
        self.sync()
        self.setup_stages["state"] = time.perf_counter() - t
        t = time.perf_counter()
        self.actor_rows = place_actors(self.state, self.config)
        self.sessions = self.state.create_sessions_batch(
            [f"saga:s{i}" for i in range(self.gen.n)], SessionConfig())
        self.sync()
        self.setup_stages["actors_sessions"] = time.perf_counter() - t
        parser = SagaDSLParser()
        self.templates = [parser.parse(self.gen.dsl_spec(p)) for p in POLICIES]
        self.loop = asyncio.new_event_loop()
        if self.spans is not None:
            self._wrap_layers()
        t = time.perf_counter()
        for _ in range(int(self.traffic["warmup_calls"])):
            self.call()
        self.sync()
        self.setup_stages["warmup_calls"] = time.perf_counter() - t

    def _wrap_layers(self) -> None:
        st, sp = self.state, self.spans
        for name in READS:
            setattr(st, name, sp.wrap("saga_reads", getattr(st, name)))
        for name in BOOKINGS:
            setattr(st, name, sp.wrap("saga_book", getattr(st, name)))

    def call(self) -> float:
        """One call: create, wire, run to the end; returns its ms (host
        clock, synchronised)."""
        from hypervisor_tpu_torch.observability import profiling
        from hypervisor_tpu_torch.runtime.saga_scheduler import SagaScheduler

        c, g, st = self.calls, self.gen, self.state
        d = g.draw(c)
        plan_mode = g.modes(d)
        seq_steps = g.seq_steps(d)
        ids = [f"c{c}:g{i}" for i in range(g.n)]
        defs = [dataclasses.replace(self.templates[e % 3], saga_id=ids[g.n_seq + e])
                for e in range(g.n_dsl)]
        before = profiling.span_totals()["counters"]
        t = time.perf_counter_ns()
        with maybe_span(self.spans, "saga_create"):
            slots = st.create_sagas(ids[:g.n_seq], self.sessions[:g.n_seq], seq_steps)
            dsl_slots = st.create_sagas_from_dsl(defs, self.sessions[g.n_seq:])
        ex = Executors(plan_mode, float(self.traffic["timeout_sleep_s"]))
        sched = SagaScheduler(st, retry_backoff_seconds=float(self.traffic["backoff_s"]))
        actors = self.actor_rows
        for i, (slot, sts) in enumerate(zip(slots.tolist(), seq_steps)):
            for j, step in enumerate(sts):
                sched.register(slot, j, functools.partial(ex.forward, i, j),
                               undo=functools.partial(ex.undo, i, j) if step["has_undo"]
                               else None, agent_slot=int(actors[i]))
        k = g.branches + g.dsl_tail
        for e, slot in enumerate(dsl_slots.tolist()):
            i = g.n_seq + e
            for j in range(k):
                sched.register(slot, j, functools.partial(ex.forward, i, j),
                               undo=functools.partial(ex.undo, i, j), agent_slot=int(actors[i]))
        with maybe_span(self.spans, "scheduler"):
            rounds = self.loop.run_until_complete(sched.run_until_settled())
        self.sync()
        ms = (time.perf_counter_ns() - t) / 1e6
        after = profiling.span_totals()["counters"]
        counters = {n: after.get(n, 0) - before.get(n, 0)
                    for n in ref.COUNTERS + ("saga.readback_rows",)}
        self.rounds.append(rounds)
        self.readback.append(counters["saga.readback_rows"])
        self.last = {"base": int(slots[0]) if len(slots) else int(dsl_slots[0]),
                     "attempts": ex.attempts, "undos": ex.undos, "rounds": rounds,
                     "counters": counters}
        self.calls += 1
        return ms

    def keep(self) -> dict:
        """The last call's sagas' rows (terminal: no later call moves
        them), read now, with its counts, rounds and counters."""
        base, n, sg = self.last["base"], self.gen.n, self.state.sagas
        rows = {f: getattr(sg, f)[base:base + n].cpu().numpy() for f in ROW_FIELDS}
        return {**self.last, **rows}

    def roofline_work(self) -> list:
        """B7's work a call: one round over the call's live sagas, at the
        table's steps a saga, for each round the warm-up calls took."""
        rounds = max(self.rounds) if self.rounds else 1
        return [("saga_tick_block", dict(sagas=self.gen.n, steps=self.gen.m))] * rounds

    def collect(self, kept: dict) -> dict:
        st = self.state
        cap = st.sagas.saga_state.shape[0]
        stats = {"saga_stats": {"calls": self.calls, "sagas_created": st._next_saga_slot,
                                "max_sagas": cap, "rounds_per_call": sorted(set(self.rounds)),
                                "readback_rows_per_call_max": max(self.readback, default=0),
                                "readback_rows_per_round_max": max(
                                    (r / max(n, 1) for r, n in zip(self.readback, self.rounds)),
                                    default=0)}}
        print(json.dumps(stats), file=sys.stderr)
        for name in READS + BOOKINGS:
            st.__dict__.pop(name, None)
        self.loop.close()
        self.state = self.last = None
        return {"calls": self.calls, "kept": kept}


def reference_record(config: dict, traffic: dict, seed: int, calls: int, kept_calls,
                     prec: Precision) -> dict:
    """What a sound program's `collect` would return, from the reference.
    The saga plane computes no float: `prec` rounds nothing."""
    g = SagaTraffic(config, traffic, seed)
    kept = {}
    for c in kept_calls:
        want = ref.run_call(g.plan(c))
        kept[c] = {**{f: want[f] for f in ROW_FIELDS}, "attempts": want["attempts"],
                   "undos": want["undos"], "rounds": want["rounds"],
                   "counters": want["counters"]}
    return {"calls": calls, "kept": kept}


def judge(config: dict, traffic: dict, seed: int, rec: dict, window_calls: int):
    """(checks, failed calls): every kept call's sagas, executor counts,
    rounds and counters against the reference's; every limit 0."""
    g = SagaTraffic(config, traffic, seed)
    bad, failed = Counter(), set()
    for c, got in rec["kept"].items():
        want = ref.run_call(g.plan(c))
        rows = np.zeros(g.n, bool)
        for f in ROW_FIELDS:
            rows |= differ(got[f], want[f])
        counts = differ(got["attempts"], want["attempts"]) | differ(got["undos"], want["undos"])
        tallies = sum(int(got["counters"].get(k, -1) != want["counters"][k])
                      for k in ref.COUNTERS)
        bad["sagas"] += int(rows.sum())
        bad["executor_counts"] += int(counts.sum())
        bad["rounds"] += int(int(got["rounds"]) != int(want["rounds"]))
        bad["counters"] += tallies
        if rows.any() or counts.any() or tallies or int(got["rounds"]) != int(want["rounds"]):
            failed.add(c)
    bad["missing_calls"] = max(0, min(int(traffic["check_calls"]), window_calls)
                               - len(rec["kept"]))
    names = ("sagas", "executor_counts", "rounds", "counters", "missing_calls")
    return {n: {"value": int(bad[n]), "limit": 0} for n in names}, failed
