"""Host asyncio scheduler driving real executors against the device
SagaTable (`hypervisor_tpu.runtime.saga_scheduler`).

The device table is the state machine and the host only supplies
executor outcomes: each round, `HypervisorState.saga_work()` names the
cursor steps (forward) and the reverse-order compensation targets, and
`fanout_dispatch()` the branches of every fan-out group front; this
scheduler runs ALL of their executors concurrently under their per-step
timeouts, `fanout_settle` books the branches as whole groups, and one
`saga_round` (kernel B7 on CUDA) books every other outcome at once.
Retries back off linearly.

A round starts its executors in work-list order (cursor steps, branches,
compensations; then the retries of a zero backoff) and steps each one
inline, in a copy of the context as a task would. An executor that
returns or raises on that first step is settled there: it costs no task,
no timer and no pass of the event loop. One that suspends is finished
under a deadline taken when it started, in the task that stepped it,
while a new task goes on with the rest of the round; the round then
awaits the executors that suspended, which overlap as they always did.
A retry with a backoff above zero sleeps in a task of its own and runs
under `asyncio.wait_for`.

A call of `run_until_settled` is the span `saga_scheduler`, each round
its child `round` and the round's executors `round/executors`; each
round adds its tallies to the recorder's counters `saga.rounds`,
`saga.attempts` (forward attempts), `saga.retries` (forward attempts
after a step's first), `saga.timeouts`, `saga.undo_attempts`,
`saga.gate_refusals`, `saga.inline` (attempts settled on their first
step) and `saga.suspended` (attempts handed to the event loop)
(`observability.profiling`). `saga.inline + saga.suspended` is
`saga.attempts + saga.undo_attempts`.
"""

from __future__ import annotations

import asyncio
import contextvars
import types
from collections import Counter
from typing import Any, Awaitable, Callable, Optional

from hypervisor_tpu_torch.observability import profiling
from hypervisor_tpu_torch.ops import saga_ops
from hypervisor_tpu_torch.state import HypervisorState

Executor = Callable[[], Awaitable[Any]]


class SagaScheduler:
    """Batched saga scheduler: executors keyed by (saga_slot, step_idx)."""

    def __init__(self, state: HypervisorState, retry_backoff_seconds: float = 1.0) -> None:
        self._state = state
        self._backoff = retry_backoff_seconds
        self._execute: dict[tuple[int, int], Executor] = {}
        self._undo: dict[tuple[int, int], Executor] = {}
        self._attempts: dict[tuple[int, int], int] = {}
        self._agent_of: dict[tuple[int, int], int] = {}
        self.results: dict[tuple[int, int], Any] = {}
        self.errors: dict[tuple[int, int], str] = {}
        self._tally: Counter = Counter()  # this round's, for the recorder's counters

    def register(
        self,
        saga_slot: int,
        step_idx: int,
        execute: Executor,
        undo: Optional[Executor] = None,
        agent_slot: Optional[int] = None,
    ) -> None:
        """Wire one step's executors. `agent_slot` names the acting
        membership's device row and arms the isolation gate: before each
        FORWARD dispatch a quarantined or breaker-tripped agent's step
        fails without its executor running (compensations still run).
        Steps registered without an agent row run ungated."""
        self._execute[(saga_slot, step_idx)] = execute
        if undo is not None:
            self._undo[(saga_slot, step_idx)] = undo
        if agent_slot is not None:
            self._agent_of[(saga_slot, step_idx)] = agent_slot

    def register_definition(
        self,
        saga_slot: int,
        definition,
        executors: dict[str, Executor],
        undos: Optional[dict[str, Executor]] = None,
        agent_slots: Optional[dict[str, int]] = None,
    ) -> None:
        """Wire a parsed SagaDefinition's steps to executors by step id
        (pairs with `HypervisorState.create_saga_from_dsl`)."""
        undos = undos or {}
        agent_slots = agent_slots or {}
        for idx, step in enumerate(definition.steps):
            execute = executors.get(step.id)
            if execute is None:
                raise KeyError(f"no executor for DSL step '{step.id}'")
            self.register(
                saga_slot, idx, execute, undo=undos.get(step.id),
                agent_slot=agent_slots.get(step.id),
            )

    def reassign(
        self,
        saga_slot: int,
        step_idx: int,
        execute: Executor,
        undo: Optional[Executor] = None,
        retries: Optional[int] = None,
        agent_slot: Optional[int] = None,
    ) -> None:
        """Hand a step to a substitute executor (kill-switch handoff).

        The substitute takes FULL ownership: the victim's undo is dropped
        when no substitute undo is given, the backoff bookkeeping resets,
        the device retry budget resets to `retries` when given, and a step
        the victim already drove to FAILED is rearmed to PENDING while its
        saga still runs and the cursor can still reach it. The victim's
        isolation-gate binding is dropped; `agent_slot` arms the gate on
        the substitute's own row.
        """
        key = (saga_slot, step_idx)
        self._agent_of.pop(key, None)
        self.register(saga_slot, step_idx, execute, undo=undo, agent_slot=agent_slot)
        if undo is None:
            self._undo.pop(key, None)
        self._attempts.pop(key, None)
        self.errors.pop(key, None)

        sagas = self._state.sagas
        if retries is not None:
            sagas.retries_left[saga_slot, step_idx] = retries
        step_val = int(sagas.step_state[saga_slot, step_idx])
        saga_val = int(sagas.saga_state[saga_slot])
        cursor_val = int(sagas.cursor[saga_slot])
        if (
            step_val == saga_ops.STEP_FAILED
            and saga_val == saga_ops.SAGA_RUNNING
            # A FAILED fan-out minority branch behind the cursor stays
            # FAILED: no dispatcher would ever issue its substitute.
            and step_idx >= cursor_val
        ):
            sagas.step_state[saga_slot, step_idx] = saga_ops.STEP_PENDING

    def apply_handoffs(
        self,
        kill_result,
        step_index: dict[tuple[str, str], tuple[int, int]],
        substitute_executors: dict[str, Executor],
        substitute_undos: Optional[dict[str, Executor]] = None,
        retries: Optional[int] = None,
        substitute_slots: Optional[dict[str, int]] = None,
    ) -> int:
        """Rewire a kill-switch result onto the device saga table.

        `kill_result` is any object with `.handoffs`, each with `saga_id`,
        `step_id` and `to_agent` (None: nobody took the step over);
        `step_index` maps (saga_id, step_id) pairs to (saga_slot,
        step_idx); substitute executors, undos and agent rows are keyed by
        substitute DID. Returns how many steps were rewired.
        """
        undos = substitute_undos or {}
        sub_slots = substitute_slots or {}
        rewired = 0
        for handoff in kill_result.handoffs:
            if handoff.to_agent is None:
                continue
            slot_idx = step_index.get((handoff.saga_id, handoff.step_id))
            execute = substitute_executors.get(handoff.to_agent)
            if slot_idx is None or execute is None:
                continue
            self.reassign(
                *slot_idx, execute, undo=undos.get(handoff.to_agent), retries=retries,
                agent_slot=sub_slots.get(handoff.to_agent),
            )
            rewired += 1
        return rewired

    async def run_until_settled(self, max_rounds: int = 1000) -> int:
        """Round-run the table until every saga reaches a terminal state;
        returns the number of rounds run.

        Each round dispatches, CONCURRENTLY: the cursor step of every
        sequential RUNNING saga, every branch of every fan-out group
        front, and every compensation target. Branches settle as whole
        groups in one `fanout_settle`; the rest book in one `saga_round`.
        """
        state = self._state
        with profiling.stage_scope("saga_scheduler"):
            for rounds in range(max_rounds):
                if state.sagas_settled():
                    return rounds
                with profiling.stage_scope("round"):
                    await self._round(state)
        raise RuntimeError(f"sagas not settled after {max_rounds} rounds")

    async def _round(self, state: HypervisorState) -> None:
        execute, compensate = state.saga_work()
        branches = state.fanout_dispatch()
        timeouts = state.saga_timeouts()
        # One isolation snapshot per round: no per-step device read.
        gate = state.isolation_gate() if self._agent_of else None
        work = [(key, self._execute.get(key), False) for key in execute]
        work += [(key, self._execute.get(key), False) for key in branches]
        work += [(key, self._undo.get(key), True) for key in compensate]
        with profiling.stage_scope("executors"):
            ok = await _Pass(self, work, timeouts, gate).run()
        undo_at = len(execute) + len(branches)
        exec_out = {slot: o for (slot, _), o in zip(execute, ok)}
        undo_out = {slot: o for (slot, _), o in zip(compensate, ok[undo_at:])}
        state.fanout_settle({pair: o for pair, o in zip(branches, ok[len(execute):undo_at])})
        state.saga_round(exec_out, undo_out)
        self._tally["saga.rounds"] += 1
        for name, n in self._tally.items():
            profiling.count(name, n)
        self._tally.clear()


class _Pass:
    """One round's executors, started in work-list order.

    `work` holds (key, executor, undo) items; `run` returns each item's
    outcome. A chain of tasks walks the items: a walker steps executors
    inline until one suspends, starts the next walker on the rest, and
    finishes the suspended executor itself under its deadline. So an
    executor's first step runs in the task that finishes it, and what it
    binds to `asyncio.current_task()` there (an `asyncio.timeout`, a
    `TaskGroup`) is its own; a round whose executors all return or raise
    on their first step costs one task. Zero-backoff retries queue behind
    every first attempt and undo of the round; a retry with a backoff
    sleeps in a task of its own. No suspended executor resumes, and no
    retry starts, before the walk has started everything else."""

    def __init__(self, sched: SagaScheduler, work: list, timeouts: tuple, gate) -> None:
        self.sched, self.work, self.gate = sched, work, gate
        self.lo, self.rows = timeouts
        self.loop = asyncio.get_running_loop()
        self.ok = [False] * len(work)
        # (item, attempt): attempt None is an item's first visit, which
        # does its bookkeeping; otherwise the attempt starts.
        self.queue = [(n, None) for n in range(len(work))]
        self.tasks: list = []
        self.held: list = []  # one future per suspended executor, set when the walk ends

    async def run(self) -> list:
        self.tasks.append(self.loop.create_task(self._walk(0)))
        try:
            for task in self.tasks:  # grows while walkers hand on
                await task
        except BaseException:
            for task in self.tasks:
                task.cancel()
            raise
        return self.ok

    async def _walk(self, at: int) -> None:
        try:
            suspended = self._steps(at)
        except BaseException:
            self._release()
            raise
        if suspended is None:
            self._release()
            return
        at, n, awaitable, deadline = suspended
        # The rest of the queue goes on in a new walker; this one finishes
        # the executor that suspended.
        self.tasks.append(self.loop.create_task(self._walk(at)))
        await self._finish(n, awaitable, deadline)

    def _release(self) -> None:
        for hold in self.held:
            if not hold.done():
                hold.set_result(None)

    def _steps(self, at: int) -> Optional[tuple]:
        """Step the queue from `at` inline; None once it is walked, else
        (next position, item, what finishes the item, its deadline) for
        the first item that suspends."""
        sched, queue, loop = self.sched, self.queue, self.loop
        while at < len(queue):
            n, attempt = queue[at]
            at += 1
            key, executor, undo = self.work[n]
            if attempt is None:
                attempt = self._admit(n)
                if attempt is None:
                    continue
                if attempt and not undo:
                    if sched._backoff:
                        hold = loop.create_future()
                        self.held.append(hold)
                        self.tasks.append(loop.create_task(self._later(n, attempt, hold)))
                    else:
                        queue.append((n, attempt))
                    continue
            sched._attempts[key] = attempt + 1
            timeout = self._timeout(key)
            # A task's context: what one executor sets, the next does not see.
            ctx = contextvars.copy_context()
            try:
                coro = ctx.run(executor)
            except Exception as exc:  # noqa: BLE001 — outcomes are data
                self._book(n, exc=exc, inline=True)
                continue
            if timeout <= 0 or type(coro) is not types.CoroutineType:
                # `wait_for`'s own rules: an awaitable that is no coroutine,
                # or a step whose timeout is spent before it starts.
                sched._tally["saga.suspended"] += 1
                return at, n, asyncio.wait_for(coro, timeout), None
            deadline = loop.time() + timeout
            try:
                yielded = ctx.run(coro.send, None)
            except StopIteration as stop:
                self._book(n, result=stop.value, inline=True)
                continue
            except Exception as exc:  # noqa: BLE001 — outcomes are data
                self._book(n, exc=exc, inline=True)
                continue
            sched._tally["saga.suspended"] += 1
            hold = loop.create_future()
            self.held.append(hold)
            return at, n, _resume(ctx, coro, yielded, hold), deadline
        return None

    def _admit(self, n: int) -> Optional[int]:
        """The item's bookkeeping before its executor runs; its attempt
        number, or None when it fails without one."""
        sched = self.sched
        key, executor, undo = self.work[n]
        if executor is None:
            # A compensation target with no undo API fails; a forward step
            # with no registered executor is a wiring error, a failure too.
            sched.errors[key] = "No undo API" if undo else "No executor"
            return None
        if self.gate is not None and not undo and key in sched._agent_of:
            # A mid-saga quarantine or breaker trip refuses a forward step
            # before its executor runs (compensations still run); the retry
            # ladder and compensation handle the refusal like any failure.
            refusal = self.gate(sched._agent_of[key])
            if refusal is not None:
                sched.errors[key] = refusal
                sched._tally["saga.gate_refusals"] += 1
                return None
        attempt = sched._attempts.get(key, 0)
        if undo:
            sched._tally["saga.undo_attempts"] += 1
        else:
            sched._tally["saga.attempts"] += 1
            if attempt:
                sched._tally["saga.retries"] += 1
        return attempt

    def _timeout(self, key) -> float:
        slot, idx = key
        return float(self.rows[slot - self.lo, idx])

    async def _later(self, n: int, attempt: int, hold: asyncio.Future) -> None:
        sched = self.sched
        key, executor, _ = self.work[n]
        await asyncio.sleep(sched._backoff * attempt)  # linear backoff
        await hold
        sched._attempts[key] = attempt + 1
        sched._tally["saga.suspended"] += 1
        try:
            coro = executor()
        except Exception as exc:  # noqa: BLE001 — outcomes are data
            self._book(n, exc=exc)
            return
        await self._finish(n, asyncio.wait_for(coro, self._timeout(key)), None)

    async def _finish(self, n: int, awaitable, deadline: Optional[float]) -> None:
        try:
            async with asyncio.timeout_at(deadline):
                result = await awaitable
        except Exception as exc:  # noqa: BLE001 — outcomes are data
            self._book(n, exc=exc)
        else:
            self._book(n, result=result)

    def _book(self, n: int, result: Any = None, exc: Optional[Exception] = None,
              inline: bool = False) -> None:
        sched = self.sched
        key, _, undo = self.work[n]
        if inline:
            sched._tally["saga.inline"] += 1
        if exc is not None:
            if isinstance(exc, TimeoutError):
                sched._tally["saga.timeouts"] += 1
            sched.errors[key] = str(exc)
        else:
            self.ok[n] = True
            if not undo:
                sched.results[key] = result


@types.coroutine
def _resume(ctx: contextvars.Context, coro, yielded, hold: asyncio.Future):
    """Finish a coroutine whose first step was taken by hand (it yielded
    `yielded`). The task awaiting this waits for `hold`, then gets what the
    coroutine yielded; its sends and throws go back to the coroutine, in
    `ctx`, as they would from a task of the coroutine's own."""
    step = None
    try:
        yield from hold
    except GeneratorExit:
        ctx.run(coro.close)
        raise
    except BaseException as exc:  # cancelled while it waited
        step, arg = coro.throw, exc
    while True:
        try:
            if step is not None:
                yielded = ctx.run(step, arg)
            try:
                arg = yield yielded
                step = coro.send
            except GeneratorExit:
                ctx.run(coro.close)
                raise
            except BaseException as exc:  # a cancel or a failed future
                step, arg = coro.throw, exc
        except StopIteration as stop:
            return stop.value
