"""Host asyncio scheduler driving real executors against the device
SagaTable (`hypervisor_tpu.runtime.saga_scheduler`).

The device table is the state machine and the host only supplies
executor outcomes: each round, `HypervisorState.saga_work()` names the
cursor steps (forward) and the reverse-order compensation targets, and
`fanout_dispatch()` the branches of every fan-out group front; this
scheduler awaits ALL of their executors concurrently under their
per-step timeouts, `fanout_settle` books the branches as whole groups,
and one `saga_round` (kernel B7 on CUDA) books every other outcome at
once. Retries back off linearly.

A call of `run_until_settled` is the span `saga_scheduler`, each round
its child `round` and the round's awaited executors `round/executors`;
each round adds its tallies to the recorder's counters `saga.rounds`,
`saga.attempts` (forward attempts), `saga.retries` (forward attempts
after a step's first), `saga.timeouts`, `saga.undo_attempts` and
`saga.gate_refusals` (`observability.profiling`).
"""

from __future__ import annotations

import asyncio
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

        with profiling.stage_scope("executors"):
            exec_res, branch_res, undo_res = await asyncio.gather(
                asyncio.gather(*(
                    self._attempt(self._execute.get((slot, idx)), slot, idx, timeouts, gate=gate)
                    for slot, idx in execute
                )),
                asyncio.gather(*(
                    self._attempt(self._execute.get((slot, idx)), slot, idx, timeouts, gate=gate)
                    for slot, idx in branches
                )),
                asyncio.gather(*(
                    self._attempt(self._undo.get((slot, idx)), slot, idx, timeouts, undo=True)
                    for slot, idx in compensate
                )),
            )
        exec_out = {slot: ok for (slot, _), ok in zip(execute, exec_res)}
        undo_out = {slot: ok for (slot, _), ok in zip(compensate, undo_res)}
        state.fanout_settle({pair: ok for pair, ok in zip(branches, branch_res)})
        state.saga_round(exec_out, undo_out)
        self._tally["saga.rounds"] += 1
        for name, n in self._tally.items():
            profiling.count(name, n)
        self._tally.clear()

    async def _attempt(
        self,
        executor: Optional[Executor],
        slot: int,
        idx: int,
        timeouts: tuple,
        undo: bool = False,
        gate=None,
    ) -> bool:
        """Run one executor under its timeout (`timeouts`: the round's
        `HypervisorState.saga_timeouts()`); outcomes are data."""
        key = (slot, idx)
        if executor is None:
            # A compensation target with no undo API fails; a forward step
            # with no registered executor is a wiring error, a failure too.
            self.errors[key] = "No undo API" if undo else "No executor"
            return False
        if gate is not None and key in self._agent_of:
            # A mid-saga quarantine or breaker trip refuses the step before
            # its executor runs; the retry ladder and compensation handle
            # the refusal like any failure.
            refusal = gate(self._agent_of[key])
            if refusal is not None:
                self.errors[key] = refusal
                self._tally["saga.gate_refusals"] += 1
                return False
        attempt = self._attempts.get(key, 0)
        if undo:
            self._tally["saga.undo_attempts"] += 1
        else:
            self._tally["saga.attempts"] += 1
            if attempt:
                self._tally["saga.retries"] += 1
                await asyncio.sleep(self._backoff * attempt)  # linear backoff
        self._attempts[key] = attempt + 1
        try:
            lo, rows = timeouts
            timeout = float(rows[slot - lo, idx])
            result = await asyncio.wait_for(executor(), timeout=timeout)
        except Exception as exc:  # noqa: BLE001 — outcomes are data
            if isinstance(exc, TimeoutError):
                self._tally["saga.timeouts"] += 1
            self.errors[key] = str(exc)
            return False
        if not undo:
            self.results[key] = result
        return True
