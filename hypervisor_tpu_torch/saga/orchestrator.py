"""Saga orchestrator: forward execution with timeout/retry, reverse compensation.

Capability parity with reference `saga/orchestrator.py:28-222`: per-step
`asyncio.wait_for` timeout, retry loop of 1+max_retries attempts with linear
backoff and PENDING reset between attempts, reverse-order compensation of
committed steps, missing-Undo_API -> COMPENSATION_FAILED, any compensation
failure escalating the saga with the Joint-Liability message.

Structured as a thin driver over two single-shot primitives: `_attempt`
(one forward try: EXECUTING -> COMMITTED | FAILED, returns the failure or
None) and `_undo` (one compensation try: COMPENSATING -> COMPENSATED |
COMPENSATION_FAILED, returns success). The retry ladder and the reverse
walk are then plain loops over those primitives, mirroring how the device
scheduler (`ops.saga_ops.saga_table_tick`, driven by
`runtime.saga_scheduler.SagaScheduler`) advances the whole SagaTable one
attempt per tick.

The executor callable is the process-boundary seam: in production it calls
the action's Execute_API on a remote agent.
"""

from __future__ import annotations

import asyncio
from typing import Any, Awaitable, Callable, Optional

from hypervisor_tpu_torch.models import new_id
from hypervisor_tpu_torch.saga.state_machine import (
    Saga,
    SagaState,
    SagaStateError,
    SagaStep,
    StepState,
)

Executor = Callable[[], Awaitable[Any]]
Compensator = Callable[[SagaStep], Awaitable[Any]]


class SagaTimeoutError(Exception):
    """A saga step exceeded its timeout budget."""


class SagaGateRefused(Exception):
    """A saga step was refused by the per-action gates before execution.

    The reference ships quarantine isolation and the circuit breaker but
    never consults them on the saga path — a quarantined agent's steps
    keep executing (`saga/orchestrator.py:104-143` has no gate). Here a
    step refusal is NOT an executor failure: it raises immediately
    without burning the retry budget (retrying cannot clear a live
    quarantine or breaker cooldown).
    """


async def _bounded(coro: Awaitable[Any], seconds: float) -> Any:
    """Await with the step's timeout budget applied."""
    return await asyncio.wait_for(coro, timeout=seconds)


class SagaOrchestrator:
    """Multi-step transaction driver with saga semantics."""

    DEFAULT_MAX_RETRIES = 2
    DEFAULT_RETRY_DELAY_SECONDS = 1.0

    def __init__(self) -> None:
        self._sagas: dict[str, Saga] = {}
        # Optional per-step gate: async (SagaStep) -> Optional[str]
        # refusal reason. The facade wires this to the live isolation
        # gates (quarantine + circuit breaker, both planes) when the
        # orchestrator belongs to a ManagedSession
        # (`Hypervisor._saga_gate`); standalone orchestrators run
        # ungated, like the reference.
        self.gate: Optional[
            Callable[[SagaStep], Awaitable[Optional[str]]]
        ] = None

    # ── construction ─────────────────────────────────────────────────

    def create_saga(self, session_id: str) -> Saga:
        saga = Saga(saga_id=new_id("saga"), session_id=session_id)
        self._sagas[saga.saga_id] = saga
        return saga

    def add_step(
        self,
        saga_id: str,
        action_id: str,
        agent_did: str,
        execute_api: str,
        undo_api: Optional[str] = None,
        timeout_seconds: int = 300,
        max_retries: int = 0,
    ) -> SagaStep:
        saga = self._require_saga(saga_id)
        step = SagaStep(
            step_id=new_id("step"),
            action_id=action_id,
            agent_did=agent_did,
            execute_api=execute_api,
            undo_api=undo_api,
            timeout_seconds=timeout_seconds,
            max_retries=max_retries,
        )
        saga.steps.append(step)
        return step

    # ── forward path ─────────────────────────────────────────────────

    async def _attempt(self, step: SagaStep, executor: Executor,
                       attempt: int, budget: int) -> Optional[Exception]:
        """One forward try. Commits the step and returns None on success;
        fails the step and returns the causal exception otherwise."""
        step.transition(StepState.EXECUTING)
        try:
            step.execute_result = await _bounded(executor(), step.timeout_seconds)
        except asyncio.TimeoutError:
            failure: Exception = SagaTimeoutError(
                f"Step {step.step_id} timed out after {step.timeout_seconds}s "
                f"(attempt {attempt + 1}/{budget})"
            )
        except Exception as e:  # noqa: BLE001 — executor errors are data here
            failure = e
        else:
            step.transition(StepState.COMMITTED)
            return None
        step.error = str(failure)
        step.transition(StepState.FAILED)
        return failure

    async def execute_step(
        self, saga_id: str, step_id: str, executor: Executor
    ) -> Any:
        """Run one step through the timeout/retry ladder.

        Raises SagaTimeoutError after exhausting retries on timeouts, or the
        executor's own exception after exhausting retries on failures.
        """
        step = self._require_step(self._require_saga(saga_id), step_id)
        if self.gate is not None:
            refusal = await self.gate(step)
            if refusal is not None:
                # Refused like any action: no retry ladder (a live
                # quarantine or breaker cooldown does not clear between
                # retries) and NO state transition — the step stays
                # PENDING so it re-refuses while the hold lasts and
                # executes normally once it clears (FAILED would be
                # terminal: the matrix has no failed→executing edge).
                step.error = refusal
                raise SagaGateRefused(
                    f"Step {step.step_id} refused: {refusal}"
                )
        budget = 1 + step.max_retries

        for attempt in range(budget):
            step.retry_count = attempt
            failure = await self._attempt(step, executor, attempt, budget)
            if failure is None:
                return step.execute_result
            if attempt + 1 == budget:
                raise failure
            # Rearm for the next attempt: back to PENDING, linear backoff.
            step.state = StepState.PENDING
            step.error = None
            await asyncio.sleep(self.DEFAULT_RETRY_DELAY_SECONDS * (attempt + 1))

        raise SagaStateError("Step execution failed with no error captured")

    # ── compensation path ────────────────────────────────────────────

    @staticmethod
    async def _undo(step: SagaStep, compensator: Compensator) -> bool:
        """One compensation try; True iff the step reached COMPENSATED."""
        if not step.undo_api:
            step.state = StepState.COMPENSATION_FAILED
            step.error = "No Undo_API available"
            return False
        step.transition(StepState.COMPENSATING)
        try:
            step.compensation_result = await _bounded(
                compensator(step), step.timeout_seconds
            )
        except asyncio.TimeoutError:
            step.error = f"Compensation timed out after {step.timeout_seconds}s"
        except Exception as e:  # noqa: BLE001
            step.error = f"Compensation failed: {e}"
        else:
            step.transition(StepState.COMPENSATED)
            return True
        step.transition(StepState.COMPENSATION_FAILED)
        return False

    async def compensate(
        self, saga_id: str, compensator: Compensator
    ) -> list[SagaStep]:
        """Undo committed steps in reverse order; returns failed compensations.

        Any failure escalates the saga ("Joint Liability slashing triggered").
        """
        saga = self._require_saga(saga_id)
        saga.transition(SagaState.COMPENSATING)

        failed = [
            step
            for step in saga.committed_steps_reversed
            if not await self._undo(step, compensator)
        ]

        if failed:
            saga.transition(SagaState.ESCALATED)
            saga.error = (
                f"{len(failed)} step(s) failed compensation — "
                "Joint Liability slashing triggered"
            )
        else:
            saga.transition(SagaState.COMPLETED)
        return failed

    # ── queries ──────────────────────────────────────────────────────

    def get_saga(self, saga_id: str) -> Optional[Saga]:
        return self._sagas.get(saga_id)

    @property
    def active_sagas(self) -> list[Saga]:
        live = (SagaState.RUNNING, SagaState.COMPENSATING)
        return [s for s in self._sagas.values() if s.state in live]

    def _require_saga(self, saga_id: str) -> Saga:
        try:
            return self._sagas[saga_id]
        except KeyError:
            raise SagaStateError(f"Saga {saga_id} not found") from None

    @staticmethod
    def _require_step(saga: Saga, step_id: str) -> SagaStep:
        hit = next((s for s in saga.steps if s.step_id == step_id), None)
        if hit is None:
            raise SagaStateError(
                f"Step {step_id} not found in saga {saga.saga_id}"
            )
        return hit
