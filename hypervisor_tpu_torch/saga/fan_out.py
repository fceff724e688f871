"""Parallel saga fan-out with ALL / MAJORITY / ANY failure policies.

Capability parity with reference `saga/fan_out.py:73-192` (branches
execute concurrently, the policy is evaluated over success counts, and
on policy failure every succeeded branch is routed to compensation) —
structured as a gather-then-settle pipeline: branch coroutines return
pure outcome tuples, and a single settle pass applies outcomes to the
group, evaluates the policy, and derives the compensation set. The
policy reduction is shared with the device plane both as the scalar
`evaluate_policy` and as `resolve_policy_mask`, which settles a whole
[groups, branches] success matrix in one masked reduction.
"""

from __future__ import annotations

import asyncio
import enum
import secrets
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from hypervisor_tpu_torch.saga.state_machine import SagaStep, StepState


class FanOutPolicy(str, enum.Enum):
    ALL_MUST_SUCCEED = "all_must_succeed"
    MAJORITY_MUST_SUCCEED = "majority_must_succeed"
    ANY_MUST_SUCCEED = "any_must_succeed"

    @property
    def code(self) -> int:
        return _POLICY_CODES[self]


_POLICY_CODES: dict[FanOutPolicy, int] = {
    FanOutPolicy.ALL_MUST_SUCCEED: 0,
    FanOutPolicy.MAJORITY_MUST_SUCCEED: 1,
    FanOutPolicy.ANY_MUST_SUCCEED: 2,
}


def evaluate_policy(policy: FanOutPolicy, successes: int, total: int) -> bool:
    """Scalar policy reduction shared by host and device paths."""
    if policy is FanOutPolicy.ALL_MUST_SUCCEED:
        return successes == total
    if policy is FanOutPolicy.MAJORITY_MUST_SUCCEED:
        return successes > total / 2
    return successes >= 1


def resolve_policy_mask(
    policy_codes: np.ndarray, success: np.ndarray, branch_mask: np.ndarray
) -> np.ndarray:
    """Settle every fan-out group at once from a [G, B] success matrix.

    policy_codes i8[G], success bool[G, B], branch_mask bool[G, B] (padding
    rows off). Returns bool[G] policy_satisfied — the same reduction
    `evaluate_policy` performs per group, vectorized for the saga table.
    """
    wins = (success & branch_mask).sum(axis=1)
    total = branch_mask.sum(axis=1)
    verdicts = np.stack(
        [wins == total, wins * 2 > total, wins >= 1], axis=0
    )
    return verdicts[np.clip(policy_codes, 0, 2), np.arange(len(policy_codes))]


@dataclass
class FanOutBranch:
    branch_id: str = field(default_factory=lambda: f"branch:{secrets.token_hex(4)}")
    step: Optional[SagaStep] = None
    result: Any = None
    error: Optional[str] = None
    succeeded: bool = False


@dataclass
class FanOutGroup:
    group_id: str = field(default_factory=lambda: f"fanout:{secrets.token_hex(4)}")
    saga_id: str = ""
    policy: FanOutPolicy = FanOutPolicy.ALL_MUST_SUCCEED
    branches: list[FanOutBranch] = field(default_factory=list)
    resolved: bool = False
    policy_satisfied: bool = False
    compensation_needed: list[str] = field(default_factory=list)

    @property
    def success_count(self) -> int:
        return sum(1 for b in self.branches if b.succeeded)

    @property
    def failure_count(self) -> int:
        return sum(1 for b in self.branches if not b.succeeded and b.error)

    @property
    def total_branches(self) -> int:
        return len(self.branches)

    def check_policy(self) -> bool:
        return evaluate_policy(self.policy, self.success_count, self.total_branches)


# One branch's execution outcome: (ok, value) where value is the result on
# success or the error string on failure.
_Outcome = tuple[bool, Any]


class FanOutOrchestrator:
    """Gather-then-settle fan-out runner."""

    def __init__(self) -> None:
        self._groups: dict[str, FanOutGroup] = {}

    def create_group(
        self, saga_id: str, policy: FanOutPolicy = FanOutPolicy.ALL_MUST_SUCCEED
    ) -> FanOutGroup:
        group = FanOutGroup(saga_id=saga_id, policy=policy)
        self._groups[group.group_id] = group
        return group

    def add_branch(self, group_id: str, step: SagaStep) -> FanOutBranch:
        group = self._require_group(group_id)
        branch = FanOutBranch(step=step)
        group.branches.append(branch)
        return branch

    async def execute(
        self,
        group_id: str,
        executors: dict[str, Callable[..., Any]],
        timeout_seconds: int = 300,
    ) -> FanOutGroup:
        """Run every branch concurrently, then settle the group once.

        Branch state is applied as each branch finishes (not deferred to
        the settle pass), so a group-level timeout still leaves the
        already-completed branches COMMITTED/FAILED for compensation or
        handoff to act on.
        """
        group = self._require_group(group_id)
        work = (self._run_branch(b, executors) for b in group.branches)
        await asyncio.wait_for(
            asyncio.gather(*work, return_exceptions=True), timeout=timeout_seconds
        )
        self._settle(group)
        return group

    @classmethod
    async def _run_branch(
        cls, branch: FanOutBranch, executors: dict[str, Callable[..., Any]]
    ) -> None:
        """Execute one branch and book its outcome; never raises."""
        step = branch.step
        if step is None:
            cls._book(branch, (False, "No step assigned"))
            return
        executor = executors.get(step.step_id)
        if executor is None:
            cls._book(branch, (False, f"No executor for step {step.step_id}"))
            return
        try:
            step.transition(StepState.EXECUTING)
            result = await asyncio.wait_for(executor(), timeout=step.timeout_seconds)
        except Exception as exc:  # noqa: BLE001 — branch failures are data
            cls._book(branch, (False, str(exc)))
            return
        cls._book(branch, (True, result))

    @staticmethod
    def _book(branch: FanOutBranch, outcome: _Outcome) -> None:
        ok, value = outcome
        branch.succeeded = ok
        step = branch.step
        if ok:
            branch.result = value
            if step is not None:
                step.execute_result = value
                step.transition(StepState.COMMITTED)
        else:
            branch.error = str(value)
            if step is not None and step.state is StepState.EXECUTING:
                step.error = str(value)
                step.transition(StepState.FAILED)

    def _settle(self, group: FanOutGroup) -> None:
        group.policy_satisfied = group.check_policy()
        group.resolved = True
        if not group.policy_satisfied:
            # Winners must be rolled back when the group loses.
            group.compensation_needed = [
                b.step.step_id for b in group.branches if b.succeeded and b.step
            ]

    def get_group(self, group_id: str) -> Optional[FanOutGroup]:
        return self._groups.get(group_id)

    def _require_group(self, group_id: str) -> FanOutGroup:
        group = self._groups.get(group_id)
        if group is None:
            raise ValueError(f"Fan-out group {group_id} not found")
        return group

    @property
    def active_groups(self) -> list[FanOutGroup]:
        return [g for g in self._groups.values() if not g.resolved]
