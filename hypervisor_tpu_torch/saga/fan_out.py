"""Fan-out policies (`hypervisor_tpu.saga.fan_out`: `FanOutPolicy` and
`evaluate_policy`). `code` is the policy's device code, which
`ops.saga_ops.fanout_policy_check` reduces over whole tables; the host
orchestrator ports with the host engines."""

from __future__ import annotations

import enum


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
