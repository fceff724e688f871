"""Batched saga step ops (`hypervisor_tpu.ops.saga_ops`): the step codes
and the retry-ladder attempt the wave runs once per joining lane."""

from __future__ import annotations

import torch

# Step-state codes (order of the reference's StepState).
STEP_PENDING = 0
STEP_EXECUTING = 1
STEP_COMMITTED = 2
STEP_COMPENSATING = 3
STEP_COMPENSATED = 4
STEP_COMPENSATION_FAILED = 5
STEP_FAILED = 6


def execute_attempt(
    state: torch.Tensor, success: torch.Tensor, retries_left: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One retry-ladder attempt: PENDING steps move to COMMITTED on
    success; on failure back to PENDING while retries remain, else
    FAILED. Returns (new_state, new_retries_left)."""
    pending = state == STEP_PENDING
    committed = pending & success
    failed_final = pending & ~success & (retries_left <= 0)
    retrying = pending & ~success & (retries_left > 0)
    new_state = torch.where(
        committed,
        torch.full_like(state, STEP_COMMITTED),
        torch.where(failed_final, torch.full_like(state, STEP_FAILED), state),
    )
    return new_state, torch.where(retrying, retries_left - 1, retries_left)
