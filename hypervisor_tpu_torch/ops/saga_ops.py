"""Batched saga state-machine ops (`hypervisor_tpu.ops.saga_ops`).

A whole saga table advances in one round: transition legality is
shift-and-mask arithmetic over the packed `STEP_TRANSITION_MATRIX` /
`SAGA_TRANSITION_MATRIX` bits, and the retry ladder, the cursor walk,
reverse-order compensation and fan-out policies are masked tensor
arithmetic. `saga_table_tick` runs kernel B7 for CUDA tensors and its
plain version for CPU tensors (`kernels.saga`); the fan-out round stays
plain torch ops on every device, as the reference has no Pallas form
of it.
"""

from __future__ import annotations

import numpy as np
import torch

from hypervisor_tpu_torch.observability import tracing
from hypervisor_tpu_torch.ops.bits import matrix_bits_valid, pack_matrix_bits
from hypervisor_tpu_torch.saga.state_machine import SAGA_TRANSITION_MATRIX, STEP_TRANSITION_MATRIX

_STEP_BITS = pack_matrix_bits(STEP_TRANSITION_MATRIX)
_SAGA_BITS = pack_matrix_bits(SAGA_TRANSITION_MATRIX)

# Step-state codes (order of the reference's StepState).
STEP_PENDING = 0
STEP_EXECUTING = 1
STEP_COMMITTED = 2
STEP_COMPENSATING = 3
STEP_COMPENSATED = 4
STEP_COMPENSATION_FAILED = 5
STEP_FAILED = 6

SAGA_RUNNING = 0
SAGA_COMPENSATING = 1
SAGA_COMPLETED = 2
SAGA_FAILED = 3
SAGA_ESCALATED = 4

#: Bits of the per-saga outcome byte one round copies to the device: the
#: cursor step's and the compensation target's outcomes, and whether the
#: host dispatched each.
OUT_EXEC_SUCCESS = 1
OUT_UNDO_SUCCESS = 2
OUT_EXEC_ATTEMPTED = 4
OUT_UNDO_ATTEMPTED = 8


def step_transition_valid(frm: torch.Tensor, to) -> torch.Tensor:
    """bool[...]: legality of each step transition (bitmask test)."""
    return matrix_bits_valid(_STEP_BITS, frm, to)


def saga_transition_valid(frm: torch.Tensor, to) -> torch.Tensor:
    return matrix_bits_valid(_SAGA_BITS, frm, to)


def apply_step_transitions(
    state: torch.Tensor, target, select: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance selected steps to `target` where legal. Returns
    (new_state, error_mask): the mask flags selected steps whose
    transition was illegal."""
    ok = step_transition_valid(state, target)
    apply = select & ok
    tgt = torch.as_tensor(target, device=state.device).to(state.dtype)
    return torch.where(apply, tgt, state), select & ~ok


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


def compensation_pass(
    state: torch.Tensor, has_undo: torch.Tensor, undo_success: torch.Tensor
) -> torch.Tensor:
    """COMMITTED -> COMPENSATED when an undo exists and succeeds, else
    COMPENSATION_FAILED."""
    committed = state == STEP_COMMITTED
    good = has_undo & undo_success
    return torch.where(
        committed & good, torch.full_like(state, STEP_COMPENSATED),
        torch.where(committed & ~good, torch.full_like(state, STEP_COMPENSATION_FAILED), state),
    )


def settle_sagas(step_state: torch.Tensor, saga_state: torch.Tensor) -> torch.Tensor:
    """[G, M] step states -> final saga states: a compensating saga
    ESCALATES if any step failed compensation, else COMPLETES; a running
    saga whose steps are all committed or pending, one at least
    committed, COMPLETES."""
    any_comp_failed = (step_state == STEP_COMPENSATION_FAILED).any(-1)
    all_committed = (
        ((step_state == STEP_COMMITTED) | (step_state == STEP_PENDING)).all(-1)
        & (step_state == STEP_COMMITTED).any(-1)
    )
    compensating = saga_state == SAGA_COMPENSATING
    running = saga_state == SAGA_RUNNING

    def code(c):
        return torch.full_like(saga_state, c)

    return torch.where(
        compensating & any_comp_failed, code(SAGA_ESCALATED),
        torch.where(
            compensating & ~any_comp_failed, code(SAGA_COMPLETED),
            torch.where(running & all_committed, code(SAGA_COMPLETED), saga_state),
        ),
    )


def pack_outcomes(
    exec_success, undo_success, exec_attempted=None, undo_attempted=None
) -> np.ndarray:
    """uint8[G] outcome bytes (`OUT_*` bits) from four bool[G] masks; an
    attempted mask left None means every saga was dispatched. Packed in
    uint8 throughout: a table of 2^22 sagas takes one 4 MB byte array a
    mask, where wider integers would allocate and fault in 32 MB a term."""
    es = np.asarray(exec_success, bool)
    g = es.shape[0]

    def bits(m, bit):
        m = np.ones(g, bool) if m is None else np.asarray(m, bool)
        return m.view(np.uint8) * np.uint8(bit)

    return (bits(es, OUT_EXEC_SUCCESS) | bits(undo_success, OUT_UNDO_SUCCESS)
            | bits(exec_attempted, OUT_EXEC_ATTEMPTED) | bits(undo_attempted, OUT_UNDO_ATTEMPTED))


def saga_table_tick(
    step_state: torch.Tensor,    # i8[G, M]
    retries_left: torch.Tensor,  # i8[G, M]
    has_undo: torch.Tensor,      # bool[G, M]
    saga_state: torch.Tensor,    # i8[G]
    n_steps: torch.Tensor,       # i32[G]
    cursor: torch.Tensor,        # i32[G]
    outcomes: torch.Tensor,      # u8[G] `pack_outcomes` bytes
    metrics=None,    # MetricsTable riding the tick
    trace=None,      # TraceLog riding the tick
    trace_ctx=None,  # observability.tracing.TraceContext
):
    """Advance EVERY saga in the table by one scheduling round, updating
    step_state, retries_left, saga_state and cursor IN PLACE (where the
    reference returns new columns).

    Sagas whose attempted bits are clear are left untouched (e.g. a
    fan-out group front settled by `fanout_round` in the same round).
    Forward phase (RUNNING sagas): the cursor step books its executor
    outcome — COMMITTED on success (the cursor advances), a retry while
    retries remain, else FAILED and the saga flips to COMPENSATING.
    Compensation phase (sagas COMPENSATING when the round began): the
    highest COMMITTED column is the target; no undo or a failed one is
    COMPENSATION_FAILED. With nothing left to undo the saga settles,
    ESCALATED if any compensation failed, else COMPLETED. RUNNING sagas
    whose cursor passed the last step COMPLETE.

    Returns (step_state, retries_left, saga_state, cursor, metrics,
    trace), the metrics and trace ring updated in place when they rode
    in (else None each).
    """
    from hypervisor_tpu_torch.kernels import saga as saga_kernels

    # B7 books the committed / exhausted step tallies into the counters
    # itself (in the kernel on CUDA, in its plain version on the CPU).
    saga_kernels.saga_tick_block(
        step_state, retries_left, has_undo, saga_state, n_steps, cursor, outcomes,
        counters=None if metrics is None else metrics.counters,
    )
    return _saga_tick_tail(
        step_state, retries_left, saga_state, cursor, step_state.shape[0], metrics, trace,
        trace_ctx,
    )


def _saga_tick_tail(step_state, retries_left, saga_state, cursor, g, metrics, trace, trace_ctx):
    """The saga round's trace booking: the hv.saga_round stamps."""
    if trace is not None:
        stamps = tracing.WaveStamps(trace_ctx, "saga_round")
        stamps.begin("saga_round", lane=g)
        stamps.end("saga_round", lane=g)
        trace = stamps.commit(trace)
    return step_state, retries_left, saga_state, cursor, metrics, trace


def saga_terminal(saga_state: torch.Tensor) -> torch.Tensor:
    """bool[G]: sagas in a terminal state, which no round leaves."""
    return (
        (saga_state == SAGA_COMPLETED)
        | (saga_state == SAGA_FAILED)
        | (saga_state == SAGA_ESCALATED)
    )


def saga_table_done(saga_state: torch.Tensor, session: torch.Tensor) -> torch.Tensor:
    """bool[G]: sagas in a terminal state (free rows count as done)."""
    return saga_terminal(saga_state) | (session < 0)


def fanout_policy_check(
    success: torch.Tensor, valid: torch.Tensor, policy: torch.Tensor
) -> torch.Tensor:
    """[G, B] branch outcomes -> bool[G] policy satisfaction; policy codes
    0=ALL, 1=MAJORITY, 2=ANY."""
    wins = (success & valid).sum(-1)
    total = valid.sum(-1)
    return torch.where(
        policy == 0, wins == total, torch.where(policy == 1, wins * 2 > total, wins >= 1)
    )


def fanout_round(
    step_state: torch.Tensor,    # i8[G, M]
    saga_state: torch.Tensor,    # i8[G]
    cursor: torch.Tensor,        # i32[G]
    group: torch.Tensor,         # bool[G, M] branch membership of the active group
    active: torch.Tensor,        # bool[G] sagas settling a fan-out group now
    exec_success: torch.Tensor,  # bool[G, M] branch outcomes
    policy: torch.Tensor,        # i8[G] 0=ALL 1=MAJORITY 2=ANY
):
    """Settle one fan-out group per active saga. Every branch ran once (no
    per-branch retries): successes commit, failures fail. Policy
    satisfied -> the cursor jumps past the group and the saga keeps
    RUNNING; violated -> the saga flips to COMPENSATING and the committed
    branches unwind through the normal reverse walk. Returns new
    (step_state, saga_state, cursor)."""
    in_group = active[:, None] & group
    new_step = torch.where(
        in_group & exec_success, torch.full_like(step_state, STEP_COMMITTED),
        torch.where(in_group & ~exec_success, torch.full_like(step_state, STEP_FAILED), step_state),
    )
    ok = fanout_policy_check(exec_success, in_group, policy)
    m = step_state.shape[1]
    cols = torch.arange(m, dtype=torch.int32, device=step_state.device)[None, :]
    group_end = torch.where(group, cols, torch.full_like(cols, -1)).amax(1)
    new_cursor = torch.where(active & ok, group_end + 1, cursor).to(cursor.dtype)
    new_saga = torch.where(active & ~ok, torch.full_like(saga_state, SAGA_COMPENSATING), saga_state)
    return new_step, new_saga, new_cursor
