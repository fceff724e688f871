"""Kernel B7, the saga round, for Hopper: `saga_tick_block`.

Replaces `hypervisor_tpu/kernels/wave_pallas.py` `saga_tick_block_pallas`
(kernel body `_saga_tick_kernel`): one round over the whole [G, M]
SagaTable — the cursor step's booking with the retry ladder, the FSM to
COMPENSATING or COMPLETED, the reverse-order compensation target (the
highest COMMITTED column over all M columns, after the forward write),
and the settle to COMPLETED or ESCALATED. The TPU kernel aliases the
step and retry tables in to out; here the kernel writes step_state,
retries_left, saga_state and cursor IN PLACE, and the committed and
exhausted masks into new tensors.

Bound by bytes, and at the default 8,192 x 16 by the launch: about
100 bytes a saga (three 16-byte rows read, two written, the control
columns and one packed outcome byte), some 0.8 MB in all. One thread
owns one saga row. A row of M int8 steps, retries and undo flags is
read with 16-byte vector loads into registers when M is a multiple of
16 (up to 64) and the rows are 16-byte aligned, and byte by byte from
device memory otherwise. The four per-saga outcome masks arrive as one
packed byte (`ops.saga_ops.OUT_*` bits), so the host copies one uint8[G]
to the card per round instead of four bool[G]. When the metrics
table's counter column rides in, the same launch adds the round's
committed and exhausted counts to its `SAGA_STEPS_COMMITTED` and
`SAGA_STEPS_FAILED` rows (a warp ballot, one unsigned atomic a warp
and counter, wrapping at 2^32 like the u32 column), so the round books
its tallies with no device op of its own; the plain version books the
same counts.

Sources: `csrc/saga.cu`. `saga_tick_block_plain` is `saga_tick_block_np`'s
math on tensors: what CPU tensors run and what the kernel is held
against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from hypervisor_tpu_torch.kernels import _build, work
from hypervisor_tpu_torch.kernels.mtu import _check_operand, _require, _route
from hypervisor_tpu_torch.observability import metrics as schema
from hypervisor_tpu_torch.ops import saga_ops as ops
from hypervisor_tpu_torch.tables.metrics import counters_add

_P, _I = ctypes.c_void_p, ctypes.c_int
_VEC_MAX_M = 64
#: The counter rows the round books: committed and exhausted steps.
TALLY_ROWS = (schema.SAGA_STEPS_COMMITTED.index, schema.SAGA_STEPS_FAILED.index)


def _code(ref: torch.Tensor, c: int) -> torch.Tensor:
    return torch.full_like(ref, c)


def saga_tick_block_plain(
    step_state, retries_left, has_undo, saga_state, n_steps, cursor, outcomes, counters=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B7: updates step_state, retries_left, saga_state
    and cursor IN PLACE, and adds the committed and exhausted counts to
    `counters` (rows `TALLY_ROWS`) when given; returns (committed,
    exhausted) bool[G]."""
    g, m = step_state.shape
    rows = torch.arange(g, device=step_state.device)
    oc = outcomes.to(torch.int32)
    exec_success = (oc & ops.OUT_EXEC_SUCCESS) != 0
    undo_success = (oc & ops.OUT_UNDO_SUCCESS) != 0
    exec_attempted = (oc & ops.OUT_EXEC_ATTEMPTED) != 0
    undo_attempted = (oc & ops.OUT_UNDO_ATTEMPTED) != 0

    running = saga_state == ops.SAGA_RUNNING
    # Compensation acts only on sagas that entered this round COMPENSATING.
    compensating = saga_state == ops.SAGA_COMPENSATING
    in_range = cursor < n_steps

    cur = cursor.clamp(0, m - 1).to(torch.int64)
    cur_state = step_state[rows, cur]
    cur_retries = retries_left[rows, cur]
    attempt = running & in_range & (cur_state == ops.STEP_PENDING) & exec_attempted
    committed = attempt & exec_success
    exhausted = attempt & ~exec_success & (cur_retries <= 0)
    retrying = attempt & ~exec_success & (cur_retries > 0)
    step_state[rows, cur] = torch.where(
        committed, _code(cur_state, ops.STEP_COMMITTED),
        torch.where(exhausted, _code(cur_state, ops.STEP_FAILED), cur_state),
    )
    retries_left[rows, cur] = cur_retries - retrying.to(torch.int8)
    cursor.copy_(torch.where(committed, cursor + 1, cursor))

    finished = running & (cursor >= n_steps) & (n_steps > 0)
    saga_state.copy_(torch.where(
        exhausted, _code(saga_state, ops.SAGA_COMPENSATING),
        torch.where(finished, _code(saga_state, ops.SAGA_COMPLETED), saga_state),
    ))

    cols = torch.arange(m, device=step_state.device)[None, :]
    target = torch.where(step_state == ops.STEP_COMMITTED, cols, torch.full_like(cols, -1)).amax(1)
    has_target = compensating & (target >= 0) & undo_attempted
    tcol = target.clamp(0, m - 1)
    undo_ok = has_target & has_undo[rows, tcol] & undo_success
    at_target = step_state[rows, tcol]
    step_state[rows, tcol] = torch.where(
        undo_ok, _code(at_target, ops.STEP_COMPENSATED),
        torch.where(has_target, _code(at_target, ops.STEP_COMPENSATION_FAILED), at_target),
    )

    still_committed = (step_state == ops.STEP_COMMITTED).any(1)
    any_comp_failed = (step_state == ops.STEP_COMPENSATION_FAILED).any(1)
    settled = compensating & ~still_committed
    saga_state.copy_(torch.where(
        settled & any_comp_failed, _code(saga_state, ops.SAGA_ESCALATED),
        torch.where(settled, _code(saga_state, ops.SAGA_COMPLETED), saga_state),
    ))
    if counters is not None:
        counters_add(counters, TALLY_ROWS, (committed.sum(), exhausted.sum()))
    return committed, exhausted


def saga_tick_block(
    step_state: torch.Tensor,    # i8[G, M]
    retries_left: torch.Tensor,  # i8[G, M]
    has_undo: torch.Tensor,      # bool[G, M]
    saga_state: torch.Tensor,    # i8[G]
    n_steps: torch.Tensor,       # i32[G]
    cursor: torch.Tensor,        # i32[G]
    outcomes: torch.Tensor,      # u8[G] `ops.saga_ops.pack_outcomes` bytes
    counters: torch.Tensor | None = None,  # i32[C] the metrics table's u32 counters
) -> tuple[torch.Tensor, torch.Tensor]:
    """B7: one saga round, step_state, retries_left, saga_state and
    cursor updated IN PLACE, the committed and exhausted counts added to
    `counters` rows `TALLY_ROWS` IN PLACE when given; returns (committed,
    exhausted) bool[G]. CUDA tensors launch the kernel; CPU tensors take
    `saga_tick_block_plain`."""
    _require(step_state.dim() == 2 and step_state.shape[1] >= 1, "step_state: [G, M], M >= 1")
    g, m = step_state.shape
    for t, name in ((retries_left, "retries_left"), (has_undo, "has_undo")):
        _require(tuple(t.shape) == (g, m), f"{name}: [G, M]")
    for t, name in ((saga_state, "saga_state"), (n_steps, "n_steps"), (cursor, "cursor"),
                    (outcomes, "outcomes")):
        _require(tuple(t.shape) == (g,), f"{name}: [G]")
    _require(counters is None or (counters.dim() == 1 and counters.shape[0] > max(TALLY_ROWS)),
             "counters: [C] holding the saga tally rows")
    if not _route(step_state):
        return saga_tick_block_plain(
            step_state, retries_left, has_undo, saga_state, n_steps, cursor, outcomes, counters)
    dev = step_state.device
    for t, name, dtype in [
        (step_state, "step_state", torch.int8), (retries_left, "retries_left", torch.int8),
        (has_undo, "has_undo", torch.bool), (saga_state, "saga_state", torch.int8),
        (n_steps, "n_steps", torch.int32), (cursor, "cursor", torch.int32),
        (outcomes, "outcomes", torch.uint8),
    ] + ([] if counters is None else [(counters, "counters", torch.int32)]):
        _check_operand(t, name, dtype, dev)
    vec = (m % 16 == 0 and m <= _VEC_MAX_M
           and all(t.data_ptr() % 16 == 0 for t in (step_state, retries_left, has_undo)))
    committed = torch.empty((g,), dtype=torch.bool, device=dev)
    exhausted = torch.empty((g,), dtype=torch.bool, device=dev)
    fn = _build.entry("saga", "hv_saga_tick", [_P] * 10 + [_I] * 5 + [_P])
    err = fn(
        step_state.data_ptr(), retries_left.data_ptr(), has_undo.data_ptr(),
        saga_state.data_ptr(), n_steps.data_ptr(), cursor.data_ptr(), outcomes.data_ptr(),
        committed.data_ptr(), exhausted.data_ptr(),
        None if counters is None else counters.data_ptr(), *TALLY_ROWS, g, m, int(vec),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("saga", err, "saga_tick_block")
    saga_tick_block.launches += 1
    work.note_launch("saga_tick_block", sagas=g, steps=m)
    return committed, exhausted


saga_tick_block.launches = 0
