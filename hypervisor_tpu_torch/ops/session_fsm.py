"""Batched session lifecycle FSM: matrix-validated state walks
(`hypervisor_tpu.ops.session_fsm`).

Legal walk: CREATED -> HANDSHAKING -> ACTIVE -> TERMINATING -> ARCHIVED,
with termination allowed straight from HANDSHAKING too.
"""

from __future__ import annotations

import numpy as np
import torch

from hypervisor_tpu_torch.models import SessionState
from hypervisor_tpu_torch.ops.bits import matrix_bits_valid, pack_matrix_bits

# matrix[from, to] == 1 iff legal.
SESSION_TRANSITION_MATRIX = np.zeros((5, 5), np.uint8)
for _frm, _tos in {
    SessionState.CREATED: (SessionState.HANDSHAKING,),
    SessionState.HANDSHAKING: (SessionState.ACTIVE, SessionState.TERMINATING),
    SessionState.ACTIVE: (SessionState.TERMINATING,),
    SessionState.TERMINATING: (SessionState.ARCHIVED,),
}.items():
    for _to in _tos:
        SESSION_TRANSITION_MATRIX[_frm.code, _to.code] = 1

#: (lo, hi, n_rows, n_cols): the bits the fsm/saga kernel tests too.
TRANSITION_BITS = pack_matrix_bits(SESSION_TRANSITION_MATRIX)


def apply_session_transitions(
    state: torch.Tensor, target: int, select: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance selected sessions to `target` where legal.

    Returns (new_state, error_mask); the mask flags selected sessions
    whose walk was illegal — those keep their state.
    """
    ok = matrix_bits_valid(TRANSITION_BITS, state, target)
    apply = select & ok
    new_state = torch.where(apply, torch.full_like(state, target), state)
    return new_state, select & ~ok
