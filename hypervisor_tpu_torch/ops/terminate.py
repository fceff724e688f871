"""Session-scoped bond release, participant deactivation and the
terminate wave (`hypervisor_tpu.ops.terminate`: `release_session_scope`,
`terminate_batch`)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from hypervisor_tpu_torch.models import SessionState
from hypervisor_tpu_torch.ops import tally
from hypervisor_tpu_torch.ops.admission import f32_scalar
from hypervisor_tpu_torch.tables.state import (
    AI32_FLAGS,
    AI32_SESSION,
    FLAG_ACTIVE,
    SF32_TERMINATED_AT,
    SI32_STATE,
    AgentTable,
    SessionTable,
    VouchTable,
)


def release_session_scope(
    agents: AgentTable,
    vouches: VouchTable,
    in_wave: torch.Tensor | None,
    wave_range: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Release bonds and deactivate participants of the wave's sessions,
    IN PLACE on `vouches.active` and the agents' flags column (the
    reference returns updated tables). Returns int32[] bonds released.

    `in_wave`: bool[S_cap] mask over session slots; or `wave_range`
    (lo, hi), the caller's host-verified assertion that the wave's
    sessions are exactly the slot block [lo, hi). Free rows carry
    session -1, which matches neither form.
    """
    v_sess = vouches.session
    a_sess = agents.i32[:, AI32_SESSION]
    if wave_range is not None:
        lo, hi = wave_range
        edge_in = (v_sess >= lo) & (v_sess < hi)
        agent_hit = (a_sess >= lo) & (a_sess < hi)
    else:
        edge_in = (v_sess >= 0) & in_wave[v_sess.clamp(min=0).to(torch.int64)]
        agent_hit = (a_sess >= 0) & in_wave[a_sess.clamp(min=0).to(torch.int64)]
    edge_hit = vouches.active & edge_in
    vouches.active &= ~edge_hit
    flags = agents.i32[:, AI32_FLAGS]
    agents.i32[:, AI32_FLAGS] = torch.where(agent_hit, flags & ~FLAG_ACTIVE, flags)
    return tally.count_true(edge_hit)[0]


class TerminateResult(NamedTuple):
    roots: torch.Tensor     # int32[K, 8] u32 bits, passed through
    released: torch.Tensor  # i32[] bonds released


def terminate_batch(
    agents: AgentTable,
    sessions: SessionTable,
    vouches: VouchTable,
    session_slots: torch.Tensor,  # i32[K] the wave of sessions to terminate
    roots: torch.Tensor,          # int32[K, 8] Merkle roots the audit plane computed
    now,
    wave_range: tuple[int, int] | None = None,
) -> TerminateResult:
    """Terminate a wave of K sessions, IN PLACE: bond release and
    participant deactivation (`release_session_scope`), then every
    session in the wave ARCHIVED with `terminated_at = now`. Membership
    is the range [lo, hi) when `wave_range` (a host-verified contiguity
    assertion) is given, else a mask scattered from `session_slots`."""
    s_cap = sessions.i32.shape[0]
    dev = session_slots.device
    if wave_range is not None:
        iota = torch.arange(s_cap, dtype=torch.int32, device=dev)
        in_wave = (iota >= wave_range[0]) & (iota < wave_range[1])
    else:
        in_wave = torch.zeros((s_cap,), dtype=torch.bool, device=dev)
        in_wave[session_slots.to(torch.int64).clamp(min=0)] = True
    released = release_session_scope(agents, vouches, in_wave, wave_range)
    state = sessions.i32[:, SI32_STATE]
    sessions.i32[:, SI32_STATE] = torch.where(
        in_wave, torch.full_like(state, SessionState.ARCHIVED.code), state
    )
    t_at = sessions.f32[:, SF32_TERMINATED_AT]
    sessions.f32[:, SF32_TERMINATED_AT] = torch.where(in_wave, f32_scalar(now, dev), t_at)
    return TerminateResult(roots=roots, released=released)
