"""Session-scoped bond release and participant deactivation
(`hypervisor_tpu.ops.terminate.release_session_scope`)."""

from __future__ import annotations

import torch

from hypervisor_tpu_torch.ops import tally
from hypervisor_tpu_torch.tables.state import (
    AI32_FLAGS,
    AI32_SESSION,
    FLAG_ACTIVE,
    AgentTable,
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
