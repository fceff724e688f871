"""The device plane's breach window, effective rings and quarantine
(`hypervisor_tpu.ops.security_ops`), the parts the action gateway and
the sanitizer's repairs reach.

Each agent row carries its breach window in `bd_window` (i32[N, 3K],
the i32 block's columns 3..20): K = BD_BUCKETS sub-windows of
window_seconds / K each, holding calls, privileged calls and the
sub-window's absolute epoch stamp. A bucket counts while its epoch is
one of the last K, so expiry is timestamp arithmetic and nothing resets
the window. Effective rings apply the active, unexpired sudo grants of
the ElevationTable. Quarantine freezes rows read-only until a deadline.
"""

from __future__ import annotations

import torch

from hypervisor_tpu_torch.config import DEFAULT_CONFIG, BreachConfig
from hypervisor_tpu_torch.ops.admission import f32_scalar
from hypervisor_tpu_torch.tables.state import (
    BD_BUCKETS,
    FLAG_QUARANTINED,
    AgentTable,
    ElevationTable,
)
from hypervisor_tpu_torch.tables.struct import replace


def window_epoch(now, config: BreachConfig = DEFAULT_CONFIG.breach,
                 device: str | torch.device = "cpu") -> torch.Tensor:
    """i32[] absolute sub-window epoch of `now`: floor(now / sub_width) in
    float32."""
    sub = f32_scalar(config.window_seconds / BD_BUCKETS, device)
    return torch.floor(f32_scalar(now, device) / sub).to(torch.int32)


def window_totals(
    bd_window: torch.Tensor, now, config: BreachConfig = DEFAULT_CONFIG.breach,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(calls i32[N], privileged i32[N]) inside the sliding window at `now`:
    the buckets whose epoch is one of the last BD_BUCKETS."""
    k = BD_BUCKETS
    cur = window_epoch(now, config, bd_window.device)
    live = bd_window[:, 2 * k:] > cur - k
    zero = torch.zeros((), dtype=bd_window.dtype, device=bd_window.device)
    calls = torch.where(live, bd_window[:, :k], zero).sum(dim=1, dtype=torch.int32)
    priv = torch.where(live, bd_window[:, k:2 * k], zero).sum(dim=1, dtype=torch.int32)
    return calls, priv


def window_commit(
    bd_window: torch.Tensor,  # i32[N, 3K]
    calls_add: torch.Tensor,  # i32[N] calls landing at `now` per row
    priv_add: torch.Tensor,   # i32[N] their privileged subset
    now,
    config: BreachConfig = DEFAULT_CONFIG.breach,
) -> torch.Tensor:
    """A new window with one wave's per-row calls folded into the current
    sub-window. The current bucket (epoch mod K) accumulates when it
    carries this epoch, restarts when its stamp is older, and, when it
    carries a newer epoch (a late `now`), accumulates without moving
    its stamp. Rows without new calls are left bit for bit."""
    k = BD_BUCKETS
    cur = window_epoch(now, config, bd_window.device)
    j0 = torch.remainder(cur, k).to(torch.int64).reshape(1)
    cols = torch.cat([j0, j0 + k, j0 + 2 * k])
    calls, priv, stamp = bd_window.index_select(1, cols).unbind(1)
    touched = calls_add > 0
    stale = stamp > cur
    keep = (stamp == cur) | stale
    zero = torch.zeros((), dtype=bd_window.dtype, device=bd_window.device)
    new_calls = torch.where(keep, calls, zero) + calls_add
    new_priv = torch.where(keep, priv, zero) + priv_add
    new_stamp = torch.where(stale, stamp, cur)
    out = bd_window.clone()
    out.index_copy_(1, cols, torch.stack([
        torch.where(touched, new_calls, calls),
        torch.where(touched, new_priv, priv),
        torch.where(touched, new_stamp, stamp),
    ], dim=1).to(bd_window.dtype))
    return out


def effective_rings(
    base_ring: torch.Tensor,  # i8[N] the agents' assigned rings
    elevations: ElevationTable,
    now,
) -> torch.Tensor:
    """i8[N]: each agent's ring with its active, unexpired grants applied.
    A grant only elevates (the lower ring of the two wins)."""
    dev = base_ring.device
    n = base_ring.shape[0]
    live = elevations.active & (f32_scalar(now, dev) <= elevations.expires_at)
    agent = elevations.agent
    on_table = (agent >= 0) & (agent < n)
    granted = torch.where(live & on_table, elevations.granted_ring.to(torch.int32),
                          torch.full((), 3, dtype=torch.int32, device=dev))
    # Grants off the table land on a spare row n, which is dropped.
    best = torch.full((n + 1,), 3, dtype=torch.int32, device=dev)
    best.scatter_reduce_(0, torch.where(on_table, agent, n).to(torch.int64), granted, "amin")
    return torch.minimum(base_ring.to(torch.int32), best[:n]).to(torch.int8)


def quarantine_enter(agents: AgentTable, enter: torch.Tensor, now, duration) -> AgentTable:
    """A copy of the agents with the masked rows quarantined until now +
    duration; a row already held keeps its deadline."""
    dev = agents.flags.device
    deadline = f32_scalar(now, dev) + f32_scalar(duration, dev)
    already = (agents.flags & FLAG_QUARANTINED) != 0
    until = torch.where(enter & ~already, deadline, agents.quarantine_until)
    flags = torch.where(enter, agents.flags | FLAG_QUARANTINED, agents.flags)
    return replace(agents, flags=flags, quarantine_until=until)
