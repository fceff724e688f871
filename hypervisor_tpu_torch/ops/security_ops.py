"""The device plane's breach window and sweep, elevation expiry,
effective rings and quarantine (`hypervisor_tpu.ops.security_ops`).

Each agent row carries its breach window in `bd_window` (i32[N, 3K],
the i32 block's columns 3..20): K = BD_BUCKETS sub-windows of
window_seconds / K each, holding calls, privileged calls and the
sub-window's absolute epoch stamp. A bucket counts while its epoch is
one of the last K, so expiry is timestamp arithmetic and nothing resets
the window. The breach sweep derives every row's privileged-call rate
and severity (0 NONE, 1 LOW, 2 MEDIUM, 3 HIGH, 4 CRITICAL), trips the
circuit breaker on HIGH and CRITICAL and releases breakers whose
cooldown ran out. Effective rings apply the active, unexpired sudo
grants of the ElevationTable; expiry deactivates lapsed grants.
Quarantine freezes rows read-only until a deadline, and its sweep
releases rows strictly past theirs.

These are plain torch ops on either device; none is a kernel of its own
(none is a Pallas kernel in the reference). Every f32 step rounds where
the reference's does: scalars are cast to f32 first, nothing is fused.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hypervisor_tpu_torch.config import DEFAULT_CONFIG, BreachConfig
from hypervisor_tpu_torch.ops.admission import f32_scalar
from hypervisor_tpu_torch.tables.state import (
    BD_BUCKETS,
    FLAG_BREAKER_TRIPPED,
    FLAG_QUARANTINED,
    AgentTable,
    ElevationTable,
)
from hypervisor_tpu_torch.tables.struct import replace


SEV_NONE, SEV_LOW, SEV_MEDIUM, SEV_HIGH, SEV_CRITICAL = range(5)
_INT32_MIN = -(2**31)


def window_epoch(now, config: BreachConfig = DEFAULT_CONFIG.breach, *,
                 device: str | torch.device) -> torch.Tensor:
    """i32[] absolute sub-window epoch of `now` on `device`: floor(now /
    sub_width) in float32."""
    sub = f32_scalar(config.window_seconds / BD_BUCKETS, device)
    return torch.floor(f32_scalar(now, device) / sub).to(torch.int32)


def window_totals(
    bd_window: torch.Tensor, now, config: BreachConfig = DEFAULT_CONFIG.breach,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(calls i32[N], privileged i32[N]) inside the sliding window at `now`:
    the buckets whose epoch is one of the last BD_BUCKETS."""
    k = BD_BUCKETS
    cur = window_epoch(now, config, device=bd_window.device)
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
    cur = window_epoch(now, config, device=bd_window.device)
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


def window_latest_epoch(
    bd_window: torch.Tensor, now, config: BreachConfig = DEFAULT_CONFIG.breach,
) -> torch.Tensor:
    """i32[N]: each row's newest in-window epoch holding a call, or
    INT32_MIN for rows without in-window activity (epoch * sub_width
    lower-bounds the row's latest call time)."""
    k = BD_BUCKETS
    cur = window_epoch(now, config, device=bd_window.device)
    epochs = bd_window[:, 2 * k:]
    live = (epochs > cur - k) & (bd_window[:, :k] > 0)
    floor = torch.full((), _INT32_MIN, dtype=epochs.dtype, device=epochs.device)
    return torch.where(live, epochs, floor).amax(dim=1)


def record_calls(
    agents: AgentTable,
    slots: torch.Tensor,        # i32[B] acting agent rows
    called_ring: torch.Tensor,  # i8[B] the ring each call targets
    now,
    config: BreachConfig = DEFAULT_CONFIG.breach,
) -> AgentTable:
    """A copy of the agents with one action wave recorded into the breach
    window at `now`. A call is privileged when it targets a more
    privileged (lower) ring than its caller holds."""
    n, dev = agents.ring.shape[0], slots.device
    idx = slots.to(torch.int64)
    privileged = called_ring.to(torch.int8) < agents.ring[idx]
    calls_add = torch.zeros((n,), dtype=torch.int32, device=dev)
    calls_add.index_add_(0, idx, torch.ones(idx.shape, dtype=torch.int32, device=dev))
    priv_add = torch.zeros((n,), dtype=torch.int32, device=dev)
    priv_add.index_add_(0, idx, privileged.to(torch.int32))
    return replace(agents, bd_window=window_commit(agents.bd_window, calls_add, priv_add, now,
                                                   config))


class BreachSweep(NamedTuple):
    agents: AgentTable
    severity: torch.Tensor  # i8[N]
    tripped: torch.Tensor   # bool[N] breakers tripped by this sweep


def breach_sweep(agents: AgentTable, now,
                 config: BreachConfig = DEFAULT_CONFIG.breach) -> BreachSweep:
    """Every row's window analysed at once and the breaker ladder run.
    A row is analysed when it holds at least `min_calls_for_analysis`
    in-window calls and one of them lies in a sub-window that starts at
    or after its last breaker release (a row idle since its release does
    not re-trip on old calls). HIGH and CRITICAL trip the breaker until
    now + cooldown; a tripped breaker whose deadline has come releases.
    The window itself is left untouched."""
    dev = agents.flags.device
    now_f = f32_scalar(now, dev)
    calls, priv = window_totals(agents.bd_window, now_f, config)
    sub = f32_scalar(config.window_seconds / BD_BUCKETS, dev)
    latest = window_latest_epoch(agents.bd_window, now_f, config)
    active_since_release = latest.to(torch.float32) * sub >= agents.bd_breaker_until
    analyzable = (calls >= config.min_calls_for_analysis) & active_since_release
    rate = torch.where(analyzable,
                       priv.to(torch.float32) / calls.clamp(min=1).to(torch.float32),
                       torch.zeros((), dtype=torch.float32, device=dev))
    severity = torch.zeros(rate.shape, dtype=torch.int8, device=dev)
    for threshold in (config.low_threshold, config.medium_threshold, config.high_threshold,
                      config.critical_threshold):
        severity += (rate >= f32_scalar(threshold, dev)).to(torch.int8)
    severity = torch.where(analyzable, severity, torch.zeros_like(severity))
    trip = severity >= SEV_HIGH
    expired = ((agents.flags & FLAG_BREAKER_TRIPPED) != 0) & (now_f >= agents.bd_breaker_until)
    flags = torch.where(expired & ~trip, agents.flags & ~FLAG_BREAKER_TRIPPED, agents.flags)
    flags = torch.where(trip, flags | FLAG_BREAKER_TRIPPED, flags)
    until = torch.where(trip, now_f + f32_scalar(config.circuit_breaker_cooldown_seconds, dev),
                        agents.bd_breaker_until)
    return BreachSweep(agents=replace(agents, flags=flags, bd_breaker_until=until),
                       severity=severity, tripped=trip)


def elevation_expiry(elevations: ElevationTable, now) -> tuple[ElevationTable, torch.Tensor]:
    """(a copy of the table with every grant past its deadline
    deactivated, bool[M] the grants that expired now)."""
    expired = elevations.active & (f32_scalar(now, elevations.active.device)
                                   > elevations.expires_at)
    return replace(elevations, active=elevations.active & ~expired), expired


def effective_rings(
    base_ring: torch.Tensor,  # i8[N] the agents' assigned rings
    elevations: ElevationTable,
    now,
    agent_base: int = 0,
) -> torch.Tensor:
    """i8[N]: each agent's ring with its active, unexpired grants applied.
    A grant only elevates (the lower ring of the two wins).

    `agent_base` is the global row of `base_ring[0]` (a table shard of a
    mesh): grants are localized onto the shard's rows, and grants landing
    on other shards drop out."""
    dev = base_ring.device
    n = base_ring.shape[0]
    live = elevations.active & (f32_scalar(now, dev) <= elevations.expires_at)
    agent = elevations.agent - int(agent_base)
    on_table = (elevations.agent >= 0) & (agent >= 0) & (agent < n)
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


class QuarantineSweep(NamedTuple):
    agents: AgentTable
    released: torch.Tensor    # bool[N] rows released by this sweep
    still_held: torch.Tensor  # bool[N] rows still quarantined


def quarantine_sweep(agents: AgentTable, now) -> QuarantineSweep:
    """Release every quarantined row strictly past its deadline (at the
    deadline itself the hold still stands)."""
    held = (agents.flags & FLAG_QUARANTINED) != 0
    release = held & (agents.quarantine_until < f32_scalar(now, agents.flags.device))
    flags = torch.where(release, agents.flags & ~FLAG_QUARANTINED, agents.flags)
    return QuarantineSweep(agents=replace(agents, flags=flags), released=release,
                           still_held=held & ~release)
