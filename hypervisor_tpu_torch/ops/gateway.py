"""The batched action gateway: every per-action gate as one wave
(`hypervisor_tpu.ops.gateway`), phase 7 of the governance wave.

B actions pass, in the scalar pipeline's order, the circuit breaker
(the device's tripped flag, the host detector's verdict and trips
earlier in this wave), quarantine (read-only isolation), ring
enforcement at the elevation-effective ring, a token-bucket consume at
that ring's budget, and breach-window recording (refused probes record
too). Two gates depend on wave order: an earlier action's record can
trip the breaker that refuses a later one, and the actions on one bucket
settle one after another. Both are prefix-monotone within a wave (the
wave shares one `now`), so they are per-slot prefix sums over one stable
sort by slot, shared by all four prefixes.

No kernel of its own: the reference has no Pallas form of this phase,
so it is torch ops on whatever device the tables are on. The sort is
stable (`torch.argsort(stable=True)`), since the rate settle depends on
wave order within a slot. The one scatter-add, the per-row [A, 4]
counts, adds 0/1 values in f32: integers below 2^24, exact in any
order, so CUDA's unordered atomics give the reference's bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hypervisor_tpu_torch.config import (
    DEFAULT_CONFIG,
    BreachConfig,
    RateLimitConfig,
    TrustConfig,
)
from hypervisor_tpu_torch.observability import metrics as schema
from hypervisor_tpu_torch.ops import rate_limit as rate_ops
from hypervisor_tpu_torch.ops import rings as ring_ops
from hypervisor_tpu_torch.ops import security_ops, tally
from hypervisor_tpu_torch.ops.admission import f32_scalar
from hypervisor_tpu_torch.tables import metrics as metrics_ops
from hypervisor_tpu_torch.tables.metrics import MetricsTable
from hypervisor_tpu_torch.tables.state import (
    AF32_BD_BREAKER_UNTIL,
    AF32_RL_STAMP,
    AF32_RL_TOKENS,
    AI32_BD_WIN_START,
    AI32_BD_WIN_STOP,
    AI32_FLAGS,
    FLAG_BREAKER_TRIPPED,
    FLAG_QUARANTINED,
    AgentTable,
    ElevationTable,
)

# Gateway verdict codes, in gate order.
GATE_ALLOWED = 0
GATE_BREAKER = 1
GATE_QUARANTINED = 2
GATE_RING = 3
GATE_RATE = 4
GATE_INVALID = 5   # a masked-out (padding) lane


class _SegmentLayout(NamedTuple):
    """One wave's grouping by slot, shared by every segment prefix."""

    order: torch.Tensor      # i64[B] stable sort permutation by slot
    inv: torch.Tensor        # i64[B] its inverse
    start_pos: torch.Tensor  # i64[B] the group's first sorted position, per sorted position


def _segment_layout(slot: torch.Tensor) -> _SegmentLayout:
    b = slot.shape[0]
    order = torch.argsort(slot, stable=True)
    s_sorted = slot[order]
    idx = torch.arange(b, dtype=torch.int64, device=slot.device)
    is_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=slot.device),
                          s_sorted[1:] != s_sorted[:-1]])
    start_pos = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    inv = torch.empty_like(idx).scatter_(0, order, idx)
    return _SegmentLayout(order=order, inv=inv, start_pos=start_pos)


def _segment_prefix_many(layout: _SegmentLayout, cols: tuple[torch.Tensor, ...]):
    """(inclusive, exclusive) per-slot prefix sums, in wave order, of M
    integer columns sharing one layout: ((incl i32[B], excl i32[B]), ...)."""
    m = len(cols)
    v_sorted = torch.stack(cols).to(torch.int64)[:, layout.order]
    c = torch.cumsum(v_sorted, dim=1)
    c_before = torch.cat([torch.zeros((m, 1), dtype=c.dtype, device=c.device), c[:, :-1]], dim=1)
    incl_sorted = c - c_before[:, layout.start_pos]
    excl_sorted = incl_sorted - v_sorted
    incl = incl_sorted[:, layout.inv].to(torch.int32)
    excl = excl_sorted[:, layout.inv].to(torch.int32)
    return tuple((incl[i], excl[i]) for i in range(m))


def tally_gateway(metrics: MetricsTable, allowed: torch.Tensor, valid: torch.Tensor) -> None:
    """Book one gateway wave's allowed and denied counters, IN PLACE."""
    counts = tally.count_true(allowed, valid)
    metrics_ops.counter_add_many(
        metrics, (schema.GATEWAY_ALLOWED.index, schema.GATEWAY_DENIED.index),
        (counts[0], counts[1] - counts[0]),
    )


class GatewayResult(NamedTuple):
    """One gateway wave's outputs (all action axes are [B])."""

    agents: AgentTable | None
    verdict: torch.Tensor       # i8[B] GATE_* codes; GATE_ALLOWED == allowed
    ring_status: torch.Tensor   # i8[B] ring_ops.CHECK_* codes
    eff_ring: torch.Tensor      # i8[B] elevation-effective ring per action
    sigma_eff: torch.Tensor     # f32[B] the sigma the ring gate decided on
    severity: torch.Tensor      # i8[B] anomaly ladder at this record (0 = none)
    anomaly_rate: torch.Tensor  # f32[B] window anomaly rate at this record
    window_calls: torch.Tensor  # i32[B] window total at this record
    tripped: torch.Tensor       # bool[B] records that tripped the breaker
    metrics: MetricsTable | None = None
    trace: object = None


def _f32(x) -> float:
    return float(np.float32(x))


def check_actions(
    agents: AgentTable,
    elevations: ElevationTable,
    slot: torch.Tensor,             # i32[B] acting agent rows
    required_ring: torch.Tensor,    # i8[B]
    is_read_only: torch.Tensor,     # bool[B]
    has_consensus: torch.Tensor,    # bool[B]
    has_sre_witness: torch.Tensor,  # bool[B]
    host_tripped: torch.Tensor,     # bool[B] the host plane's breaker verdicts
    now,
    valid: torch.Tensor | None = None,  # bool[B] lane mask (padding lanes False)
    agent_base: int = 0,                # global row of agents[0] (a mesh shard)
    breach: BreachConfig = DEFAULT_CONFIG.breach,
    rate_limit: RateLimitConfig = DEFAULT_CONFIG.rate_limit,
    trust: TrustConfig = DEFAULT_CONFIG.trust,
    metrics: MetricsTable | None = None,
    trace=None,
    trace_ctx=None,
) -> GatewayResult:
    """Run B actions through every per-action gate; the agents' breach
    windows, breaker flags and deadlines and token buckets are updated
    IN PLACE (every bucket refilled to `now`, granted tokens taken), and
    the allowed/denied counters land in `metrics` when it rides.

    Gate order is the scalar pipeline's: breaker (the device flag while
    its cooldown runs, `host_tripped`, or an earlier record of this wave
    that tripped it) -> quarantine (only read-only actions pass) -> ring
    check at the effective ring -> rate, each bucket granting its
    passing actions in wave order while its refilled level covers them
    -> breach recording. Out-of-range slots are clamped onto the table
    (callers refuse them first: `HypervisorState._check_action_slots`).
    `agent_base` runs the same body on a table shard whose rows start at
    that global row (`parallel.collectives.sharded_gateway`): slots and
    grants are localized onto the shard."""
    b = slot.shape[0]
    n = agents.ring.shape[0]
    dev = slot.device
    now_f = f32_scalar(now, dev)
    if valid is None:
        valid = torch.ones((b,), dtype=torch.bool, device=dev)
    slot = (slot.to(torch.int64) - int(agent_base)).clamp(0, n - 1)
    required_ring = required_ring.to(torch.int8)

    # Per-action gathers.
    eff = security_ops.effective_rings(agents.ring, elevations, now_f, agent_base)[slot]
    sigma = agents.sigma_eff[slot]
    flags_at = agents.flags[slot]

    # Gate 1: the breaker, from both planes and the wave's own trips.
    pre_dev_live = ((flags_at & FLAG_BREAKER_TRIPPED) != 0) & (now_f < agents.bd_breaker_until[slot])
    base_calls, base_priv = security_ops.window_totals(agents.bd_window, now_f, breach)
    layout = _segment_layout(slot)
    ones = valid.to(torch.int32)
    privileged = (required_ring < eff) & valid
    (k_incl, _), (p_incl, _) = _segment_prefix_many(layout, (ones, privileged.to(torch.int32)))
    total_i = base_calls[slot] + k_incl
    priv_i = base_priv[slot] + p_incl
    analyzable = total_i >= breach.min_calls_for_analysis
    zero_f = torch.zeros((), dtype=torch.float32, device=dev)
    rate_i = torch.where(
        analyzable,
        priv_i.to(torch.float32) / torch.clamp(total_i, min=1).to(torch.float32),
        zero_f,
    )
    cond = (analyzable & (rate_i >= _f32(breach.high_threshold)) & valid).to(torch.int32)
    ((_, cond_before),) = _segment_prefix_many(layout, (cond,))
    live = (pre_dev_live | host_tripped | (cond_before > 0)) & valid
    # The record that trips is the first condition-true record of an
    # untripped agent; later ones are refused at gate 1 with no severity.
    trip_action = (cond != 0) & ~live & valid
    severity = sum(
        (rate_i >= _f32(th)).to(torch.int8)
        for th in (breach.low_threshold, breach.medium_threshold, breach.high_threshold,
                   breach.critical_threshold)
    )
    severity = torch.where(analyzable & ~live & valid, severity,
                           torch.zeros((), dtype=torch.int8, device=dev)).to(torch.int8)
    anomaly_rate = torch.where(severity > 0, rate_i, zero_f)

    # Gate 2: quarantine is read-only isolation.
    quarantined = (flags_at & FLAG_QUARANTINED) != 0
    refused_quar = ~live & quarantined & ~is_read_only & valid

    # Gate 3: the ring check at the effective ring.
    ring_status = ring_ops.ring_check(eff, required_ring, sigma, has_consensus, has_sre_witness,
                                      trust)
    refused_ring = ~live & ~refused_quar & (ring_status != ring_ops.CHECK_OK) & valid

    # Gate 4: the rate consume, settled in wave order among the passers.
    reaching = valid & ~(live | refused_quar | refused_ring)
    # Acting rows refill at their effective ring; padding lanes write a
    # spare row n, which is dropped. Lanes on one row write equal values.
    ring_for_rate = torch.cat([agents.ring, agents.ring[:1]])
    ring_for_rate[torch.where(valid, slot, n)] = eff
    refilled = rate_ops.refill(agents.rl_tokens, agents.rl_stamp, ring_for_rate[:n], now_f,
                               rate_limit)
    ((r_incl, _),) = _segment_prefix_many(layout, (reaching.to(torch.int32),))
    allowed = reaching & (r_incl.to(torch.float32) <= refilled[slot])

    verdict = torch.full((b,), GATE_RATE, dtype=torch.int8, device=dev)
    for cond_v, code in ((allowed, GATE_ALLOWED), (refused_ring, GATE_RING),
                         (refused_quar, GATE_QUARANTINED), (live, GATE_BREAKER),
                         (~valid, GATE_INVALID)):
        verdict = verdict.masked_fill(cond_v, code)

    # Post-state: calls, privileged calls, trips and grants per row in
    # one [A, 4] f32 scatter-add of 0/1 values (exact in any order).
    row_adds = torch.zeros((n, 4), dtype=torch.float32, device=dev).index_add_(
        0, slot,
        torch.stack([c.to(torch.float32) for c in (ones, privileged, trip_action, allowed)],
                    dim=1),
    )
    calls_add = row_adds[:, 0].to(torch.int32)
    priv_add = row_adds[:, 1].to(torch.int32)
    tripped_rows = row_adds[:, 2] > 0.0
    # Breakers whose cooldown has lapsed release, unless this wave tripped
    # them again.
    flags_col = agents.flags
    expired = (((flags_col & FLAG_BREAKER_TRIPPED) != 0) & (now_f >= agents.bd_breaker_until)
               & ~tripped_rows)
    flags = torch.where(expired, flags_col & ~FLAG_BREAKER_TRIPPED, flags_col)
    flags = torch.where(tripped_rows, flags | FLAG_BREAKER_TRIPPED, flags)
    breaker_until = torch.where(
        tripped_rows, now_f + f32_scalar(breach.circuit_breaker_cooldown_seconds, dev),
        agents.bd_breaker_until)
    window = security_ops.window_commit(agents.bd_window, calls_add, priv_add, now_f, breach)
    tokens = refilled - row_adds[:, 3]

    agents.i32[:, AI32_BD_WIN_START:AI32_BD_WIN_STOP] = window
    agents.i32[:, AI32_FLAGS] = flags
    agents.f32[:, AF32_BD_BREAKER_UNTIL] = breaker_until
    agents.f32[:, AF32_RL_TOKENS] = tokens
    agents.f32[:, AF32_RL_STAMP] = now_f
    if metrics is not None:
        tally_gateway(metrics, allowed, valid)
    if trace is not None:
        from hypervisor_tpu_torch.observability import tracing

        stamps = tracing.WaveStamps(trace_ctx, "gateway_wave")
        stamps.begin("gateway_wave", lane=b)
        stamps.end("gateway_wave", lane=b)
        stamps.commit(trace)
    return GatewayResult(
        agents=agents, verdict=verdict, ring_status=ring_status.to(torch.int8),
        eff_ring=eff.to(torch.int8), sigma_eff=sigma.to(torch.float32), severity=severity,
        anomaly_rate=anomaly_rate.to(torch.float32), window_calls=total_i.to(torch.int32),
        tripped=trip_action, metrics=metrics, trace=trace,
    )
