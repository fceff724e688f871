"""Joint-liability math (`hypervisor_tpu.ops.liability`): live edges, the
bonded contribution toward each joining agent, and the depth-bounded
slash cascade.

The cascade is `max_cascade_depth + 1` masked edge passes: depth d
blacklists its wave, clips the wave's vouchers to max(sigma * (1 -
omega)^k, floor) for k simultaneous slashed vouchees, releases the
consumed bonds, and seeds depth d + 1 with the wiped vouchers that have
vouchers of their own. It runs kernel B8 for CUDA tensors and the plain
scatter form for CPU tensors (`kernels.liability`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hypervisor_tpu_torch.config import DEFAULT_CONFIG, TrustConfig
from hypervisor_tpu_torch.observability import tracing
from hypervisor_tpu_torch.tables.metrics import MetricsTable
from hypervisor_tpu_torch.tables.state import VouchTable
from hypervisor_tpu_torch.tables.struct import replace


def edge_live(v: VouchTable, now: torch.Tensor | float) -> torch.Tensor:
    """bool[E]: active, unexpired edges."""
    return v.active & (now <= v.expiry)


def scoped_edges(
    v: VouchTable, target_session_of_slot: torch.Tensor, now: torch.Tensor | float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(vouchee clamped to 0 as int64[E], bool[E] live edges scoped to
    the session their vouchee is joining)."""
    vee = v.vouchee.clamp(min=0).to(torch.int64)
    scoped = edge_live(v, now) & (v.vouchee >= 0) & (v.session == target_session_of_slot[vee])
    return vee, scoped


def contribution_toward(
    v: VouchTable, target_session_of_slot: torch.Tensor, now: torch.Tensor | float
) -> torch.Tensor:
    """f32[N] bonded sigma toward each agent slot, scoped to the session
    that slot is joining.

    A scatter-add over the edges, the plain form. On the CPU `index_add_`
    sums in edge order, like the reference's scatter, so any number of
    vouchers per vouchee agrees bit for bit. On CUDA `index_add_` adds
    with atomics in no fixed order; the wave's kernel path
    (`kernels.wave.contribution_toward`) sums in edge order instead.
    """
    n = target_session_of_slot.shape[0]
    vee, scoped = scoped_edges(v, target_session_of_slot, now)
    out = torch.zeros((n,), dtype=torch.float32, device=v.bond.device)
    return out.index_add_(0, vee, torch.where(scoped, v.bond, torch.zeros_like(v.bond)))


class SlashWaveResult(NamedTuple):
    sigma: torch.Tensor       # f32[N] updated scores
    vouch: VouchTable         # bonds released for consumed edges
    slashed: torch.Tensor     # bool[N] agents blacklisted at any depth
    clipped: torch.Tensor     # bool[N] agents clipped at any depth
    wave_of: torch.Tensor     # i8[N] depth an agent was slashed at (-1 none)
    metrics: "MetricsTable | None" = None  # updated in place when it rode in
    trace: object = None      # TraceLog, updated in place when it rode in


def slash_cascade(
    vouch: VouchTable,
    sigma: torch.Tensor,
    seeds: torch.Tensor,
    session_slot: int,
    risk_weight,
    now,
    trust: TrustConfig = DEFAULT_CONFIG.trust,
    metrics: "MetricsTable | None" = None,
    trace=None,      # TraceLog riding the cascade
    trace_ctx=None,  # observability.tracing.TraceContext
) -> SlashWaveResult:
    """Batched slash with a depth-bounded cascade, within one session's
    vouch graph: every slashed agent's sigma -> 0, its vouchers clipped
    to max(sigma * (1 - omega)^k, floor), the consumed bonds released,
    and a clipped voucher cascades when its new sigma < floor + epsilon
    and it has vouchers of its own, up to `max_cascade_depth`.

    The inputs are not written: the result carries new sigma and a vouch
    table whose `active` column is new. The SLASHED and CLIPPED counters
    and the hv.slash_cascade stamps land in the metrics table and trace
    ring IN PLACE when they ride in.
    """
    from hypervisor_tpu_torch.kernels import liability as liability_kernels

    n = sigma.shape[0]
    # B8 books the SLASHED and CLIPPED tallies into the counters itself
    # (in the kernel on CUDA, in its plain version on the CPU).
    new_sigma, active, slashed, clipped, wave_of = liability_kernels.slash_cascade(
        vouch, sigma, seeds, session_slot, risk_weight, now, trust,
        counters=None if metrics is None else metrics.counters)
    if trace is not None:
        stamps = tracing.WaveStamps(trace_ctx, "slash_cascade")
        stamps.begin("slash_cascade", lane=n)
        stamps.end("slash_cascade", lane=n)
        trace = stamps.commit(trace)
    return SlashWaveResult(
        sigma=new_sigma, vouch=replace(vouch, active=active), slashed=slashed,
        clipped=clipped, wave_of=wave_of, metrics=metrics, trace=trace,
    )
