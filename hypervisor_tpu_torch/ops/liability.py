"""Joint-liability math (`hypervisor_tpu.ops.liability`): live edges, the
bonded contribution toward each joining agent (and the query forms:
per vouchee, per agent, per voucher, sigma_eff), and the depth-bounded
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


#: The reference's masked `[B, E]` sums are XLA:CPU reductions, which
#: XLA rewrites into windows of this many elements (each summed in order
#: from zero), then sums the window sums the same way, until one window
#: is left. `_row_sum_xla_order` adds in that order, so the f32 result is
#: the reference's bit for bit on any device.
_REDUCE_WINDOW = 32


def _row_sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """Sum the last axis in index order from +0.0 (one f32 add a step)."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _row_sum_xla_order(x: torch.Tensor) -> torch.Tensor:
    """f32[B] row sums of f32[B, E] in XLA:CPU's tree order: pad the row
    with zeros to a multiple of the window (half the padding in front,
    the odd one behind), sum each window in order, repeat on the window
    sums."""
    while x.shape[-1] > _REDUCE_WINDOW:
        pad = -x.shape[-1] % _REDUCE_WINDOW
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = _row_sum_in_order(x.reshape(*x.shape[:-1], -1, _REDUCE_WINDOW))
    return _row_sum_in_order(x)


def _pair_sum(
    v: VouchTable, key: torch.Tensor, slots: torch.Tensor,
    session_slots: torch.Tensor, now: torch.Tensor | float,
) -> torch.Tensor:
    """f32[B]: the live bonds whose `key` column and session match each
    query pair, summed in the reference's order."""
    m = (edge_live(v, now)[None, :]
         & (key[None, :] == slots[:, None])
         & (v.session[None, :] == session_slots[:, None]))
    return _row_sum_xla_order(torch.where(m, v.bond[None, :], torch.zeros((), device=v.bond.device)))


def voucher_contribution(
    v: VouchTable,
    vouchee_slots: torch.Tensor,
    session_slots: torch.Tensor,
    now: torch.Tensor | float,
    n_agents: int | None = None,
) -> torch.Tensor:
    """f32[B] sum of the live bonds toward each queried (vouchee,
    session) pair, from an i32[B] batch of each (`n_agents` is the
    reference's parameter and is not read)."""
    return _pair_sum(v, v.vouchee, vouchee_slots, session_slots, now)


def exposure_by_voucher(
    v: VouchTable,
    voucher_slots: torch.Tensor,
    session_slots: torch.Tensor,
    now: torch.Tensor | float,
) -> torch.Tensor:
    """f32[B] total sigma bonded by each queried (voucher, session) pair."""
    return _pair_sum(v, v.voucher, voucher_slots, session_slots, now)


def contribution_by_agent(
    v: VouchTable, session_of_agent: torch.Tensor, now: torch.Tensor | float
) -> torch.Tensor:
    """f32[N] live bonds toward each agent slot, counting only edges in
    the session the agent is in now. It is `contribution_toward` with the
    agent's current session as its target, so it runs the contribution's
    kernel on CUDA and sums in edge order on every device."""
    from hypervisor_tpu_torch.kernels import wave as wave_kernels

    return wave_kernels.contribution_toward(v, session_of_agent, now)


def sigma_eff(
    vouchee_sigma: torch.Tensor,
    risk_weight: torch.Tensor | float,
    contribution: torch.Tensor,
) -> torch.Tensor:
    """sigma_eff = sigma + omega * contribution, capped at 1.0 (the
    multiply and the add rounded apart, as the reference's eager ops)."""
    return torch.clamp(vouchee_sigma + risk_weight * contribution, max=1.0)


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
    allreduce=None,
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

    `allreduce` runs the cascade over an edge list sharded across a mesh
    (`parallel.collectives.sharded_slash`): `vouch` is then the sequence
    of the shards' edge tables, each on its shard's device, and
    `allreduce` maps the shards' i32[N] partials (each counted over its
    own edges) to their global sum, so the per-voucher counts and the
    has-own-vouchers seeding see the whole graph. This is the reference's
    XLA form: the plain scatter form per shard with the allreduce between
    the shards (B8's one cooperative launch cannot straddle shards). The
    result's `vouch` is then the sequence of shard tables, each with its
    new `active` column.
    """
    from hypervisor_tpu_torch.kernels import liability as liability_kernels

    n = sigma.shape[0]
    if allreduce is not None:
        new_sigma, active, slashed, clipped, wave_of = _slash_cascade_sharded(
            list(vouch), sigma, seeds, session_slot, risk_weight, now, trust, allreduce)
        if metrics is not None:
            from hypervisor_tpu_torch.tables.metrics import counters_add

            counters_add(metrics.counters, liability_kernels.TALLY_ROWS,
                         (slashed.sum(), clipped.sum()))
        vouch = [replace(part, active=a) for part, a in zip(vouch, active)]
    else:
        # B8 books the SLASHED and CLIPPED tallies into the counters
        # itself (in the kernel on CUDA, in its plain version on the CPU).
        new_sigma, active, slashed, clipped, wave_of = liability_kernels.slash_cascade(
            vouch, sigma, seeds, session_slot, risk_weight, now, trust,
            counters=None if metrics is None else metrics.counters)
        vouch = replace(vouch, active=active)
    if trace is not None:
        stamps = tracing.WaveStamps(trace_ctx, "slash_cascade")
        stamps.begin("slash_cascade", lane=n)
        stamps.end("slash_cascade", lane=n)
        trace = stamps.commit(trace)
    return SlashWaveResult(
        sigma=new_sigma, vouch=vouch, slashed=slashed,
        clipped=clipped, wave_of=wave_of, metrics=metrics, trace=trace,
    )


def _slash_cascade_sharded(parts, sigma, seeds, session_slot, risk_weight, now, trust,
                           allreduce):
    """The cascade over D edge shards (`slash_cascade(allreduce=)`): the
    steps of `kernels.liability.slash_cascade_plain`, each depth's counts
    made per shard over its edges and joined by `allreduce`. Sigma and
    the agent masks are replicated: one copy, on sigma's device, moved to
    a shard's device where it reads them. Returns (sigma, [active per
    shard], slashed, clipped, wave_of)."""
    from hypervisor_tpu_torch.kernels import liability as liability_kernels

    dev = sigma.device
    n = sigma.shape[0]
    f32 = liability_kernels._f32
    base = 1.0 - torch.full((), f32(risk_weight), dtype=torch.float32, device=dev)
    floor = torch.full((), f32(trust.sigma_floor), dtype=torch.float32, device=dev)
    wipe = liability_kernels.wipe_threshold(trust)
    sigma = sigma.to(torch.float32).clone()
    slashed = torch.zeros((n,), dtype=torch.bool, device=dev)
    clipped_any = torch.zeros((n,), dtype=torch.bool, device=dev)
    wave_of = torch.full((n,), -1, dtype=torch.int8, device=dev)
    wave = seeds.to(device=dev, dtype=torch.bool).clone()
    shards = [dict(
        v=v, active=v.active.clone(), vee_ok=v.vouchee >= 0, vchr_ok=v.voucher >= 0,
        vee=v.vouchee.clamp(min=0).to(torch.int64), vchr=v.voucher.clamp(min=0).to(torch.int64),
        in_session=v.session == int(session_slot),
        now=torch.full((), f32(now), dtype=torch.float32, device=v.voucher.device),
    ) for v in parts]

    def counts(edges, index: str) -> torch.Tensor:
        """The allreduced i32[N] count of each shard's `edges(shard)` mask,
        scattered at its `index` column."""
        return allreduce([
            torch.zeros((n,), dtype=torch.int32, device=sh["vee"].device).index_add_(
                0, sh[index], edges(sh).to(torch.int32))
            for sh in shards
        ]).to(dev)

    for depth in range(trust.max_cascade_depth + 1):
        sigma = torch.where(wave, torch.zeros_like(sigma), sigma)
        slashed = slashed | wave
        wave_of = torch.where(wave & (wave_of < 0), torch.full_like(wave_of, depth), wave_of)
        for sh in shards:
            live = sh["active"] & (sh["now"] <= sh["v"].expiry)
            sh["hit"] = (live & sh["in_session"] & sh["vee_ok"]
                         & wave.to(sh["vee"].device)[sh["vee"]])
        k = counts(lambda sh: sh["hit"] & sh["vchr_ok"], "vchr")
        was_clipped = k > 0
        clip_sigma = torch.maximum(sigma * liability_kernels.clip_factor(base, k), floor)
        sigma = torch.where(was_clipped, clip_sigma, sigma)
        clipped_any = clipped_any | was_clipped
        for sh in shards:
            sh["active"] = sh["active"] & ~sh["hit"]
        if depth == trust.max_cascade_depth:
            break
        wiped = was_clipped & (sigma < wipe)
        has_vouchers = counts(
            lambda sh: (sh["active"] & (sh["now"] <= sh["v"].expiry) & sh["in_session"]
                        & sh["vee_ok"]), "vee") > 0
        wave = wiped & has_vouchers & ~slashed
    return sigma, [sh["active"] for sh in shards], slashed, clipped_any, wave_of
