"""Kernel B8, the slash cascade, for Hopper: `slash_cascade`.

Replaces `hypervisor_tpu/kernels/liability_pallas.py`
`slash_cascade_pallas` (`_gather_kernel`, `_scatter_kernel`). The TPU
form writes each depth's gather of the wave over the edges' vouchees,
the scatter-add of the hits over the vouchers and the has-vouchers
flag as one-hot bf16 matmuls in 1024-agent x 256-edge tiles, so they
run on the matrix unit; the one-hot tiles are not carried over. On
Hopper the cascade is bound by bytes: each of the `max_cascade_depth
+ 1` depths is one pass over the edges (one thread an edge, an int32
atomic into the voucher's count for each hit) and one over the agents
(the blacklist, the clip, the next wave), issued with no host
synchronisation and no early exit, as the reference has none. Integer
atomics are exact in any order; no float is accumulated by atomics.

The clip factor (1 - omega)^k for the integer count k is an exact
shared form, `clip_factor`: square-and-multiply in float64, rounded
once to float32. CUDA's powf is not correctly rounded and torch's f32
pow differs from the reference's by an ulp on some inputs; the double
products are IEEE on every device, so the kernel, the plain version on
the card and the plain version on the CPU give the same bits.

Sources: `csrc/liability.cu`. `slash_cascade_plain` is the reference's
scatter form (`hypervisor_tpu/ops/liability.py` `slash_cascade`) in
torch: what CPU tensors run and what the kernel is held against on the
card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hypervisor_tpu_torch.config import DEFAULT_CONFIG, TrustConfig
from hypervisor_tpu_torch.kernels import _build
from hypervisor_tpu_torch.kernels.mtu import _check_operand, _require, _route
from hypervisor_tpu_torch.kernels.wave import _host_f32 as _f32
from hypervisor_tpu_torch.tables.state import VouchTable

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def wipe_threshold(trust: TrustConfig) -> float:
    """sigma_floor + cascade_wipe_epsilon summed in double and rounded
    once to float32, as the reference's comparison against a Python float
    does (0.06 -> 0x3D75C28F; a float32 sum on the device would land one
    ulp higher)."""
    return _f32(trust.sigma_floor + trust.cascade_wipe_epsilon)


def clip_factor(base: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """f32 base^k for integer k >= 0 (0 gives 1): square-and-multiply in
    float64, rounded once to float32 — the kernel's `pow_int`."""
    b = base.to(torch.float64).expand(k.shape).clone()
    e = k.to(torch.int64).clone()
    p = torch.ones_like(b)
    while bool((e > 0).any()):
        p = torch.where((e & 1) == 1, p * b, p)
        b = b * b
        e = e >> 1
    return p.to(torch.float32)


def slash_cascade_plain(
    vouch: VouchTable,
    sigma: torch.Tensor,
    seeds: torch.Tensor,
    session_slot: int,
    risk_weight,
    now,
    trust: TrustConfig = DEFAULT_CONFIG.trust,
):
    """Plain version of B8: returns (sigma f32[N], active bool[E],
    slashed bool[N], clipped bool[N], wave_of i8[N]); the inputs are not
    written."""
    dev = sigma.device
    n = sigma.shape[0]
    omega = torch.full((), _f32(risk_weight), dtype=torch.float32, device=dev)
    now_t = torch.full((), _f32(now), dtype=torch.float32, device=dev)
    base = 1.0 - omega
    sess = int(session_slot)
    sigma = sigma.to(torch.float32).clone()
    slashed = torch.zeros((n,), dtype=torch.bool, device=dev)
    clipped_any = torch.zeros((n,), dtype=torch.bool, device=dev)
    wave_of = torch.full((n,), -1, dtype=torch.int8, device=dev)
    wave = seeds.to(torch.bool).clone()
    active = vouch.active.clone()
    vee_ok = vouch.vouchee >= 0
    vee = vouch.vouchee.clamp(min=0).to(torch.int64)
    vchr = vouch.voucher.clamp(min=0).to(torch.int64)
    in_session = vouch.session == sess
    floor = _f32(trust.sigma_floor)
    wipe = wipe_threshold(trust)

    for depth in range(trust.max_cascade_depth + 1):
        sigma = torch.where(wave, torch.zeros_like(sigma), sigma)
        slashed = slashed | wave
        wave_of = torch.where(wave & (wave_of < 0), torch.full_like(wave_of, depth), wave_of)
        live = active & (now_t <= vouch.expiry)
        hit = live & in_session & vee_ok & wave[vee]
        k = torch.zeros((n,), dtype=torch.int32, device=dev).index_add_(
            0, vchr, (hit & (vouch.voucher >= 0)).to(torch.int32))
        was_clipped = k > 0
        clip_sigma = torch.maximum(sigma * clip_factor(base, k), torch.tensor(floor, device=dev))
        sigma = torch.where(was_clipped, clip_sigma, sigma)
        clipped_any = clipped_any | was_clipped
        active = active & ~hit
        if depth == trust.max_cascade_depth:
            break
        wiped = was_clipped & (sigma < wipe)
        live2 = active & (now_t <= vouch.expiry)
        has_vouchers = torch.zeros((n,), dtype=torch.int32, device=dev).index_add_(
            0, vee, (live2 & in_session & vee_ok).to(torch.int32)) > 0
        wave = wiped & has_vouchers & ~slashed
    return sigma, active, slashed, clipped_any, wave_of


def slash_cascade(
    vouch: VouchTable,
    sigma: torch.Tensor,   # f32[N]
    seeds: torch.Tensor,   # bool[N] the first wave
    session_slot: int,
    risk_weight,
    now,
    trust: TrustConfig = DEFAULT_CONFIG.trust,
):
    """B8: the depth-bounded slash cascade; returns (sigma, active,
    slashed, clipped, wave_of) as new tensors (the inputs are not
    written). CUDA tensors launch two kernels a depth; CPU tensors take
    `slash_cascade_plain`. The kernels trust the voucher and vouchee
    indices (-1 takes no part)."""
    n, e = sigma.shape[0], vouch.voucher.shape[0]
    _require(tuple(seeds.shape) == (n,), "seeds: [N]")
    if not _route(sigma):
        return slash_cascade_plain(vouch, sigma, seeds, session_slot, risk_weight, now, trust)
    dev = sigma.device
    for t, name, dtype in [
        (vouch.voucher, "vouches.voucher", torch.int32),
        (vouch.vouchee, "vouches.vouchee", torch.int32),
        (vouch.session, "vouches.session", torch.int32),
        (vouch.active, "vouches.active", torch.bool),
        (vouch.expiry, "vouches.expiry", torch.float32),
        (seeds, "seeds", torch.bool),
    ]:
        _check_operand(t, name, dtype, dev)
        _require(t.shape[0] == (n if name == "seeds" else e), f"{name}: one entry per row")
    _require(sigma.dtype == torch.float32 and sigma.device == dev, "sigma: float32 on the card")
    out_sigma = sigma.clone(memory_format=torch.contiguous_format)
    active = vouch.active.clone()
    wave = seeds.clone()
    slashed = torch.zeros((n,), dtype=torch.bool, device=dev)
    clipped = torch.zeros((n,), dtype=torch.bool, device=dev)
    wave_of = torch.full((n,), -1, dtype=torch.int8, device=dev)
    k = torch.zeros((n,), dtype=torch.int32, device=dev)
    has_vouchers = torch.zeros((n,), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    edges = _build.entry("liability", "hv_slash_edges", [_P] * 8 + [_I, _F, _I, _P])
    agents = _build.entry("liability", "hv_slash_agents", [_P] * 7 + [_I, _I, _F, _F, _F, _I, _P])
    base = float(np.float32(1.0) - np.float32(_f32(risk_weight)))
    floor, wipe, now32, sess = _f32(trust.sigma_floor), wipe_threshold(trust), _f32(now), int(session_slot)
    for depth in range(trust.max_cascade_depth + 1):
        err = edges(vouch.voucher.data_ptr(), vouch.vouchee.data_ptr(), vouch.session.data_ptr(),
                    active.data_ptr(), vouch.expiry.data_ptr(), wave.data_ptr(), k.data_ptr(),
                    has_vouchers.data_ptr(), sess, now32, e, stream)
        _build.check("liability", err, "slash_cascade (edges)")
        slash_cascade.launches += 1
        err = agents(out_sigma.data_ptr(), wave.data_ptr(), slashed.data_ptr(), clipped.data_ptr(),
                     wave_of.data_ptr(), k.data_ptr(), has_vouchers.data_ptr(), depth,
                     int(depth == trust.max_cascade_depth), base, floor, wipe, n, stream)
        _build.check("liability", err, "slash_cascade (agents)")
        slash_cascade.launches += 1
    return out_sigma, active, slashed, clipped, wave_of


slash_cascade.launches = 0
