"""Kernel B8, the slash cascade, for Hopper: `slash_cascade`.

Replaces `hypervisor_tpu/kernels/liability_pallas.py`
`slash_cascade_pallas` (`_gather_kernel`, `_scatter_kernel`). The TPU
form writes each depth's gather of the wave over the edges' vouchees,
the scatter-add of the hits over the vouchers and the has-vouchers
flag as one-hot bf16 matmuls in 1024-agent x 256-edge tiles, so they
run on the matrix unit; the one-hot tiles are not carried over. On
Hopper the cascade is bound by its launch and by the barriers between
its depths, not by its 1.3 MB of bytes: the whole cascade is ONE
cooperative launch, at most one block on each SM, with one phase and
one grid barrier a depth (`max_cascade_depth + 1` of each). In phase p
the threads settle depth p - 1 for the agents they own (the blacklist,
the clip) and test depth p's hits on the edges they own, each edge
settling its own vouchee's wave with the code the owner runs; a hit
adds into the voucher's count (an int32 atomic), marks the vouchee in
the wave and releases the bond, and no depth exits early, as the
reference has none. A thread keeps its first edges in registers across
depths (`held_edges` says how many the grid holds) and reloads the
rest. Integer atomics are exact in any order; no float is accumulated
by atomics. The outputs come from `torch.empty` and the kernel writes
every element; the per-depth counts and wave marks and the per-depth
agent states live in a workspace kept per device and stream, whose
counts and marks every launch leaves zero, so no call issues a device
op besides the launch.
A failed cooperative launch raises. When the metrics table's counter
column rides in, the launch also adds the slashed and clipped agents
to its `SLASHED` and `CLIPPED` rows (one unsigned atomic a block and
counter, wrapping at 2^32 like the u32 column); the plain version books
the same counts.

The clip factor (1 - omega)^k for the integer count k is the host C
library's: the reference's `jnp.power(1 - omega, k.astype(f32))` runs
on XLA's CPU backend as libm's `powf`, with a subnormal result flushed
to zero, and neither CUDA's powf, torch's f32 pow nor a float64 power
rounded once gives those bits everywhere. So `factor_table` calls the
host's `powf(1 - omega, (float)k)` through ctypes once per omega and k,
flushes, and caches the table by the f32 bits of 1 - omega and by
device (the last `FACTOR_TABLES_KEPT` used, host and device each); the
plain version gathers from it and the kernel reads it (k
clamped to its last entry), so the card and the CPU give the same bits.
On the card's machine that is the host's glibc, the library the
reference would call there. A table stops at its first zero (every
larger k gives zero too) or, at base 1, at its first entry; otherwise
it covers the largest k asked for: `k.max()` on the plain path, the
edge count for the kernel (no voucher's k can pass it). At a tiny
omega that is 65,537 calls, about 0.1 s once per omega; a caller who
cycles through more omegas than the cache keeps pays it on every call.

Sources: `csrc/liability.cu`. `slash_cascade_plain` is the reference's
scatter form (`hypervisor_tpu/ops/liability.py` `slash_cascade`) in
torch: what CPU tensors run and what the kernel is held against on the
card.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from collections import OrderedDict

import numpy as np
import torch

from hypervisor_tpu_torch.config import DEFAULT_CONFIG, TrustConfig
from hypervisor_tpu_torch.kernels import _build, work
from hypervisor_tpu_torch.kernels.mtu import _check_operand, _require, _route, _wrote
from hypervisor_tpu_torch.kernels.wave import _host_f32 as _f32
from hypervisor_tpu_torch.observability import metrics as schema
from hypervisor_tpu_torch.tables.metrics import counters_add
from hypervisor_tpu_torch.tables.state import VouchTable

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: The counter rows a cascade books: agents slashed and agents clipped.
TALLY_ROWS = (schema.SLASHED.index, schema.CLIPPED.index)
# (device, stream) -> the cascade's scratch for up to n agents: k
# int32[3n] and waved uint8[3n] (zero, and every launch leaves them
# zero), state_sigma f32[2n] and state_slashed uint8[2n] (any contents).
_workspaces: dict[tuple[torch.device, int], tuple[torch.Tensor, ...]] = {}


def wipe_threshold(trust: TrustConfig) -> float:
    """sigma_floor + cascade_wipe_epsilon summed in double and rounded
    once to float32, as the reference's comparison against a Python float
    does (0.06 -> 0x3D75C28F; a float32 sum on the device would land one
    ulp higher)."""
    return _f32(trust.sigma_floor + trust.cascade_wipe_epsilon)


_F32_TINY = float(np.finfo(np.float32).tiny)
_powf = None
#: Clip-factor tables kept, on the host and per device, the least
#: recently used evicted. A table holds at most k_max + 1 floats: 65,537
#: (256 KB) for the kernel at the default edge capacity.
FACTOR_TABLES_KEPT = 16
# f32 bits of the base -> (table, complete); (bits, device) -> table.
_host_tables: OrderedDict[int, tuple[np.ndarray, bool]] = OrderedDict()
_device_tables: OrderedDict[tuple[int, torch.device], torch.Tensor] = OrderedDict()


def _keep(cache: OrderedDict, key, value) -> None:
    cache[key] = value
    cache.move_to_end(key)
    while len(cache) > FACTOR_TABLES_KEPT:
        cache.popitem(last=False)


def _libm_powf():
    global _powf
    if _powf is None:
        name = ctypes.util.find_library("m")
        _require(name is not None, "the clip factor needs the C library's powf (libm)")
        fn = ctypes.CDLL(name).powf
        fn.argtypes = [ctypes.c_float, ctypes.c_float]
        fn.restype = ctypes.c_float
        _powf = fn
    return _powf


def factor_table(base, k_max: int, device) -> torch.Tensor:
    """f32[n] with entry k = libm powf(base, (float)k), a subnormal result
    flushed to zero: at least k = 0..k_max, or up to the entry past
    which every k gives the same value (the first zero; the first entry
    at base 1). Cached by the f32 bits of `base` and by device, the last
    `FACTOR_TABLES_KEPT` of each."""
    b = np.float32(base)
    bits = int(b.view(np.uint32))
    host, complete = _host_tables.get(bits, (np.zeros(0, np.float32), False))
    if not complete and host.size <= k_max:
        powf = _libm_powf()
        vals = host.tolist()
        while len(vals) <= k_max and not complete:
            v = powf(float(b), float(len(vals)))
            if abs(v) < _F32_TINY:
                v = 0.0 * v  # flush a subnormal, keeping its sign
            vals.append(v)
            complete = v == 0.0 or b == 1.0
        host = np.asarray(vals, np.float32)
    _keep(_host_tables, bits, (host, complete))
    key = (bits, torch.device(device))
    table = _device_tables.get(key)
    if table is None or table.numel() != host.size:
        table = torch.from_numpy(host).to(device)
    _keep(_device_tables, key, table)
    return table


def clip_factor(base: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """f32 base^k for integer k >= 0 (0 gives 1), `base` broadcast
    against `k`: each distinct base's `factor_table`, gathered at k."""
    base, k = torch.broadcast_tensors(base.to(torch.float32), k.to(torch.int64))
    if k.numel() == 0:
        return torch.empty(k.shape, dtype=torch.float32, device=k.device)
    bases, which = torch.unique(base.contiguous().view(torch.int32), return_inverse=True)
    tables = [factor_table(np.int32(b).view(np.float32), int(k.max()), k.device)
              for b in bases.tolist()]
    length = torch.tensor([t.numel() for t in tables], device=k.device)
    start = torch.cumsum(length, 0) - length
    return torch.cat(tables)[start[which] + torch.minimum(k, length[which] - 1)]


def slash_cascade_plain(
    vouch: VouchTable,
    sigma: torch.Tensor,
    seeds: torch.Tensor,
    session_slot: int,
    risk_weight,
    now,
    trust: TrustConfig = DEFAULT_CONFIG.trust,
    counters: torch.Tensor | None = None,
):
    """Plain version of B8: returns (sigma f32[N], active bool[E],
    slashed bool[N], clipped bool[N], wave_of i8[N]); the inputs are not
    written. The slashed and clipped counts are added to `counters`
    (rows `TALLY_ROWS`) when given."""
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
    if counters is not None:
        counters_add(counters, TALLY_ROWS, (slashed.sum(), clipped_any.sum()))
    return sigma, active, slashed, clipped_any, wave_of


def _workspace(dev: torch.device, stream: int, n: int):
    """The cascade's scratch on `stream`: zeroed once, when first made for
    at least `n` agents."""
    key = (dev, stream)
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < 3 * n:
        ws = (torch.zeros((3 * n,), dtype=torch.int32, device=dev),
              torch.zeros((3 * n,), dtype=torch.uint8, device=dev),
              torch.zeros((2 * n,), dtype=torch.float32, device=dev),
              torch.zeros((2 * n,), dtype=torch.uint8, device=dev))
        _workspaces[key] = ws
    return ws


def held_edges(device) -> int:
    """How many edges B8's grid keeps in registers across depths on
    `device` (a CUDA device): a graph with more edges reloads the rest
    at every depth."""
    edges = ctypes.c_longlong(0)
    with torch.cuda.device(device):
        err = _build.entry("liability", "hv_slash_held_edges", [_P])(ctypes.byref(edges))
    _build.check("liability", err, "held_edges")
    return edges.value


def grid_barrier_probe(reps: int, edges: int, agents: int, device) -> None:
    """One cooperative launch at the grid B8 takes for `edges` edges and
    `agents` agents that only crosses `reps` grid barriers, on the
    current stream: timed at two counts, the slope is one barrier."""
    dev = torch.device(device)
    with torch.cuda.device(dev):
        fn = _build.entry("liability", "hv_grid_barrier_probe", [_I, _I, _I, _P])
        err = fn(int(reps), int(edges), int(agents), torch.cuda.current_stream(dev).cuda_stream)
    _build.check("liability", err, "grid_barrier_probe")


def slash_cascade(
    vouch: VouchTable,
    sigma: torch.Tensor,   # f32[N]
    seeds: torch.Tensor,   # bool[N] the first wave
    session_slot: int,
    risk_weight,
    now,
    trust: TrustConfig = DEFAULT_CONFIG.trust,
    counters: torch.Tensor | None = None,  # i32[C] the metrics table's u32 counters
):
    """B8: the depth-bounded slash cascade; returns (sigma, active,
    slashed, clipped, wave_of) as new tensors (the inputs are not
    written), and adds the slashed and clipped counts to `counters` rows
    `TALLY_ROWS` IN PLACE when given. CUDA tensors launch one cooperative
    kernel; CPU tensors take `slash_cascade_plain`. The kernel trusts the
    voucher and vouchee indices (-1 takes no part)."""
    n, e = sigma.shape[0], vouch.voucher.shape[0]
    _require(tuple(seeds.shape) == (n,) and sigma.dim() == 1, "sigma, seeds: [N]")
    _require(trust.max_cascade_depth >= 0, "max_cascade_depth must be >= 0")
    _require(counters is None or (counters.dim() == 1 and counters.shape[0] > max(TALLY_ROWS)),
             "counters: [C] holding the slash tally rows")
    if not _route(sigma):
        return slash_cascade_plain(vouch, sigma, seeds, session_slot, risk_weight, now, trust,
                                   counters)
    dev = sigma.device
    for t, name, dtype in [
        (vouch.voucher, "vouches.voucher", torch.int32),
        (vouch.vouchee, "vouches.vouchee", torch.int32),
        (vouch.session, "vouches.session", torch.int32),
        (vouch.active, "vouches.active", torch.bool),
        (vouch.expiry, "vouches.expiry", torch.float32),
        (seeds, "seeds", torch.bool),
    ] + ([] if counters is None else [(counters, "counters", torch.int32)]):
        _check_operand(t, name, dtype, dev)
        if name.startswith("vouches."):
            _require(t.shape[0] == e, f"{name}: one entry per edge")
    _require(sigma.dtype == torch.float32 and sigma.device == dev, "sigma: float32 on the card")
    out_sigma = torch.empty((n,), dtype=torch.float32, device=dev)
    active = torch.empty((e,), dtype=torch.bool, device=dev)
    slashed = torch.empty((n,), dtype=torch.bool, device=dev)
    clipped = torch.empty((n,), dtype=torch.bool, device=dev)
    wave_of = torch.empty((n,), dtype=torch.int8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    workspace = _workspace(dev, stream, n)
    factor = factor_table(np.float32(1.0) - np.float32(_f32(risk_weight)), e, dev)
    fn = _build.entry("liability", "hv_slash_cascade",
                      [_P] * 7 + [_I] + [_P] * 11 + [_I] * 5 + [_F] * 3 + [_I] * 2 + [_P])
    with torch.cuda.device(dev):
        err = fn(
            vouch.voucher.data_ptr(), vouch.vouchee.data_ptr(), vouch.session.data_ptr(),
            vouch.active.data_ptr(), vouch.expiry.data_ptr(), seeds.data_ptr(),
            sigma.data_ptr(), sigma.stride(0) if n else 1, factor.data_ptr(),
            out_sigma.data_ptr(), active.data_ptr(), slashed.data_ptr(), clipped.data_ptr(),
            wave_of.data_ptr(), None if counters is None else counters.data_ptr(),
            *(t.data_ptr() for t in workspace), *TALLY_ROWS, factor.numel(), int(session_slot),
            trust.max_cascade_depth + 1, _f32(now), _f32(trust.sigma_floor),
            wipe_threshold(trust), e, n, stream,
        )
    _build.check("liability", err, "slash_cascade")
    _wrote(counters)
    slash_cascade.launches += 1
    work.note_launch("slash_cascade", edges=e, agents=n, depths=trust.max_cascade_depth + 1)
    return out_sigma, active, slashed, clipped, wave_of


slash_cascade.launches = 0
