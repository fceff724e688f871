"""The audit phase's Hopper kernels: delta chains (B2) and Merkle roots (B3).

B2 `chain_digests` replaces `hypervisor_tpu/kernels/mtu_pallas.py`
`chain_digests_mtu`: d_t = sha256(body_t || d_{t-1}) per lane, a 96-byte
message in 2 blocks. Only the second block depends on the parent, so
the kernel splits each link there. The lanes spread over every SM
(ceil(L / SMs) a block, at most 128) and a block of 512 threads walks T
in tiles of 512 // lanes turns: every thread compresses one (turn,
lane) body from the initial value into a midstate in shared memory,
then one thread per lane runs the tile's parent blocks in order, the
parent digest in registers (the TPU's sequential grid axis and VMEM
carry become this loop). A lane's serial path falls from 2T
compressions to about T + 1, with no load from memory on it, and each
SMSP holds at most one chain warp. Two buffers let the next tile's
midstates start while the chain runs.

B2's ring form `chain_digests_ring` also replaces
`hypervisor_tpu/kernels/wave_pallas.py` `ring_append_pallas` (B6): the
wave's audit records (lane-major bodies and chain digests, turns
0..T-1, live prefix only) land on the DeltaLog ring from the same
launch. The thread that loads a body for its midstate stores it to the
body's ring row, the chain thread stores the digest with the row's
session and turn, and the device cursor advances by the live rows. B6's
own launch and its second read of the bodies and digests are gone.

B3 `tree_roots` replaces `hypervisor_tpu/kernels/mtu_pallas.py`
`tree_roots`: per-lane Merkle roots with the combine sha256(hex(l) ||
hex(r)) (128 bytes, 3 blocks), the odd tail duplicated, count <= 1
returning leaf 0. Also bound by integer operations, and at the main
path's P = 4 by latency: a session has only two dependent pair hashes.
Trees of at most `TREE_PACKED_MAX_LEAVES` leaves run packed, P/2 lanes
of a warp a session (`tree_lanes_per_session`), the levels passed
between lanes by warp shuffles, so a warp serves 16 sessions at P = 4
and most of the card's lanes hash. Larger trees take one block per
session with its level in shared memory (P x 8 words, 128 KB at P =
4096). Both hash only the pairs the root depends on. The TPU's
bit-reversed node order and 128-lane padding are dropped.

B2's tenant ring form `chain_digests_ring_tenants` serves T tenants'
waves in one launch (the reference vmaps its wave over tenants, and a
Pallas kernel batches by putting the tenant axis on its grid): the
chains over T x K lanes, and each tenant's live records appended onto
its own ring of the stacked DeltaLog at its own cursor.

Sources: `csrc/mtu.cu`, `csrc/sha256.cuh`. The plain versions below are
what CPU tensors run and what the kernels are held against on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hypervisor_tpu_torch.kernels import _build, work
from hypervisor_tpu_torch.ops.sha256 import hex_pair_message, pad_tail_words, sha256_blocks
from hypervisor_tpu_torch.tables.logs import BODY_WORDS, DeltaLog
from hypervisor_tpu_torch.tables.struct import tenant_view

_CHAIN_TAIL = pad_tail_words((BODY_WORDS + 8) * 4, 2)

_P, _I = ctypes.c_void_p, ctypes.c_int


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _route(t: torch.Tensor) -> bool:
    """True for the CUDA kernel, False for the plain CPU version; raises
    for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


def _check_operand(t: torch.Tensor, name: str, dtype, device, align: int = 1) -> None:
    _require(t.dtype == dtype, f"{name}: expected {dtype}, got {t.dtype}")
    _require(t.device == device, f"{name}: expected device {device}, got {t.device}")
    _require(t.is_contiguous(), f"{name}: must be contiguous")
    _require(t.data_ptr() % align == 0, f"{name}: must be {align}-byte aligned")


def _wrote(*written: torch.Tensor | None) -> None:
    """Move the version counter of each tensor a kernel wrote in place, as
    the plain version's in-place torch ops move it: a write through
    `data_ptr` leaves the counter where it was, and the tenant arena reads
    the counters of its lent tables to find what a solo op wrote."""
    for t in written:
        if t is not None:
            torch.autograd.graph.increment_version(t)


# ── B2: chains ───────────────────────────────────────────────────────


def chain_digests_plain(bodies: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """Plain version of B2: int32[T, L, 16] bodies, int32[L, 8] seeds ->
    int32[T, L, 8] digests (u32 bits)."""
    t, lanes, _ = bodies.shape
    tail = torch.tensor(_CHAIN_TAIL.view(np.int32), device=bodies.device)
    tail = tail.expand(lanes, tail.shape[0])
    parent = seeds
    out = []
    for turn in range(t):
        parent = sha256_blocks(torch.cat([bodies[turn], parent, tail], dim=1), 2)
        out.append(parent)
    if not out:
        return torch.empty((0, lanes, 8), dtype=torch.int32, device=bodies.device)
    return torch.stack(out)


def chain_digests(bodies: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """B2: per-lane delta chains. CUDA tensors launch the kernel; CPU
    tensors take `chain_digests_plain`."""
    _require(bodies.dim() == 3 and bodies.shape[2] == BODY_WORDS, "bodies: [T, L, 16]")
    t, lanes, _ = bodies.shape
    _require(tuple(seeds.shape) == (lanes, 8), "seeds: [L, 8]")
    if not _route(bodies):
        return chain_digests_plain(bodies, seeds)
    _check_operand(bodies, "bodies", torch.int32, bodies.device, align=16)
    _check_operand(seeds, "seeds", torch.int32, bodies.device, align=16)
    out = torch.empty((t, lanes, 8), dtype=torch.int32, device=bodies.device)
    fn = _build.entry("mtu", "hv_chain_digests", [_P, _P, _P, _I, _I, _P])
    err = fn(bodies.data_ptr(), seeds.data_ptr(), out.data_ptr(), t, lanes,
             torch.cuda.current_stream(bodies.device).cuda_stream)
    _build.check("mtu", err, "chain_digests")
    chain_digests.launches += 1
    work.note_launch("chain_digests", turns=t, lanes=lanes)
    return out


chain_digests.launches = 0


def chain_digests_ring_plain(
    bodies: torch.Tensor, seeds: torch.Tensor, delta_log: DeltaLog,
    wave_sessions: torch.Tensor, cursor: int, n_live: int,
) -> torch.Tensor:
    """Plain version of B2's ring form: `chain_digests_plain`, then B6's
    plain version `kernels.wave.ring_append_plain` of its first `n_live`
    lane-major rows, IN PLACE. Returns the chain."""
    from hypervisor_tpu_torch.kernels import wave  # wave imports this module

    chain = chain_digests_plain(bodies, seeds)
    wave.ring_append_plain(delta_log, bodies, chain, wave_sessions, cursor, n_live)
    return chain


def chain_digests_ring(
    bodies: torch.Tensor,         # int32[T, K, 16] u32 bits
    seeds: torch.Tensor,          # int32[K, 8] u32 bits
    delta_log: DeltaLog,
    wave_sessions: torch.Tensor,  # i32[K]
    cursor: int,                  # host mirror of delta_log.cursor
    n_live: int,                  # rows appended: the lane-major prefix
) -> torch.Tensor:
    """B2's ring form: the per-lane chains, and the first `n_live` of the
    wave's lane-major records (row k * T + t: body, digest, session
    wave_sessions[k], turn t) appended to the DeltaLog IN PLACE, its
    cursor advanced by `n_live`. Returns the chain, int32[T, K, 8]. CUDA
    tensors launch the kernel; CPU tensors take `chain_digests_ring_plain`.
    Refuses more live rows than the ring holds (one append would write a
    row twice, in no defined order)."""
    _require(bodies.dim() == 3 and bodies.shape[2] == BODY_WORDS, "bodies: [T, K, 16]")
    t, k, _ = bodies.shape
    _require(tuple(seeds.shape) == (k, 8), "seeds: [K, 8]")
    _require(tuple(wave_sessions.shape) == (k,), "wave_sessions: [K]")
    capacity = delta_log.body.shape[0]
    n_live, cursor = int(n_live), int(cursor)
    _require(0 <= n_live <= t * k, f"n_live {n_live} outside [0, {t * k}]")
    _require(n_live <= capacity, f"{n_live} rows in one append exceed the ring's {capacity}")
    if not _route(bodies):
        return chain_digests_ring_plain(bodies, seeds, delta_log, wave_sessions, cursor, n_live)
    _require(0 <= cursor < 2**31, "cursor: a non-negative int32")
    dev = bodies.device
    for tn, name, align in [
        (bodies, "bodies", 16), (seeds, "seeds", 16),
        (delta_log.body, "delta_log.body", 16), (delta_log.digest, "delta_log.digest", 16),
        (delta_log.session, "delta_log.session", 4), (delta_log.turn, "delta_log.turn", 4),
        (delta_log.cursor, "delta_log.cursor", 4), (wave_sessions, "wave_sessions", 4),
    ]:
        _check_operand(tn, name, torch.int32, dev, align)
    out = torch.empty((t, k, 8), dtype=torch.int32, device=dev)
    fn = _build.entry("mtu", "hv_chain_digests_ring", [_P, _P, _P, _I, _I] + [_P] * 6 + [_I] * 3 + [_P])
    err = fn(
        bodies.data_ptr(), seeds.data_ptr(), out.data_ptr(), t, k,
        delta_log.body.data_ptr(), delta_log.digest.data_ptr(), delta_log.session.data_ptr(),
        delta_log.turn.data_ptr(), delta_log.cursor.data_ptr(), wave_sessions.data_ptr(),
        cursor, n_live, capacity, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("mtu", err, "chain_digests_ring")
    _wrote(delta_log.body, delta_log.digest, delta_log.session, delta_log.turn, delta_log.cursor)
    if t > 0 and k > 0:
        chain_digests_ring.launches += 1
        work.note_launch("chain_digests_ring", turns=t, lanes=k, rows=n_live)
    return out


chain_digests_ring.launches = 0


def chain_digests_ring_tenants_plain(
    bodies: torch.Tensor, seeds: torch.Tensor, delta_log: DeltaLog,
    wave_sessions: torch.Tensor, cursors, n_live,
) -> torch.Tensor:
    """Plain version of B2's tenant ring form: `chain_digests_ring_plain`
    on each tenant's lanes and ring view, stacked -> int32[T_turns, T, K, 8]."""
    return torch.stack([
        chain_digests_ring_plain(bodies[:, t], seeds[t], tenant_view(delta_log, t),
                                 wave_sessions[t], int(cursors[t]), int(n_live[t]))
        for t in range(wave_sessions.shape[0])
    ], dim=1)


def chain_digests_ring_tenants(
    bodies: torch.Tensor,         # int32[T_turns, T, K, 16] u32 bits
    seeds: torch.Tensor,          # int32[T, K, 8] u32 bits
    delta_log: DeltaLog,          # stacked [T, C]
    wave_sessions: torch.Tensor,  # i32[T, K]
    cursors,                      # [T] host mirrors of each tenant's cursor
    n_live,                       # [T] rows each tenant appends
) -> torch.Tensor:
    """B2's tenant ring form: every tenant's chains, and each tenant's
    first `n_live[t]` lane-major records appended onto its own ring at
    `cursors[t]`, its cursor advanced by `n_live[t]`, IN PLACE, in one
    launch. Returns the chains, int32[T_turns, T, K, 8]. CPU tensors take
    `chain_digests_ring_tenants_plain`."""
    _require(bodies.dim() == 4 and bodies.shape[3] == BODY_WORDS, "bodies: [T_turns, T, K, 16]")
    turns, t_count, k, _ = bodies.shape
    _require(tuple(seeds.shape) == (t_count, k, 8), "seeds: [T, K, 8]")
    _require(tuple(wave_sessions.shape) == (t_count, k), "wave_sessions: [T, K]")
    capacity = delta_log.body.shape[1]
    cursors = [int(c) for c in cursors]
    n_live = [int(n) for n in n_live]
    _require(len(cursors) == t_count and len(n_live) == t_count, "cursors, n_live: [T]")
    for n in n_live:
        _require(0 <= n <= turns * k, f"n_live {n} outside [0, {turns * k}]")
        _require(n <= capacity, f"{n} rows in one append exceed the ring's {capacity}")
    if not _route(bodies):
        return chain_digests_ring_tenants_plain(bodies, seeds, delta_log, wave_sessions,
                                                cursors, n_live)
    _require(all(0 <= c < 2**31 for c in cursors), "cursors: non-negative int32")
    dev = bodies.device
    for tn, name, align in [
        (bodies, "bodies", 16), (seeds, "seeds", 16),
        (delta_log.body, "delta_log.body", 16), (delta_log.digest, "delta_log.digest", 16),
        (delta_log.session, "delta_log.session", 4), (delta_log.turn, "delta_log.turn", 4),
        (delta_log.cursor, "delta_log.cursor", 4), (wave_sessions, "wave_sessions", 4),
    ]:
        _check_operand(tn, name, torch.int32, dev, align)
    _require(tuple(delta_log.cursor.shape) == (t_count,), "delta_log.cursor: [T]")
    # The cursors cross as one pinned, non-blocking copy: the launch is not
    # held behind a host-synchronous one.
    rings = torch.tensor([cursors, n_live], dtype=torch.int32).pin_memory().to(
        dev, non_blocking=True)
    out = torch.empty((turns, t_count, k, 8), dtype=torch.int32, device=dev)
    fn = _build.entry("mtu", "hv_chain_digests_ring_tenants",
                      [_P, _P, _P, _I, _I, _I] + [_P] * 8 + [_I, _P])
    err = fn(
        bodies.data_ptr(), seeds.data_ptr(), out.data_ptr(), turns, t_count, k,
        delta_log.body.data_ptr(), delta_log.digest.data_ptr(), delta_log.session.data_ptr(),
        delta_log.turn.data_ptr(), delta_log.cursor.data_ptr(), wave_sessions.data_ptr(),
        rings[0].data_ptr(), rings[1].data_ptr(), capacity,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("mtu", err, "chain_digests_ring_tenants")
    _wrote(delta_log.body, delta_log.digest, delta_log.session, delta_log.turn, delta_log.cursor)
    if turns > 0 and t_count * k > 0:
        chain_digests_ring_tenants.launches += 1
        work.note_launch("chain_digests_ring_tenants", turns=turns, lanes=t_count * k,
                         rows=sum(n_live))
    return out


chain_digests_ring_tenants.launches = 0


# ── B3: Merkle roots ─────────────────────────────────────────────────

#: The largest leaf count per lane the tree kernel takes (its level must
#: fit the 227 KB of shared memory a block can use: 128 KB at 4096).
TREE_MAX_LEAVES = 4096

#: Trees of at most this many leaves run packed into warps: P/2 <= 32
#: lanes a session.
TREE_PACKED_MAX_LEAVES = 64


def tree_lanes_per_session(p: int) -> int:
    """Lanes of a warp one session takes in the packed tree kernel (P/2,
    and 1 for P = 1; a warp then serves 32 // lanes sessions), or 0 above
    `TREE_PACKED_MAX_LEAVES`, where each session gets a block of its own."""
    return max(p // 2, 1) if p <= TREE_PACKED_MAX_LEAVES else 0


def tree_roots_plain(leaves: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Plain version of B3: int32[S, P, 8] leaves, int32[S] counts ->
    int32[S, 8] roots, level by level over every pair."""
    s = leaves.shape[0]
    arr = leaves
    cnt = counts.to(torch.int32)
    while arr.shape[1] > 1:
        half = arr.shape[1] // 2
        left, right = arr[:, 0::2], arr[:, 1::2]
        j = torch.arange(half, dtype=torch.int32, device=arr.device)
        dup = (2 * j[None, :] + 1) >= cnt[:, None]
        right = torch.where(dup[:, :, None], left, right)
        combined = sha256_blocks(
            hex_pair_message(left.reshape(s * half, 8), right.reshape(s * half, 8)), 3
        ).reshape(s, half, 8)
        arr = torch.where((cnt > 1)[:, None, None], combined, left)
        cnt = torch.where(cnt > 1, (cnt + 1) // 2, cnt)
    return arr[:, 0].contiguous()


def tree_roots(leaves: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """B3: per-lane Merkle roots over the first counts[s] of P leaves
    (0 <= count <= P, P a power of two <= TREE_MAX_LEAVES). CUDA tensors
    launch the kernel; CPU tensors take `tree_roots_plain`."""
    _require(leaves.dim() == 3 and leaves.shape[2] == 8, "leaves: [S, P, 8]")
    s, p, _ = leaves.shape
    _require(p > 0 and p & (p - 1) == 0, "leaf capacity must be a power of two")
    _require(tuple(counts.shape) == (s,), "counts: [S]")
    if not _route(leaves):
        return tree_roots_plain(leaves, counts)
    _require(p <= TREE_MAX_LEAVES, f"the tree kernel takes at most {TREE_MAX_LEAVES} leaves")
    _check_operand(leaves, "leaves", torch.int32, leaves.device, align=16)
    _check_operand(counts, "counts", torch.int32, leaves.device)
    out = torch.empty((s, 8), dtype=torch.int32, device=leaves.device)
    fn = _build.entry("mtu", "hv_tree_roots", [_P, _P, _P, _I, _I, _I, _P])
    err = fn(leaves.data_ptr(), counts.data_ptr(), out.data_ptr(), s, p,
             tree_lanes_per_session(p), torch.cuda.current_stream(leaves.device).cuda_stream)
    _build.check("mtu", err, "tree_roots")
    tree_roots.launches += 1
    if work.counting():
        with work.paused():
            cs = counts.tolist()
        pairs, dup_pairs = work.tree_pairs(cs, p)
        work.note_launch("tree_roots", lanes=s, leaves=sum(min(max(c, 0), p) for c in cs),
                         pairs=pairs, dup_pairs=dup_pairs)
    return out


tree_roots.launches = 0
