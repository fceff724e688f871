"""Merkle-chain audit ops (`hypervisor_tpu.ops.merkle`): delta chains,
per-lane Merkle roots, chain verification and the host entries the facade
and the scrubber call. CUDA tensors run the Hopper kernels — B2 chains
and B3 trees (`kernels.mtu`), B1 for every other batched hash
(`ops.sha256.sha256_blocks_dispatch`); CPU tensors run their plain
versions.

The host entries (`*_host`) dispatch as the reference's do: a CUDA
device takes the kernels; a CPU device takes the C++ hash unit
(`runtime.native`) when its library built; otherwise the plain torch
versions run on the CPU. All three give the same bits.

Reference semantics: the interior combine is sha256(ascii_hex(left) +
ascii_hex(right)), the odd node is duplicated at each level, and each
delta's hash covers its parent's hash.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from hypervisor_tpu_torch import u32
from hypervisor_tpu_torch.kernels import mtu
from hypervisor_tpu_torch.kernels.mtu import _CHAIN_TAIL, BODY_WORDS, TREE_MAX_LEAVES
from hypervisor_tpu_torch.ops.sha256 import hex_to_words, sha256_blocks_dispatch, sha256_hex_pair
from hypervisor_tpu_torch.runtime import native

__all__ = [
    "BODY_WORDS",
    "chain_digests",
    "merkle_root_host",
    "merkle_root_lanes",
    "pack_delta_bodies",
    "tree_roots_host",
    "verify_chain_digests",
    "verify_chain_digests_host",
    "verify_chain_links",
    "verify_chain_links_host",
]


def merkle_root_host(hashes: list[str]) -> str:
    """Host tree build over hex digests with `hashlib`: pairwise
    sha256(hexL + hexR), the odd node duplicated (the reference's
    `audit.delta.merkle_root_host`)."""
    level = list(hashes)
    while len(level) > 1:
        level = [
            hashlib.sha256(
                (level[i] + (level[i + 1] if i + 1 < len(level) else level[i])).encode()
            ).hexdigest()
            for i in range(0, len(level), 2)
        ]
    return level[0]


def chain_digests(bodies: torch.Tensor, seed: torch.Tensor | None = None) -> torch.Tensor:
    """int32[N, L, 16] bodies over N sequential turns of L lanes ->
    int32[N, L, 8] digests: digest_n = sha256(body_n || digest_{n-1}),
    digest_{-1} = seed (zeros by default)."""
    if seed is None:
        seed = torch.zeros((bodies.shape[1], 8), dtype=torch.int32, device=bodies.device)
    return mtu.chain_digests(bodies, seed)


def merkle_root_lanes(leaves: torch.Tensor, count) -> torch.Tensor:
    """int32[S, P, 8] leaves -> int32[S, 8] roots over the first `count`
    leaves of each lane (an int or int32[S]); count <= 1 gives leaf 0.

    Up to `TREE_MAX_LEAVES` leaves the whole forest is one tree-kernel
    call (B3). Above it the reference's level loop runs: each level
    hashes every (2j, 2j+1) pair of every lane as one batch of hex pairs
    (B1 on CUDA), the odd tail duplicated, lanes past their count
    carrying their left node."""
    s, p, _ = leaves.shape
    if isinstance(count, torch.Tensor):
        cnt = count.to(device=leaves.device, dtype=torch.int32).expand(s).contiguous()
    else:
        cnt = torch.full((s,), int(count), dtype=torch.int32, device=leaves.device)
    if p <= TREE_MAX_LEAVES:
        return mtu.tree_roots(leaves, cnt)
    arr = leaves
    while arr.shape[1] > 1:
        half = arr.shape[1] // 2
        left, right = arr[:, 0::2], arr[:, 1::2]
        j = torch.arange(half, dtype=torch.int32, device=arr.device)
        dup = (2 * j[None, :] + 1) >= cnt[:, None]
        right = torch.where(dup[:, :, None], left, right)
        combined = sha256_hex_pair(
            left.reshape(s * half, 8).contiguous(), right.reshape(s * half, 8).contiguous()
        ).reshape(s, half, 8)
        arr = torch.where((cnt > 1)[:, None, None], combined, left)
        cnt = torch.where(cnt > 1, (cnt + 1) // 2, cnt)
    return arr[:, 0].contiguous()


def verify_chain_digests(
    bodies: torch.Tensor,
    recorded: torch.Tensor,
    count: torch.Tensor,
    seed: torch.Tensor | None = None,
) -> torch.Tensor:
    """Tamper check: bool[L], True where the first count[l] recomputed
    chain digests of lane l (B2 on CUDA) equal the recorded ones.
    bodies int32[N, L, 16], recorded int32[N, L, 8], count i32[L]."""
    recomputed = chain_digests(bodies, seed)
    eq = (recomputed == recorded).all(dim=-1)  # [N, L]
    turn = torch.arange(bodies.shape[0], dtype=torch.int32, device=bodies.device)[:, None]
    in_range = turn < count.to(torch.int32)[None, :]
    return (eq | ~in_range).all(dim=0)


def verify_chain_links(
    body: torch.Tensor,       # int32[C, 16] the DeltaLog body column
    digest: torch.Tensor,     # int32[C, 8] the DeltaLog digest column
    rows: torch.Tensor,       # i32[B] ring rows to verify
    prev_rows: torch.Tensor,  # i32[B] parent rows (ignored where use_seed)
    use_seed: torch.Tensor,   # bool[B] lanes whose parent is the zero seed
    valid: torch.Tensor,      # bool[B] invalid lanes always pass
) -> torch.Tensor:
    """bool[B]: True where sha256(body[row] || parent) equals the
    recorded digest[row], or the lane is invalid. The scrubber's
    primitive: any (row, parent) pairs, one batch of 2-block messages
    through `sha256_blocks_dispatch` (B1 on CUDA). Rows and parents clip
    into the ring, as in the reference."""
    b = rows.shape[0]
    dev = body.device
    c = body.shape[0]
    safe_prev = prev_rows.to(torch.int64).clamp(0, digest.shape[0] - 1)
    parent = torch.where(
        use_seed[:, None], torch.zeros((b, 8), dtype=torch.int32, device=dev), digest[safe_prev]
    )
    safe_rows = rows.to(torch.int64).clamp(0, c - 1)
    tail = torch.tensor(_CHAIN_TAIL.view(np.int32), device=dev).expand(b, _CHAIN_TAIL.shape[0])
    msg = torch.cat([body[safe_rows], parent, tail], dim=1)
    recomputed = sha256_blocks_dispatch(msg, 2)
    ok = (recomputed == digest[safe_rows]).all(dim=-1)
    return ok | ~valid


# ── host entries: the kernels on CUDA, the C++ unit on a CPU ─────────


def _put_u32(arr, device) -> torch.Tensor:
    return u32.from_numpy_u32(np.asarray(arr, np.uint32), device)


def _native_route(device) -> bool:
    """True when a CPU device can take the C++ hash unit (its library
    built); a CUDA device always takes the kernels."""
    return torch.device(device).type != "cuda" and native.HAVE_NATIVE


def _be_bytes(words: np.ndarray) -> np.ndarray:
    """u32[..., W] words -> u8[..., 4W] big-endian bytes."""
    words = np.asarray(words, np.uint32)
    return np.ascontiguousarray(words.astype(">u4")).view(np.uint8).reshape(
        words.shape[:-1] + (4 * words.shape[-1],))


def tree_roots_host(leaves: np.ndarray, counts, device) -> np.ndarray:
    """Per-session Merkle roots over host leaves u32[S, P, 8] (P a power
    of two), counts i32[S] or a scalar: B3 (or B1 above 4096 leaves) on
    CUDA, the C++ unit lane by lane on a CPU with the library, else the
    plain versions. Returns u32[S, 8]; count <= 1 gives leaf 0."""
    leaves = np.asarray(leaves, np.uint32)
    s = leaves.shape[0]
    cnt = np.array(np.broadcast_to(np.asarray(counts, np.int32), (s,)))
    if _native_route(device):
        roots = np.zeros((s, 8), np.uint32)
        for i in range(s):
            c = int(cnt[i])
            if c <= 1:
                roots[i] = leaves[i, 0]
                continue
            roots[i] = hex_to_words([native.merkle_root_hex_host(_be_bytes(leaves[i, :c]))])[0]
        return roots
    roots = merkle_root_lanes(_put_u32(leaves, device), torch.from_numpy(cnt).to(device))
    return u32.to_numpy_u32(roots)


def verify_chain_digests_host(bodies, recorded, counts, device) -> np.ndarray:
    """`verify_chain_digests` over host arrays (u32[N, L, 16] bodies,
    u32[N, L, 8] recorded, counts i32[L]): B2 on CUDA, the C++ unit lane
    by lane on a CPU with the library, else the plain version. Zero-seed
    chains only — the DeltaLog's full-history format. Returns bool[L]."""
    bodies = np.asarray(bodies, np.uint32)
    lanes = bodies.shape[1]
    cnt = np.array(np.broadcast_to(np.asarray(counts, np.int32), (lanes,)))
    if _native_route(device):
        rec_bytes = _be_bytes(recorded)
        ok = np.zeros((lanes,), bool)
        for lane in range(lanes):
            c = int(cnt[lane])
            ok[lane] = c <= 0 or native.verify_chain_host(
                np.ascontiguousarray(bodies[:c, lane]),
                np.ascontiguousarray(rec_bytes[:c, lane])) == -1
        return ok
    ok = verify_chain_digests(
        _put_u32(bodies, device), _put_u32(recorded, device), torch.from_numpy(cnt).to(device)
    )
    return ok.cpu().numpy()


def verify_chain_links_host(body_col, digest_col, rows, prev_rows, use_seed, valid) -> np.ndarray:
    """`verify_chain_links` for a strip given as host arrays, over the
    DeltaLog columns (tensors on the state's device). On CUDA only the
    strip crosses and B1 hashes it; on a CPU with the library one
    `sha256_batch_host` sweep over the strip's 96-byte link messages;
    else the plain version. Returns bool[B]."""
    dev = body_col.device
    if _native_route(dev):
        def gather(col, idx):  # rows clipped into the ring, as in the reference
            idx = np.clip(np.asarray(idx, np.int64), 0, col.shape[0] - 1)
            return u32.to_numpy_u32(col[torch.from_numpy(idx).to(dev)])

        seed = np.asarray(use_seed, bool)[:, None]
        parent = np.where(seed, np.uint32(0), gather(digest_col, prev_rows))
        msg = np.concatenate([_be_bytes(gather(body_col, rows)), _be_bytes(parent)], axis=1)
        ok = (native.sha256_batch_host(msg) == _be_bytes(gather(digest_col, rows))).all(axis=1)
        return ok | ~np.asarray(valid, bool)

    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(dev)

    ok = verify_chain_links(
        body_col, digest_col, put(rows, np.int32), put(prev_rows, np.int32),
        put(use_seed, bool), put(valid, bool),
    )
    return ok.cpu().numpy()


def pack_delta_bodies(session, turn, agent, change_digest, timestamp) -> np.ndarray:
    """Host-side packing of delta metadata into u32[N, 16] records:
    [session, turn, agent, ts_bits, change_digest[8], zeros[4]]."""
    n = session.shape[0]
    body = np.zeros((n, BODY_WORDS), np.uint32)
    body[:, 0] = session.astype(np.uint32)
    body[:, 1] = turn.astype(np.uint32)
    body[:, 2] = agent.astype(np.uint32)
    body[:, 3] = np.asarray(timestamp, np.float32).view(np.uint32)
    body[:, 4:12] = change_digest.astype(np.uint32)
    return body
