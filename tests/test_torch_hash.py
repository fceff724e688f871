"""The port's hashing against the reference on the CPU: the plain SHA-256,
the plain delta chain (kernel B2's plain version) and the plain Merkle
roots (B3's), bit for bit against `hashlib`, the reference's numpy
kernel twins (`chain_digests_np`, `tree_roots_np`) and its XLA
`merkle_root_lanes` and `chain_digests`. Beside them, models of what
the Hopper kernels do lane by lane (the packed tree, the split chain,
the reordered round), held to the same references."""

from __future__ import annotations

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervisor_tpu.kernels.mtu_pallas import chain_digests_np, tree_roots_np
from hypervisor_tpu.ops import merkle as jax_merkle
from hypervisor_tpu.ops import sha256 as jax_sha
from hypervisor_tpu_torch import u32
from hypervisor_tpu_torch.kernels import mtu
from hypervisor_tpu_torch.ops import merkle, sha256

_JAX_TREE = jax.jit(jax_merkle.merkle_root_lanes, static_argnames=("use_pallas",))
_JAX_CHAIN = jax.jit(jax_merkle.chain_digests, static_argnames=("use_pallas",))


@pytest.mark.parametrize("msg_len", [0, 3, 55, 56, 64, 96, 128, 200])
def test_sha256_blocks_matches_hashlib(msg_len):
    msgs = np.random.RandomState(msg_len).randint(0, 256, (7, msg_len), dtype=np.uint8)
    words, n_blocks = sha256.pad_messages_np(msgs, msg_len)
    got = sha256.sha256_blocks(u32.from_numpy_u32(words, "cpu"), n_blocks)
    assert sha256.digests_to_hex(got) == [hashlib.sha256(m.tobytes()).hexdigest() for m in msgs]


def test_padding_constants_match_reference():
    for msg_len, n_blocks in ((96, 2), (128, 3), (64, 2), (32, 1)):
        np.testing.assert_array_equal(
            sha256.pad_tail_words(msg_len, n_blocks), jax_sha.pad_tail_words(msg_len, n_blocks)
        )
    np.testing.assert_array_equal(sha256._H0, jax_sha._H0)
    np.testing.assert_array_equal(sha256._K, jax_sha._K)


def test_hex_pair_matches_reference_combine():
    rng = np.random.RandomState(3)
    left = rng.randint(0, 2**32, (9, 8), dtype=np.uint64).astype(np.uint32)
    right = rng.randint(0, 2**32, (9, 8), dtype=np.uint64).astype(np.uint32)
    got = sha256.sha256_hex_pair(u32.from_numpy_u32(left, "cpu"), u32.from_numpy_u32(right, "cpu"))
    want = [
        hashlib.sha256((a + b).encode()).hexdigest()
        for a, b in zip(sha256.digests_to_hex(left), sha256.digests_to_hex(right))
    ]
    assert sha256.digests_to_hex(got) == want


@pytest.mark.parametrize("t,lanes,seeded", [(1, 5, False), (3, 10, False), (4, 6, True)])
def test_chain_plain_matches_twin_and_hashlib(t, lanes, seeded):
    rng = np.random.RandomState(t * 100 + lanes)
    bodies = rng.randint(0, 2**32, (t, lanes, 16), dtype=np.uint64).astype(np.uint32)
    seeds = (
        rng.randint(0, 2**32, (lanes, 8), dtype=np.uint64).astype(np.uint32)
        if seeded else np.zeros((lanes, 8), np.uint32)
    )
    got = u32.to_numpy_u32(
        mtu.chain_digests(u32.from_numpy_u32(bodies, "cpu"), u32.from_numpy_u32(seeds, "cpu"))
    )
    np.testing.assert_array_equal(got, chain_digests_np(bodies, seeds))
    for lane in (0, lanes - 1):
        parent = seeds[lane].astype(">u4").tobytes()
        for turn in range(t):
            parent = hashlib.sha256(bodies[turn, lane].astype(">u4").tobytes() + parent).digest()
            assert sha256.digests_to_hex(got[turn, lane][None])[0] == parent.hex()


def test_chain_op_defaults_to_a_zero_seed():
    bodies = np.random.RandomState(5).randint(0, 2**32, (2, 3, 16), dtype=np.uint64).astype(np.uint32)
    got = merkle.chain_digests(u32.from_numpy_u32(bodies, "cpu"))
    np.testing.assert_array_equal(
        u32.to_numpy_u32(got), chain_digests_np(bodies, np.zeros((3, 8), np.uint32))
    )


@pytest.mark.parametrize("p", [1, 2, 4, 8, 16])
def test_tree_plain_matches_twin_and_xla_for_every_count(p):
    counts = np.arange(p + 1, dtype=np.int32)
    s = counts.shape[0]
    leaves = np.random.RandomState(p).randint(0, 2**32, (s, p, 8), dtype=np.uint64).astype(np.uint32)
    got = u32.to_numpy_u32(
        mtu.tree_roots(u32.from_numpy_u32(leaves, "cpu"), torch.from_numpy(counts))
    )
    np.testing.assert_array_equal(got, tree_roots_np(leaves, counts))
    np.testing.assert_array_equal(
        got, np.asarray(_JAX_TREE(jnp.asarray(leaves), jnp.asarray(counts), use_pallas=False))
    )


def test_tree_lanes_per_session_packs_small_trees_into_warps():
    """B3's launch shape: up to 64 leaves a session takes P/2 lanes of a
    warp (16 sessions a warp at the wave's P = 4); above, a block each."""
    assert mtu.TREE_PACKED_MAX_LEAVES == 64
    for p in (2**k for k in range(13)):
        lanes = mtu.tree_lanes_per_session(p)
        if p <= 64:
            assert lanes == max(p // 2, 1) and 32 % lanes == 0
        else:
            assert lanes == 0
    assert 32 // mtu.tree_lanes_per_session(4) == 16
    assert 32 // mtu.tree_lanes_per_session(64) == 1


def _hex_pair(left, right) -> np.ndarray:
    msg = "".join(f"{int(w):08x}" for w in (*left, *right)).encode()
    return np.frombuffer(hashlib.sha256(msg).digest(), ">u4").astype(np.uint32)


def _packed_tree_model(leaves: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """What the packed B3 kernel (csrc/mtu.cu tree_packed_kernel) does, lane
    by lane: warps of 32 lanes, `lanes` a session, the grid rounded up to
    whole warps; each level every lane reads nodes 2j and 2j+1 of its
    segment (a shuffle: source lane modulo the width), then hashes where
    its session's predicate says so, else carries its left node."""
    s, p, _ = leaves.shape
    lanes = mtu.tree_lanes_per_session(p)
    threads = -(-s * lanes // 32) * 32
    sess, j = np.arange(threads) // lanes, np.arange(threads) % lanes
    live = sess < s
    cnt = np.where(live, counts[np.minimum(sess, s - 1)], 0)
    need = np.clip(cnt, 1, p)
    zero = np.zeros(8, np.uint32)
    left = [leaves[sess[t], 2 * j[t]] if live[t] and 2 * j[t] < need[t] else zero
            for t in range(threads)]
    right = [leaves[sess[t], 2 * j[t] + 1] if live[t] and 2 * j[t] + 1 < need[t] else zero
             for t in range(threads)]
    node = list(left)
    m = p
    while m > 1:
        if m != p:
            seg = (np.arange(threads) // lanes) * lanes
            left = [node[seg[t] + (2 * j[t]) % lanes] for t in range(threads)]
            right = [node[seg[t] + (2 * j[t] + 1) % lanes] for t in range(threads)]
        pairs = np.minimum((cnt + 1) >> 1, m >> 1)
        for t in range(threads):
            if live[t] and cnt[t] > 1 and j[t] < pairs[t]:
                r = left[t] if 2 * j[t] + 1 >= cnt[t] else right[t]
                node[t] = _hex_pair(left[t], r)
            else:
                node[t] = left[t]
        cnt = np.where(cnt > 1, (cnt + 1) >> 1, cnt)
        m >>= 1
    return np.stack([node[t] for t in range(threads) if live[t] and j[t] == 0])


@pytest.mark.parametrize("p", [1, 2, 4, 8, 16, 32, 64])
def test_packed_tree_model_matches_twin_for_every_count(p):
    """The packed kernel's lane-level design gives the reference's roots
    at every count 0..P, with the last warp ragged (S + 1 sessions)."""
    counts = np.concatenate([np.arange(p + 1), [p]]).astype(np.int32)
    leaves = np.random.RandomState(100 + p).randint(
        0, 2**32, (counts.shape[0], p, 8), dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(_packed_tree_model(leaves, counts), tree_roots_np(leaves, counts))


def test_tree_op_broadcasts_a_scalar_count():
    leaves = np.random.RandomState(9).randint(0, 2**32, (3, 4, 8), dtype=np.uint64).astype(np.uint32)
    got = merkle.merkle_root_lanes(u32.from_numpy_u32(leaves, "cpu"), 3)
    np.testing.assert_array_equal(u32.to_numpy_u32(got), tree_roots_np(leaves, np.full(3, 3)))


def test_wrappers_refuse_a_device_with_no_kernel_and_no_plain_path():
    bodies = torch.zeros((1, 2, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain path"):
        mtu.chain_digests(bodies, torch.zeros((2, 8), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="power of two"):
        mtu.tree_roots(torch.zeros((1, 3, 8), dtype=torch.int32), torch.zeros(1, dtype=torch.int32))


# ── models of the SHA-256 kernels (B1, B2 and the shared round) ──────


def _random_u32(rng, *shape) -> np.ndarray:
    return rng.randint(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _compress_np(state: np.ndarray, block: np.ndarray) -> np.ndarray:
    """The port's plain compression (`ops.sha256._compress`) on u32[n, 8]
    states and u32[n, 16] blocks."""
    wide = [torch.from_numpy(state[:, j].astype(np.int64)) for j in range(8)]
    words = [torch.from_numpy(block[:, j].astype(np.int64)) for j in range(16)]
    return torch.stack(sha256._compress(wide, words), dim=1).numpy().astype(np.uint32)


def _iv(n: int) -> np.ndarray:
    return np.broadcast_to(sha256._H0, (n, 8)).copy()


def _rotr(x: np.ndarray, n: int) -> np.ndarray:
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def _reordered_compress(state: np.ndarray, block: np.ndarray) -> np.ndarray:
    """The round as `csrc/sha256.cuh` sha256_compress writes it for the
    card: h + K_i + W_i formed a round ahead (the next round's h is this
    round's g) with the next message word, scheduled ahead into the
    rolling 16-word window; then t1 = (h + K + W) + S1 + Ch, e' = d + t1
    and a' = t1 + S0 + Maj. u32 arithmetic wraps mod 2^32, as the
    card's does."""
    k = sha256._K
    w = [block[:, j].copy() for j in range(16)]
    a, b, c, d, e, f, g, h = (state[:, j].copy() for j in range(8))
    hkw = h + k[0] + w[0]
    for i in range(64):
        hkw_next = None
        if i < 63:
            j = i + 1
            if j >= 16:
                w15, w2 = w[(j - 15) & 15], w[(j - 2) & 15]
                s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> np.uint32(3))
                s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> np.uint32(10))
                w[j & 15] = w[j & 15] + (s0 + w[(j - 7) & 15] + s1)
            hkw_next = g + k[j] + w[j & 15]
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t1 = hkw + s1 + ch
        e_next, a_next = d + t1, t1 + s0 + maj
        h, g, f, e, d, c, b, a = g, f, e, e_next, c, b, a, a_next
        hkw = hkw_next
    return state + np.stack([a, b, c, d, e, f, g, h], axis=1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reordered_round_matches_plain_compression(seed):
    """The card's round order (csrc/sha256.cuh sha256_compress, shared by
    B1, B2 and B3) gives `_compress`'s state on random blocks and
    states, and hashlib's digest from the initial value."""
    rng = np.random.RandomState(seed)
    state, block = _random_u32(rng, 64, 8), _random_u32(rng, 64, 16)
    np.testing.assert_array_equal(_reordered_compress(state, block), _compress_np(state, block))
    msgs = rng.randint(0, 256, (16, 55)).astype(np.uint8)
    words, _ = sha256.pad_messages_np(msgs, 55)
    got = _reordered_compress(_iv(16), words)
    assert sha256.digests_to_hex(got) == [hashlib.sha256(m.tobytes()).hexdigest() for m in msgs]


#: csrc/mtu.cu chain_kernel: lanes a block at most (its chain threads)
#: and threads a block (each computes one midstate a tile).
CHAIN_LANES, CHAIN_THREADS = 128, 512


def _chain_lanes_per_block(n_lanes: int, sms: int, cap: int = CHAIN_LANES) -> int:
    """hv_chain_digests' spread: ceil(L / SMs) lanes a block, at most
    `cap`, so the chain warps land on every SM."""
    return min(-(-n_lanes // sms), cap)


def _split_chain_model(bodies, seeds, sms=132, cap=CHAIN_LANES, threads=CHAIN_THREADS):
    """What B2 (csrc/mtu.cu chain_kernel) does, block by block, the blocks
    of equal width in lockstep: a block owns `lanes` consecutive lanes
    (`_chain_lanes_per_block`, the last block ragged) and walks T in
    tiles of k = threads // lanes turns. In each tile, thread tid
    compresses the body of (turn tid // lanes, lane tid % lanes) from the
    initial value into midstate slot tid of the tile's buffer
    (`ops.sha256._compress`); then lane l runs the tile's parent blocks
    in order from slots i * lanes + l, carrying its digest."""
    t, n_lanes, _ = bodies.shape
    chain_lanes = _chain_lanes_per_block(n_lanes, sms, cap)
    tail = np.broadcast_to(mtu._CHAIN_TAIL, (n_lanes, 8))
    out = np.zeros((t, n_lanes, 8), np.uint32)
    full = n_lanes // chain_lanes * chain_lanes
    for start, stop in ((0, full), (full, n_lanes)):
        if stop == start:
            continue
        lanes = min(chain_lanes, stop - start)
        k, n_blocks = threads // lanes, (stop - start) // lanes
        parent = seeds[start:stop]
        buffers = np.zeros((2, n_blocks, threads, 8), np.uint32)
        tid = np.arange(threads)
        my_turn, my_lane = tid // lanes, tid % lanes
        for tile, t0 in enumerate(range(0, t, k)):
            buf = buffers[tile % 2]
            live = (my_turn < k) & (t0 + my_turn < t)
            lane_idx = start + np.arange(n_blocks)[:, None] * lanes + my_lane[None, live]
            turn_idx = np.broadcast_to(t0 + my_turn[live], lane_idx.shape)
            body = bodies[turn_idx, lane_idx].reshape(-1, 16)
            buf[:, tid[live]] = _compress_np(_iv(body.shape[0]), body).reshape(n_blocks, -1, 8)
            for i in range(min(k, t - t0)):
                mid = buf[:, i * lanes + np.arange(lanes)].reshape(-1, 8)
                parent = _compress_np(mid, np.concatenate([parent, tail[start:stop]], axis=1))
                out[t0 + i, start:stop] = parent
    return out


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("lanes", [1, 13, 257])
@pytest.mark.parametrize("t", [1, 3, 5, 17])
def test_split_chain_model_matches_twin_xla_and_hashlib(t, lanes, seeded):
    """B2's split chain (body midstates apart, then the parent blocks in
    order) gives the reference's digests: `chain_digests_np`, the
    unarmed XLA `ops.merkle.chain_digests` and hashlib. At the kernel's
    spread over 132 SMs, and over 2 SMs with blocks of at most 8 lanes
    and 32 threads (k = 4 turns at full width), so T spans several
    tiles, ends mid-tile, and the last block is ragged."""
    rng = np.random.RandomState(1000 * t + lanes)
    bodies = _random_u32(rng, t, lanes, 16)
    seeds = _random_u32(rng, lanes, 8) if seeded else np.zeros((lanes, 8), np.uint32)
    want = chain_digests_np(bodies, seeds)
    np.testing.assert_array_equal(
        np.asarray(_JAX_CHAIN(jnp.asarray(bodies), jnp.asarray(seeds), use_pallas=False)), want)
    np.testing.assert_array_equal(_split_chain_model(bodies, seeds), want)
    np.testing.assert_array_equal(_split_chain_model(bodies, seeds, 2, 8, 32), want)
    for lane in (0, lanes - 1):
        parent = seeds[lane].astype(">u4").tobytes()
        for turn in range(t):
            parent = hashlib.sha256(bodies[turn, lane].astype(">u4").tobytes() + parent).digest()
        assert sha256.digests_to_hex(want[t - 1, lane][None])[0] == parent.hex()
