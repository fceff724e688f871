"""The port's hashing against the reference on the CPU: the plain SHA-256,
the plain delta chain (kernel B2's plain version) and the plain Merkle
roots (B3's), bit for bit against `hashlib`, the reference's numpy
kernel twins (`chain_digests_np`, `tree_roots_np`) and its XLA
`merkle_root_lanes`."""

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
