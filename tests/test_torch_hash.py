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
