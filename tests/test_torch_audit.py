"""The port's audit plane against the reference, on the CPU.

B1's plain version against the reference's numpy twin of the Pallas
hash and `hashlib`; chain verification (whole chains and single links),
Merkle roots above the tree kernel's 4096 leaves, the host entries, the
delta packing, the incremental `MerkleFrontier` (its batched builder
too) and the trace span-word derivation, each against its JAX-package
counterpart on the same seeded inputs. Tolerance 0 everywhere.
"""

from __future__ import annotations

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervisor_tpu.audit.delta import merkle_root_host
from hypervisor_tpu.audit.frontier import MerkleFrontier as JaxFrontier
from hypervisor_tpu.kernels.mtu_pallas import tree_roots_np
from hypervisor_tpu.kernels.sha256_pallas import sha256_words_unrolled_np
from hypervisor_tpu.observability import tracing as jax_tracing
from hypervisor_tpu.ops import merkle as jax_merkle
from hypervisor_tpu.ops import sha256 as jax_sha256
from hypervisor_tpu_torch import u32
from hypervisor_tpu_torch.audit.frontier import MerkleFrontier
from hypervisor_tpu_torch.kernels import sha256 as sha_kernels
from hypervisor_tpu_torch.observability import profiling, tracing
from hypervisor_tpu_torch.ops import merkle
from hypervisor_tpu_torch.ops import sha256 as sha_ops


def _u32(rng, *shape):
    return rng.randint(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return u32.from_numpy_u32(a, "cpu")


@pytest.mark.parametrize("n_blocks", [1, 2, 3])
def test_sha256_words_plain_matches_unrolled_twin_and_hashlib(n_blocks):
    rng = np.random.RandomState(n_blocks)
    b = 1100  # not a multiple of the TPU kernel's 1024-message tile
    msg_len = 64 * n_blocks - 9 - rng.randint(0, 40)
    msgs = rng.randint(0, 256, (b, msg_len)).astype(np.uint8)
    words, nb = sha_ops.pad_messages_np(msgs, msg_len)
    assert nb == n_blocks
    got = u32.to_numpy_u32(sha_kernels.sha256_words_plain(_t(words), n_blocks))
    np.testing.assert_array_equal(got, sha256_words_unrolled_np(words, n_blocks))
    for i in (0, 517, b - 1):
        assert sha_ops.digests_to_hex(got[i:i + 1])[0] == hashlib.sha256(msgs[i].tobytes()).hexdigest()
    # The kernel's wrapper takes the plain version for CPU tensors.
    sha_kernels.sha256_words.launches = 0
    np.testing.assert_array_equal(
        u32.to_numpy_u32(sha_ops.sha256_blocks_dispatch(_t(words), n_blocks)), got)
    assert sha_kernels.sha256_words.launches == 0


def _ring(rng, c, n_sess=4, per=5):
    """A DeltaLog-shaped ring holding `n_sess` real chains of `per` links
    (zero seeds) at scattered rows, plus random rows."""
    body, digest = _u32(rng, c, 16), _u32(rng, c, 8)
    rows = rng.permutation(c)[: n_sess * per].reshape(n_sess, per)
    for chain_rows in rows:
        parent = b"\x00" * 32
        for r in chain_rows:
            parent = hashlib.sha256(body[r].astype(">u4").tobytes() + parent).digest()
            digest[r] = np.frombuffer(parent, ">u4")
    return body, digest, rows


def test_verify_chain_links_matches_reference():
    rng = np.random.RandomState(5)
    c = 40
    body, digest, chains = _ring(rng, c)
    digest[chains[2, 3], 5] ^= 1  # tamper one recorded digest
    rows, prev, seed = [], [], []
    for ch in chains:
        rows += list(ch)
        prev += [0] + list(ch[:-1])
        seed += [True] + [False] * (len(ch) - 1)
    rows += [c + 3, -2, 7, 11]    # out-of-range rows clip into the ring
    prev += [c + 9, -5, 3, 2]
    seed += [False, True, False, False]
    b = len(rows)
    rows, prev, seed = np.array(rows, np.int32), np.array(prev, np.int32), np.array(seed)
    valid = np.ones(b, bool)
    valid[[1, b - 1]] = False      # invalid lanes always pass
    want = np.asarray(jax_merkle.verify_chain_links(
        jnp.asarray(body), jnp.asarray(digest), jnp.asarray(rows), jnp.asarray(prev),
        jnp.asarray(seed), jnp.asarray(valid), use_pallas=False,
    ))
    got = merkle.verify_chain_links(
        _t(body), _t(digest), torch.from_numpy(rows), torch.from_numpy(prev),
        torch.from_numpy(seed), torch.from_numpy(valid),
    ).numpy()
    np.testing.assert_array_equal(got, want)
    host = merkle.verify_chain_links_host(_t(body), _t(digest), rows, prev, seed, valid)
    np.testing.assert_array_equal(host, want)
    np.testing.assert_array_equal(
        host, jax_merkle.verify_chain_links_host(body, digest, rows, prev, seed, valid))
    assert not want[2 * 5 + 3] and want[:10].all() and want[1]


def test_verify_chain_digests_matches_reference():
    rng = np.random.RandomState(8)
    n, lanes = 5, 6
    bodies = _u32(rng, n, lanes, 16)
    recorded = u32.to_numpy_u32(merkle.chain_digests(_t(bodies)))
    recorded[3, 1, 0] ^= 4      # tampered inside lane 1's count
    recorded[4, 2, 7] ^= 4      # tampered past lane 2's count
    counts = np.array([5, 5, 4, 0, 2, 5], np.int32)
    want = np.asarray(jax_merkle.verify_chain_digests(
        jnp.asarray(bodies), jnp.asarray(recorded), jnp.asarray(counts), use_pallas=False))
    got = merkle.verify_chain_digests(_t(bodies), _t(recorded), torch.from_numpy(counts)).numpy()
    np.testing.assert_array_equal(got, want)
    host = merkle.verify_chain_digests_host(bodies, recorded, counts, "cpu")
    np.testing.assert_array_equal(host, want)
    np.testing.assert_array_equal(
        host, jax_merkle.verify_chain_digests_host(bodies, recorded, counts, use_pallas=False))
    assert want.tolist() == [True, False, True, True, True, True]


def test_merkle_root_lanes_above_the_tree_kernel():
    """P = 8192 takes the level loop of hex pairs (B1 on CUDA): counts 0,
    1, 4097 and 8192 against the reference's tree twin and hashlib."""
    rng = np.random.RandomState(9)
    p = 8192
    counts = np.array([0, 1, 4097, 8192], np.int32)
    leaves = _u32(rng, len(counts), p, 8)
    got = u32.to_numpy_u32(merkle.merkle_root_lanes(_t(leaves), torch.from_numpy(counts)))
    np.testing.assert_array_equal(got, tree_roots_np(leaves, counts))
    np.testing.assert_array_equal(got[:2], leaves[:2, 0])
    hexes = sha_ops.digests_to_hex(leaves[2, :4097])
    assert sha_ops.digests_to_hex(got[2:3])[0] == merkle_root_host(hexes)
    np.testing.assert_array_equal(merkle.tree_roots_host(leaves, counts, "cpu"), got)


@pytest.mark.parametrize("p,counts", [(4, [0, 1, 3, 4]), (64, [2, 33, 64, 17])])
def test_tree_roots_host_matches_reference(p, counts):
    rng = np.random.RandomState(p)
    counts = np.array(counts, np.int32)
    leaves = _u32(rng, len(counts), p, 8)
    np.testing.assert_array_equal(
        merkle.tree_roots_host(leaves, counts, "cpu"),
        jax_merkle.tree_roots_host(leaves, counts, use_pallas=False),
    )


def test_pack_delta_bodies_and_hex_words_match_reference():
    rng = np.random.RandomState(4)
    n = 9
    args = (rng.randint(0, 500, n).astype(np.int32), rng.randint(0, 40, n).astype(np.int32),
            rng.randint(0, 900, n).astype(np.int32), _u32(rng, n, 8),
            rng.uniform(0, 100, n).astype(np.float32))
    np.testing.assert_array_equal(merkle.pack_delta_bodies(*args),
                                  jax_merkle.pack_delta_bodies(*args))
    hexes = sha_ops.digests_to_hex(_u32(rng, 5, 8))
    np.testing.assert_array_equal(sha_ops.hex_to_words(hexes), jax_sha256.hex_to_words(hexes))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merkle_frontier_matches_reference(seed):
    """Seeded leaf sequences, checked after every append: the root, the
    count, the hash count and the node stack; then the copy, the meta
    round trip and the rebuild from recorded leaves."""
    rng = np.random.RandomState(seed)
    port, ref = MerkleFrontier(), JaxFrontier()
    leaves = _u32(rng, 1 + rng.randint(20, 70), 8)
    assert port.root_hex() is None and port.root_words() is None
    for i in range(0, len(leaves), 1 + seed):
        batch = leaves[i:i + 1 + seed]
        port.extend(batch)
        ref.extend(batch)
        assert port.root_hex() == ref.root_hex()
        assert (port.count, port.hash_count) == (ref.count, ref.hash_count)
        assert port.to_meta() == ref.to_meta()
    np.testing.assert_array_equal(port.root_words(), ref.root_words())
    assert port.root_hex() == merkle_root_host(sha_ops.digests_to_hex(leaves))
    assert MerkleFrontier.from_meta(ref.to_meta()).root_hex() == ref.root_hex()
    assert port.copy().to_meta() == port.to_meta()
    assert MerkleFrontier.from_leaf_digests(leaves).to_meta() == \
        JaxFrontier.from_leaf_digests(leaves).to_meta()


#: Fresh lane lengths: every shape of the binary decomposition up to 33.
FRESH_COUNTS = (1, 2, 3, 4, 5, 7, 8, 16, 33)
FRONTIER_COUNTERS = ("frontier.lanes_fresh", "frontier.lanes_carried", "frontier.combines")


def _frontier_waves(case, rng):
    """Seeded waves of (slot, leaf count) lanes, and the prior leaf count
    of each slot that starts with some."""
    if case == "fresh":
        counts = list(FRESH_COUNTS) * 2
        rng.shuffle(counts)
        return {}, [list(enumerate(counts)), [(100 + i, c) for i, c in enumerate(FRESH_COUNTS)]]
    if case == "prior":
        priors = {s: int(rng.randint(1, 71)) for s in range(12)}
        return priors, [[(s, int(rng.choice(FRESH_COUNTS))) for s in range(12)]
                        for _ in range(3)]
    if case == "repeated":
        # Slot 0 fresh then twice more, slot 5 (with priors) twice, slot 9
        # fresh in the first wave and repeated in the second.
        return {5: 6, 6: 1}, [[(0, 3), (5, 2), (9, 4), (0, 1), (6, 7), (5, 5), (0, 2)],
                              [(9, 1), (7, 3), (9, 2), (7, 1)]]
    if case == "empty":
        # Empty lanes between, an empty first sight of fresh slot 2, and a
        # wave of empty lanes alone.
        return {4: 9}, [[(0, 0), (1, 3), (2, 0), (3, 5), (2, 4), (4, 0), (4, 2), (5, 0)],
                        [(6, 0), (7, 0)], [(1, 0), (8, 1), (2, 0)]]
    lanes = []
    for _ in range(4):
        n = int(rng.randint(1, 40))
        lanes.append([(int(s), int(c)) for s, c in
                      zip(rng.randint(0, 20, n), rng.randint(0, 12, n))])
    return {s: int(rng.randint(1, 71)) for s in range(0, 20, 3)}, lanes


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", ["fresh", "prior", "repeated", "empty", "mixed"])
def test_batched_frontier_builder_matches_per_leaf_path_and_reference(case, seed):
    """`MerkleFrontier.extend_lanes` on seeded ragged waves against the
    per-leaf `append_hex` path and the reference's `extend`, lane by lane
    in order: after every wave each slot's node stack, count, hash count
    and root; and the recorder's counters count exactly the fresh lanes,
    the carried lanes and the combines of the wave."""
    rng = np.random.RandomState(seed)
    priors, waves = _frontier_waves(case, rng)
    port, leafwise, ref = {}, {}, {}
    for s, n in priors.items():
        leaves = _u32(rng, n, 8)
        port[s], leafwise[s], ref[s] = MerkleFrontier(), MerkleFrontier(), JaxFrontier()
        for h in sha_ops.digests_to_hex(leaves):
            port[s].append_hex(h)
            leafwise[s].append_hex(h)
        ref[s].extend(leaves)
    for wave in waves:
        counts = np.array([c for _, c in wave], np.int64)
        leaves = _u32(rng, int(counts.sum()), 8)
        hexes = sha_ops.digests_to_hex(leaves)
        fresh = carried = combines = 0
        written: set = set()
        offset = 0
        for s, c in wave:
            fr = leafwise.setdefault(s, MerkleFrontier())
            if c:
                if fr.count or s in written:
                    carried += 1
                else:
                    fresh += 1
                written.add(s)
            before = fr.hash_count
            for h in hexes[offset:offset + c]:
                fr.append_hex(h)
            combines += fr.hash_count - before
            ref.setdefault(s, JaxFrontier()).extend(leaves[offset:offset + c])
            offset += c
        was = profiling.span_totals()["counters"]
        MerkleFrontier.extend_lanes([port.setdefault(s, MerkleFrontier()) for s, _ in wave],
                                    leaves, counts)
        now = profiling.span_totals()["counters"]
        assert [now.get(k, 0) - was.get(k, 0) for k in FRONTIER_COUNTERS] == \
            [fresh, carried, combines]
        assert sorted(port) == sorted(leafwise) == sorted(ref)
        for s in ref:
            assert port[s].to_meta() == leafwise[s].to_meta() == ref[s].to_meta(), s
            assert port[s].root_hex() == leafwise[s].root_hex() == ref[s].root_hex(), s


def test_child_span_word_wraps_like_the_reference():
    rng = np.random.RandomState(2)
    parents = _u32(rng, 32)
    parents[:3] = [0, 0xFFFFFFFF, 0x80000000]
    for stage in (0, 4, 11):
        want = np.asarray(jax_tracing.child_span_word(jnp.asarray(parents), stage))
        on_bits = tracing.child_span_word(_t(parents), stage).numpy()
        np.testing.assert_array_equal(on_bits, want.astype(np.int64))
        for p in parents[:5]:
            assert tracing.child_span_word(int(p), stage) == jax_tracing.child_span_word(int(p), stage)
