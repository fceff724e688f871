"""Delta chains and Merkle roots by hashlib.

A copy of `chip_smoke.py`'s `hashlib_roots` (lines 4866-4885 at commit
c365212), which also returns the chain: each lane's chain is
sha256(body as big-endian words || parent) from a zero parent, one link
a turn; its root is the hex-pair tree over the chain's digests (interior
node sha256(hex(left) + hex(right)), an odd tail paired with itself, one
leaf its own root).
"""

from __future__ import annotations

import hashlib

import numpy as np


def merkle_root_hex(leaves: list) -> str:
    level = list(leaves)
    while len(level) > 1:
        if len(level) % 2:
            level.append(level[-1])
        level = [hashlib.sha256((level[i] + level[i + 1]).encode()).hexdigest()
                 for i in range(0, len(level), 2)]
    return level[0]


def chains_and_roots(bodies: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(chain u32[T, K, 8], roots u32[K, 8]) of u32[T, K, 16] bodies."""
    t, k, _ = bodies.shape
    lane_major = np.ascontiguousarray(np.transpose(bodies, (1, 0, 2))).astype(">u4").tobytes()
    chain = np.zeros((k, t, 32), np.uint8)
    roots = np.zeros((k, 32), np.uint8)
    sha = hashlib.sha256
    zero = b"\x00" * 32
    for lane in range(k):
        parent, hexes = zero, []
        base = lane * t * 64
        for turn in range(t):
            parent = sha(lane_major[base + turn * 64:base + turn * 64 + 64] + parent).digest()
            chain[lane, turn] = np.frombuffer(parent, np.uint8)
            hexes.append(parent.hex())
        roots[lane] = np.frombuffer(bytes.fromhex(merkle_root_hex(hexes)), np.uint8)
    chain_words = chain.view(">u4").astype(np.uint32).transpose(1, 0, 2)
    return np.ascontiguousarray(chain_words), roots.view(">u4").astype(np.uint32)


def words_hex(words: np.ndarray) -> str:
    return "".join(f"{int(w):08x}" for w in np.asarray(words, np.uint32))
