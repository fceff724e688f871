"""Incremental Merkle frontier: O(log n) session roots for the audit plane
(a copy of `hypervisor_tpu.audit.frontier`).

Keep at most one *perfect-subtree* root per height (an O(log n) node
stack riding the session like its DeltaLog rows do), so appending a leaf
merges equal-height subtrees upward (amortized O(1), worst case log2(n)
hashes) and the current root folds the stack bottom-up, at most
2·log2(n) hashes, reproducing the reference's odd-duplication semantics:
a trailing subtree at height h is raised to its sibling's height by
hashing it with ITSELF once per level, exactly what the batch tree's
`right := left` select does along its right edge.

Every combine is the interior rule sha256(hex(L) + hex(R)), so a
frontier root equals `ops.merkle.merkle_root_host` and
`ops.merkle.merkle_root_lanes` over the same leaves. `hash_count` tallies
every combine. Host-side by design: the fold is log2(n) sequential tiny
hashes, far below a device launch's latency.
"""

from __future__ import annotations

import hashlib

import numpy as np


def _words_to_hex(words) -> str:
    return "".join(f"{int(w) & 0xFFFFFFFF:08x}" for w in words)


def _hex_to_words(hex_digest: str) -> np.ndarray:
    return np.array(
        [int(hex_digest[i * 8 : (i + 1) * 8], 16) for i in range(8)],
        np.uint32,
    )


class MerkleFrontier:
    """Append-only incremental Merkle root (reference hex-pair semantics).

    The stack `_nodes` holds (height, hex_digest) of perfect subtrees in
    strictly decreasing height order; the set of heights is exactly the
    binary decomposition of `count`.
    """

    __slots__ = ("_nodes", "count", "hash_count")

    def __init__(self) -> None:
        self._nodes: list[tuple[int, str]] = []
        self.count = 0
        self.hash_count = 0

    # -- building -------------------------------------------------------

    def _combine(self, left: str, right: str) -> str:
        self.hash_count += 1
        return hashlib.sha256((left + right).encode()).hexdigest()

    def append_hex(self, leaf_hex: str) -> None:
        """Append one leaf (64-char hex digest): O(1) amortized hashes."""
        self._nodes.append((0, leaf_hex))
        self.count += 1
        while (
            len(self._nodes) >= 2
            and self._nodes[-1][0] == self._nodes[-2][0]
        ):
            h, right = self._nodes.pop()
            _, left = self._nodes.pop()
            self._nodes.append((h + 1, self._combine(left, right)))

    def append(self, digest_words) -> None:
        """Append one leaf given as u32[8] digest words."""
        self.append_hex(_words_to_hex(np.asarray(digest_words, np.uint32)))

    def extend(self, digests) -> None:
        """Append a [N, 8] batch of leaf digests in order."""
        for row in np.asarray(digests, np.uint32):
            self.append_hex(_words_to_hex(row))

    # -- querying -------------------------------------------------------

    def root_hex(self) -> str | None:
        """Current root (<= 2·log2(n) hashes), None when empty.

        Folds the stack from the lowest subtree upward. Before a
        trailing subtree meets a higher sibling it is raised level by
        level as H(x, x) — the reference's duplicated odd node.
        """
        if not self._nodes:
            return None
        nodes = self._nodes
        cur_h, cur = nodes[-1]
        for h, digest in reversed(nodes[:-1]):
            while cur_h < h:
                cur = self._combine(cur, cur)
                cur_h += 1
            cur = self._combine(digest, cur)
            cur_h = h + 1
        return cur

    def root_words(self) -> np.ndarray | None:
        """Current root as u32[8] words (the device/commitment format)."""
        root = self.root_hex()
        return None if root is None else _hex_to_words(root)

    # -- lifecycle ------------------------------------------------------

    def copy(self) -> "MerkleFrontier":
        fr = MerkleFrontier()
        fr._nodes = list(self._nodes)
        fr.count = self.count
        fr.hash_count = self.hash_count
        return fr

    def to_meta(self) -> dict:
        """JSON-serializable form (checkpoint host.json)."""
        return {
            "count": self.count,
            "hash_count": self.hash_count,
            "nodes": [[h, d] for h, d in self._nodes],
        }

    @classmethod
    def from_meta(cls, meta: dict) -> "MerkleFrontier":
        fr = cls()
        fr.count = int(meta["count"])
        fr.hash_count = int(meta.get("hash_count", 0))
        fr._nodes = [(int(h), str(d)) for h, d in meta["nodes"]]
        return fr

    @classmethod
    def from_leaf_digests(cls, digests) -> "MerkleFrontier":
        """Rebuild from recorded u32[N, 8] leaves (legacy-checkpoint
        restore: one-time O(n) hashes, O(log n) thereafter)."""
        fr = cls()
        fr.extend(digests)
        return fr

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"MerkleFrontier(count={self.count}, "
            f"heights={[h for h, _ in self._nodes]}, "
            f"hashes={self.hash_count})"
        )
