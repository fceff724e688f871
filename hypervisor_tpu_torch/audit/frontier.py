"""Incremental Merkle frontier: O(log n) session roots for the audit plane
(`hypervisor_tpu.audit.frontier`, with a batched builder).

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

Every writer goes through `MerkleFrontier.extend_lanes`, which takes a
whole wave of lanes at once: one hex conversion for all their leaves, the
lanes with no leaf yet built level by level across lanes, the rest through
`append_hex`'s carry. It adds to the recorder's counters
`frontier.lanes_fresh`, `frontier.lanes_carried` and `frontier.combines`.
"""

from __future__ import annotations

import hashlib

import numpy as np

from hypervisor_tpu_torch.observability import profiling

#: Hex characters of one leaf or node digest.
_HEX = 64


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
        self.extend(np.asarray(digest_words, np.uint32).reshape(1, 8))

    def extend(self, digests) -> None:
        """Append a [N, 8] batch of leaf digests in order: the one-lane
        case of `extend_lanes`."""
        digests = np.asarray(digests, np.uint32).reshape(-1, 8)
        MerkleFrontier.extend_lanes([self], digests, [len(digests)])

    @staticmethod
    def extend_lanes(frontiers, leaves, counts) -> None:
        """Append a wave of lanes: lane i appends the next `counts[i]`
        rows of `leaves` (u32[N, 8], lanes in order) to `frontiers[i]`.

        One hex conversion serves every lane. A fresh lane (its frontier
        holds no leaf, and no earlier lane of this call wrote it) gets the
        perfect subtrees of its count's binary decomposition, built one
        level at a time across all fresh lanes: sibling nodes sit side by
        side in a level's hex string, so a parent hashes one slice. Its
        `hash_count` grows by t - popcount(t), the combines t appends
        make. Every other lane appends through `append_hex`, in lane
        order, so a frontier named twice takes its leaves in order.
        """
        counts = np.asarray(counts, np.int64).reshape(-1)
        if len(counts) != len(frontiers):
            raise ValueError(f"{len(frontiers)} frontiers for {len(counts)} lane counts")
        leaves = np.asarray(leaves, np.uint32).reshape(-1, 8)
        if int(counts.sum()) != len(leaves):
            raise ValueError(f"lane counts sum to {int(counts.sum())}, not {len(leaves)} leaves")
        if not len(leaves):
            return
        text = leaves.astype(">u4").tobytes().hex()
        starts = np.zeros(len(counts), np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        lane_counts = counts.tolist()
        fresh, carried, seen = [], [], set()
        for i, fr in enumerate(frontiers):
            if lane_counts[i]:
                (carried if fr.count or id(fr) in seen else fresh).append(i)
                seen.add(id(fr))
        combines = 0
        if fresh:
            combines += MerkleFrontier._build_fresh(
                [frontiers[i] for i in fresh], text, starts[fresh], counts[fresh])
        for i in carried:
            fr, lo = frontiers[i], int(starts[i]) * _HEX
            before = fr.hash_count
            for at in range(lo, lo + lane_counts[i] * _HEX, _HEX):
                fr.append_hex(text[at:at + _HEX])
            combines += fr.hash_count - before
        profiling.count("frontier.lanes_fresh", len(fresh))
        profiling.count("frontier.lanes_carried", len(carried))
        profiling.count("frontier.combines", combines)

    @staticmethod
    def _build_fresh(frontiers, text: str, starts: np.ndarray, counts: np.ndarray) -> int:
        """Set each empty frontier to its lane's perfect subtrees, level by
        level across lanes; returns the combines made. Level h holds a
        lane's t >> h nodes in a row from `first`; where bit h of t is set
        the last of them is the lane's subtree of height h."""
        level, hexes, first = text.encode("ascii"), None, starts
        stacks: list[list] = [[] for _ in frontiers]
        combines, h = 0, 0
        while True:
            n = counts >> h
            picks = np.flatnonzero(n & 1)
            if len(picks):
                last = (first[picks] + n[picks] - 1).tolist()
                nodes = ([text[i * _HEX:(i + 1) * _HEX] for i in last] if hexes is None
                         else [hexes[i] for i in last])
                for lane, node in zip(picks.tolist(), nodes):
                    stacks[lane].append((h, node))
            pairs = n >> 1
            total = int(pairs.sum())
            if not total:
                break
            lane_start = np.zeros(len(pairs), np.int64)
            np.cumsum(pairs[:-1], out=lane_start[1:])
            left = (np.repeat(first - 2 * lane_start, pairs) + 2 * np.arange(total)) * _HEX
            hexes = [hashlib.sha256(level[at:at + 2 * _HEX]).hexdigest() for at in left.tolist()]
            level = "".join(hexes).encode("ascii")
            combines += total
            first = lane_start
            h += 1
        for fr, stack, t in zip(frontiers, stacks, counts.tolist()):
            stack.reverse()
            fr._nodes = stack
            fr.count = t
            fr.hash_count += t - bin(t).count("1")
        return combines

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
