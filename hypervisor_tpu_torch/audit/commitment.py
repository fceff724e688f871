"""Summary-hash commitment: anchor each session's Merkle root at termination.

Capability parity with reference `audit/commitment.py:28-77` (per-session
commitment records, root-equality verification, batch queue/flush for
external anchoring; committed_to stays "local" — a real chain writer is
an integration concern). Extended for the device plane: each session
keeps a commitment *history* (re-commits after replay are first-class),
and roots may arrive as the u32[8] word vectors the Pallas SHA-256
kernel emits (`ops/merkle.py`) — `commit_device_root` folds them to the
canonical hex form so host- and device-computed roots verify through
one path.
"""

from __future__ import annotations

import secrets
from collections import deque
from dataclasses import dataclass, field
from datetime import datetime
from typing import Iterable, Optional

from hypervisor_tpu_torch.utils.clock import utc_now


def words_to_hex(root_words: Iterable[int]) -> str:
    """u32[8] device Merkle root -> 64-char hex digest string."""
    from hypervisor_tpu_torch.ops.sha256 import digests_to_hex

    return digests_to_hex([[int(w) & 0xFFFFFFFF for w in root_words]])[0]


@dataclass
class CommitmentRecord:
    session_id: str
    merkle_root: str
    participant_dids: list[str]
    delta_count: int
    committed_at: datetime = field(default_factory=utc_now)
    blockchain_tx_id: Optional[str] = None
    committed_to: str = "local"  # "local" | "ethereum" | "ipfs"
    commitment_id: str = field(
        default_factory=lambda: f"commit:{secrets.token_hex(4)}"
    )


class CommitmentEngine:
    """Per-session commitment histories + an anchoring queue."""

    def __init__(self) -> None:
        self._ledger: dict[str, list[CommitmentRecord]] = {}
        self._anchor_queue: deque[CommitmentRecord] = deque()

    def commit(
        self,
        session_id: str,
        merkle_root: str,
        participant_dids: list[str],
        delta_count: int,
    ) -> CommitmentRecord:
        record = CommitmentRecord(
            session_id=session_id,
            merkle_root=merkle_root,
            participant_dids=list(participant_dids),
            delta_count=delta_count,
        )
        self._ledger.setdefault(session_id, []).append(record)
        return record

    def commit_device_root(
        self,
        session_id: str,
        root_words: Iterable[int],
        participant_dids: list[str],
        delta_count: int,
    ) -> CommitmentRecord:
        """Commit a root produced on device as u32[8] words."""
        return self.commit(
            session_id, words_to_hex(root_words), participant_dids, delta_count
        )

    def commit_frontier(
        self,
        session_id: str,
        frontier,
        participant_dids: list[str],
    ) -> CommitmentRecord:
        """Commit straight from a session's incremental Merkle frontier
        (`audit.frontier.MerkleFrontier`): the root folds in O(log n)
        hashes and the delta count is the frontier's leaf count — no
        history re-hash at session end."""
        root = frontier.root_hex()
        if root is None:
            raise ValueError(f"empty frontier for {session_id}: nothing to commit")
        return self.commit(session_id, root, participant_dids, frontier.count)

    def verify_frontier(self, session_id: str, frontier) -> bool:
        root = frontier.root_hex()
        return root is not None and self.verify(session_id, root)

    def verify(self, session_id: str, expected_root: str) -> bool:
        """Does the latest commitment for the session carry this root?"""
        latest = self.get_commitment(session_id)
        return latest is not None and latest.merkle_root == expected_root

    def verify_device_root(self, session_id: str, root_words: Iterable[int]) -> bool:
        return self.verify(session_id, words_to_hex(root_words))

    def get_commitment(self, session_id: str) -> Optional[CommitmentRecord]:
        history = self._ledger.get(session_id)
        return history[-1] if history else None

    def get_history(self, session_id: str) -> list[CommitmentRecord]:
        return list(self._ledger.get(session_id, ()))

    # ── external anchoring queue ────────────────────────────────────────

    def queue_for_batch(self, record: CommitmentRecord) -> None:
        self._anchor_queue.append(record)

    def flush_batch(self) -> list[CommitmentRecord]:
        drained = list(self._anchor_queue)
        self._anchor_queue.clear()
        return drained
