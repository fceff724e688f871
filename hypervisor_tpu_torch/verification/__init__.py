"""DID transaction-history verification for the admission handshake.

Capability parity with reference `verification/history.py:53-161`:
no/short history -> PROBATIONARY (depth threshold 5), declared-history
consistency checks (duplicate summary hashes, non-monotonic timestamps,
hashes shorter than 16 chars -> SUSPICIOUS), per-DID result caching, and
`is_trustworthy` = VERIFIED or PROBATIONARY (untrustworthy agents get
forced to Ring 3 at join in the facade).

Structured as a rule pipeline: each consistency rule is a standalone
generator over the history columns, and the assessor folds whatever the
rules yield into the verdict — adding a rule never touches the verdict
logic. The temporal rule is one vector compare over the timestamp
column, so a batch of admission handshakes verifies in one sweep.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from datetime import datetime
from typing import Iterator, Optional

import numpy as np

from hypervisor_tpu_torch.config import DEFAULT_CONFIG
from hypervisor_tpu_torch.utils.clock import utc_now

__all__ = [
    "VerificationStatus",
    "TransactionRecord",
    "VerificationResult",
    "TransactionHistoryVerifier",
]


class VerificationStatus(str, enum.Enum):
    VERIFIED = "verified"
    PROBATIONARY = "probationary"
    SUSPICIOUS = "suspicious"
    UNREACHABLE = "unreachable"
    UNKNOWN = "unknown"


@dataclass
class TransactionRecord:
    session_id: str
    summary_hash: str
    timestamp: datetime
    participant_count: int = 0


@dataclass
class VerificationResult:
    agent_did: str
    status: VerificationStatus
    transactions_checked: int
    transactions_found: int
    inconsistencies: list[str] = field(default_factory=list)
    verified_at: datetime = field(default_factory=utc_now)
    cached: bool = False

    @property
    def is_trustworthy(self) -> bool:
        return self.status in (
            VerificationStatus.VERIFIED,
            VerificationStatus.PROBATIONARY,
        )


# ── consistency rules (each yields issue strings) ───────────────────────


def _rule_unique_hashes(
    history: list[TransactionRecord], min_hash_length: int
) -> Iterator[str]:
    owners: dict[str, str] = {}
    for tx in history:
        prior = owners.get(tx.summary_hash)
        if prior is not None:
            yield f"Duplicate hash in sessions {prior} and {tx.session_id}"
        owners[tx.summary_hash] = tx.session_id


def _rule_monotonic_time(
    history: list[TransactionRecord], min_hash_length: int
) -> Iterator[str]:
    stamps = np.array([tx.timestamp.timestamp() for tx in history])
    for i in np.nonzero(stamps[1:] < stamps[:-1])[0]:
        yield (
            f"Non-monotonic timestamps: {history[i + 1].session_id} "
            f"predates {history[i].session_id}"
        )


def _rule_wellformed_hashes(
    history: list[TransactionRecord], min_hash_length: int
) -> Iterator[str]:
    for tx in history:
        if len(tx.summary_hash or "") < min_hash_length:
            yield f"Invalid hash in session {tx.session_id}"


_RULES = (_rule_unique_hashes, _rule_monotonic_time, _rule_wellformed_hashes)


class TransactionHistoryVerifier:
    """Handshake-time history checker with per-DID caching."""

    REQUIRED_HISTORY_DEPTH = DEFAULT_CONFIG.verifier.min_history_depth
    MIN_HASH_LENGTH = DEFAULT_CONFIG.verifier.min_hash_length

    def __init__(self) -> None:
        self._verdicts: dict[str, VerificationResult] = {}

    def verify(
        self,
        agent_did: str,
        declared_history: Optional[list[TransactionRecord]] = None,
    ) -> VerificationResult:
        """Verify a DID's declared history (cached per DID)."""
        prior = self._verdicts.get(agent_did)
        if prior is not None:
            prior.cached = True
            return prior

        status, issues = self._assess(declared_history or [])
        verdict = VerificationResult(
            agent_did=agent_did,
            status=status,
            transactions_checked=len(declared_history or []),
            transactions_found=len(declared_history or []),
            inconsistencies=issues,
        )
        self._verdicts[agent_did] = verdict
        return verdict

    def _assess(
        self, history: list[TransactionRecord]
    ) -> tuple[VerificationStatus, list[str]]:
        if not history:
            return (
                VerificationStatus.PROBATIONARY,
                ["No transaction history available"],
            )
        if len(history) < self.REQUIRED_HISTORY_DEPTH:
            return (
                VerificationStatus.PROBATIONARY,
                [
                    f"Only {len(history)} transactions "
                    f"(need {self.REQUIRED_HISTORY_DEPTH})"
                ],
            )
        issues = [
            issue
            for rule in _RULES
            for issue in rule(history, self.MIN_HASH_LENGTH)
        ]
        status = (
            VerificationStatus.SUSPICIOUS if issues else VerificationStatus.VERIFIED
        )
        return status, issues

    def clear_cache(self, agent_did: Optional[str] = None) -> None:
        if agent_did:
            self._verdicts.pop(agent_did, None)
        else:
            self._verdicts.clear()
