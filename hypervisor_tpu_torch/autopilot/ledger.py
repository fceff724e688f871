"""Append-only decision ledger — the autopilot's observability core.

Every applied proposal becomes a `Decision`: the input-signal digest
(which snapshot the rule saw), the rule that fired, the knob delta, a
deterministic CausalTraceId (the trace-plane join key: a ticket served
by a reshaped bucket can name the decision that reshaped it), and —
one window later — a post-hoc outcome attribution (did the signal move
as the rule predicted).

`digest()` hashes ONLY the deterministic decision identity (seq, rule,
knob, before->after, signal digest) — outcome attributions and trace
ids ride the ledger but stay OUT of the digest, so the replay contract
("same drained-state sequence -> identical decision stream") is exactly
the digest-equality check gate 6j and the `autopilot_soak` bench row
pin. Same shape as the soak decisions digest and the SLO alert digest.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional


@dataclasses.dataclass
class Decision:
    """One applied knob delta (append-only; outcome attributed later)."""

    seq: int
    now: float
    rule: str
    knob: str
    before: str
    after: str
    predicted: str
    signal_digest: str
    trace_id: str
    detail: dict = dataclasses.field(default_factory=dict)
    outcome: Optional[dict] = None   # {"ok": bool, "observed": {...}}

    def digest_line(self) -> str:
        """The decision's contribution to the ledger digest — identity
        only, no outcome, no trace id."""
        return (
            f"{self.seq}:{self.rule}:{self.knob}:"
            f"{self.before}->{self.after}:{self.signal_digest};"
        )

    def to_dict(self) -> dict:
        return {
            "seq": self.seq,
            "now": round(self.now, 6),
            "rule": self.rule,
            "knob": self.knob,
            "before": self.before,
            "after": self.after,
            "predicted": self.predicted,
            "signal_digest": self.signal_digest[:16],
            "trace_id": self.trace_id,
            "detail": self.detail,
            "outcome": self.outcome,
        }


class DecisionLedger:
    """Append-only decision log with a replayable running digest."""

    def __init__(self) -> None:
        self.decisions: list[Decision] = []
        self._digest = hashlib.sha256()
        self.outcomes = {"confirmed": 0, "refuted": 0}

    def __len__(self) -> int:
        return len(self.decisions)

    def record(
        self,
        now: float,
        rule: str,
        knob: str,
        before: str,
        after: str,
        predicted: str,
        signal_digest: str,
        detail: Optional[dict] = None,
    ) -> Decision:
        seq = len(self.decisions)
        # Deterministic trace id: a pure function of the decision
        # identity, so replays produce the same trace-plane join keys.
        key = hashlib.sha256(
            f"autopilot:{seq}:{rule}:{signal_digest}".encode()
        ).hexdigest()
        d = Decision(
            seq=seq,
            now=now,
            rule=rule,
            knob=knob,
            before=before,
            after=after,
            predicted=predicted,
            signal_digest=signal_digest,
            trace_id=f"{key[:32]}-{key[32:48]}",
            detail=dict(detail or {}),
        )
        self.decisions.append(d)
        self._digest.update(d.digest_line().encode())
        return d

    def attribute(self, decision: Decision, ok: bool, observed: dict) -> None:
        """Attach the post-hoc outcome (append-only: set once)."""
        if decision.outcome is not None:
            return
        decision.outcome = {"ok": bool(ok), "observed": observed}
        self.outcomes["confirmed" if ok else "refuted"] += 1

    def pending(self) -> list[Decision]:
        return [d for d in self.decisions if d.outcome is None]

    def digest(self) -> str:
        return self._digest.hexdigest()

    def summary(self, last: int = 8) -> dict:
        return {
            "decisions": len(self.decisions),
            "digest": self.digest(),
            "outcomes": dict(
                self.outcomes, pending=len(self.pending())
            ),
            "last": [d.to_dict() for d in self.decisions[-last:]],
        }


__all__ = ["Decision", "DecisionLedger"]
