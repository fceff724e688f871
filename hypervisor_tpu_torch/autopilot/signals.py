"""Deterministic drained-signal snapshots — the autopilot's only input.

The controller never reads live runtime objects while deciding: each
decision window it DRAINS one `SignalSnapshot` — a frozen, canonical,
host-plane view of the observatory (queue depths, shed/served counters,
SLO burn states, integrity violation totals, WAL backlog, roofline
headroom) — and every rule is a pure function of the snapshot stream.
That is the replay contract: the snapshot's `digest()` goes into the
decision ledger, so "same drained-state sequence -> identical decision
stream" is checkable bit-for-bit (`tests/unit/test_autopilot.py`).

Every field is either virtual-clock-deterministic (counters advanced by
the seeded soak loop) or quantized before digesting (the roofline
headroom gauge, measured wall — rounded to one decimal so jitter below
the rule's own threshold cannot perturb the digest). Wall-clock
timestamps, trace ids, and measured wave walls are deliberately ABSENT.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from hypervisor_tpu_torch.observability.snapshot import snapshot_digest

#: Burn-state severity order (worst wins when folding per-tenant).
_BURN_RANK = {"ok": 0, "warning": 1, "critical": 2}


def _items(d: dict) -> tuple:
    """Canonical (sorted, tuple-frozen) view of a counter dict."""
    return tuple(sorted((str(k), int(v)) for k, v in d.items()))


@dataclasses.dataclass(frozen=True)
class SignalSnapshot:
    """One decision window's drained observatory state (host-plane)."""

    seq: int
    now: float                                   # virtual clock, rounded
    # ── serving plane (front-door host counters) ─────────────────────
    queue_depths: tuple = ()                     # ((class, depth), ...)
    enqueued: tuple = ()                         # cumulative per class
    served: tuple = ()                           # cumulative per class
    shed: tuple = ()                             # cumulative per reason
    deadline_misses: int = 0
    buckets: tuple = ()                          # the CLOSED bucket set
    # ── SLO burn plane ───────────────────────────────────────────────
    burn_states: tuple = ()                      # ((class, state), ...)
    # ── tenancy plane (empty without a tenant scheduler) ─────────────
    tenant_burn: tuple = ()                      # ((tenant, worst state), ...)
    tenant_quanta: tuple = ()                    # ((tenant, quantum), ...)
    base_quantum: int = 0
    # ── integrity plane ──────────────────────────────────────────────
    integrity_violations: int = 0                # cumulative seen
    sanitize_every: int = 0
    scrub_every: int = 0
    # ── resilience plane ─────────────────────────────────────────────
    wal_backlog: int = 0                         # records since last ckpt
    # ── roofline headroom (quantized; None when never published) ─────
    floor_distance: Optional[float] = None

    #: Fields the digest EXCLUDES: advisory context consumed by no
    #: rule, contaminated by measured wave wall clock (a ticket's
    #: latency is virtual queue wait + measured dispatch wall, so burn
    #: states and deadline misses can flip across replays of the same
    #: trace). Every rule input stays digest-covered — that is the
    #: replay contract gate 6j pins. `tenant_burn` IS a rule input
    #: (drr.quantum) and stays in: it is practically deterministic
    #: (the gate-6g burn-alert precedent) and empty in solo serving,
    #: where the bit-identity gate runs.
    _ADVISORY_FIELDS = ("burn_states", "deadline_misses")

    def digest(self) -> str:
        """sha256 over the canonical encoding of the rule-input fields
        — the ledger's input-signal key. Identical snapshots =>
        identical digests; advisory wall-contaminated fields are
        excluded (see `_ADVISORY_FIELDS`). Encoding + advisory pop
        live in the ONE shared `observability.snapshot` helper; the
        quantization hook below is this snapshot's own schema."""

        def _quantize(payload: dict) -> None:
            payload["now"] = round(self.now, 6)
            if self.floor_distance is not None:
                payload["floor_distance"] = round(self.floor_distance, 1)

        return snapshot_digest(self, _quantize)

    # Convenience counter reads (rules use deltas between snapshots).

    def shed_of(self, reason: str) -> int:
        return dict(self.shed).get(reason, 0)

    def depth_of(self, queue: str) -> int:
        return dict(self.queue_depths).get(queue, 0)

    def served_total(self) -> int:
        return sum(v for _, v in self.served)


def drain_signals(
    seq: int,
    now: float,
    front=None,
    tenant_sched=None,
    integrity=None,
    supervisor=None,
    journal=None,
    floor_distance: Optional[float] = None,
) -> SignalSnapshot:
    """Build one snapshot from the attached planes' HOST counters.

    Cheap by construction: counter-dict reads and burn-state lookups
    only — no device_get, no metrics drain, no lock beyond the front
    door's own counter mutation discipline.
    """
    kw: dict = {"seq": int(seq), "now": round(float(now), 6)}
    if front is not None:
        kw["queue_depths"] = _items(
            {q: len(dq) for q, dq in front._queues.items()}
        )
        kw["enqueued"] = _items(front.enqueued)
        kw["served"] = _items(front.served)
        kw["shed"] = _items(front.shed)
        kw["deadline_misses"] = int(front.deadline_misses)
        kw["buckets"] = tuple(front.config.buckets)
        slo = getattr(front, "slo", None)
        if slo is not None:
            kw["burn_states"] = tuple(
                sorted((q, slo.state_of(q)) for q in front._queues)
            )
    if tenant_sched is not None:
        worst = {}
        for t, door in enumerate(tenant_sched.front.doors):
            states = [door.slo.state_of(q) for q in door._queues]
            worst[t] = max(states, key=lambda s: _BURN_RANK.get(s, 0))
        kw["tenant_burn"] = tuple(sorted(worst.items()))
        kw["tenant_quanta"] = tuple(
            (t, float(tenant_sched.quantum_of(t)))
            for t in range(tenant_sched.arena.num_tenants)
        )
        kw["base_quantum"] = int(tenant_sched.quantum)
    if integrity is not None:
        kw["integrity_violations"] = int(integrity.violations_seen)
        kw["sanitize_every"] = int(integrity.every)
        kw["scrub_every"] = int(integrity.scrub_every)
    if journal is not None:
        last = getattr(journal, "last_seq", 0) or 0
        ckpt_seq = 0
        if supervisor is not None and supervisor.last_checkpoint:
            ckpt_seq = int(supervisor.last_checkpoint.get("wal_seq") or 0)
        kw["wal_backlog"] = max(0, int(last) - ckpt_seq)
    if floor_distance is not None:
        kw["floor_distance"] = round(float(floor_distance), 1)
    return SignalSnapshot(**kw)


__all__ = ["SignalSnapshot", "drain_signals"]
