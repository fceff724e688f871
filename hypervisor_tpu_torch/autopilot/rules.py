"""The autopilot's rule families — pure functions of the snapshot stream.

Four deterministic rule families close ROADMAP item 5's loop
(docs/OPERATIONS.md "Autopilot" holds the operator-facing table):

  rule                signal                        knob
  ──────────────────  ────────────────────────────  ─────────────────────
  bucket.grow         queue_full shed delta         CLOSED bucket set +
                                                    queue depths (2x)
  bucket.shrink       quiet-window streak           drop largest grown
                                                    bucket (policy only —
                                                    the jit cache keeps
                                                    the compiled tile)
  drr.quantum         per-tenant worst burn state   per-tenant DRR quantum
  integrity.cadence   violation delta + roofline    sanitizer/scrub `every`
                      headroom
  checkpoint.wal      WAL records since last ckpt   background checkpoint
                      x per-record replay cost

`RuleEngine.step(snapshot)` folds the stream into proposals without
touching any runtime object — internal state (previous snapshot, streak
counters) is itself a deterministic fold, so two engines fed the same
snapshots emit identical proposal streams (property-pinned by
`tests/unit/test_autopilot.py`). The `Autopilot` plane applies proposals
and owns every side effect (pre-warm, reconfigure, emit, ledger).

Thresholds are env-armed per instantiation (hvlint HVA002) under the
`HV_AUTOPILOT_*` namespace; `HV_AUTOPILOT=0` is the plane-level kill
switch, read per `step` by the plane (not here — the engine stays pure).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from hypervisor_tpu_torch.autopilot.signals import SignalSnapshot

#: Rule family names (the ledger's `rule` column vocabulary).
RULE_BUCKET_GROW = "bucket.grow"
RULE_BUCKET_SHRINK = "bucket.shrink"
RULE_DRR_QUANTUM = "drr.quantum"
RULE_INTEGRITY_CADENCE = "integrity.cadence"
RULE_CHECKPOINT_WAL = "checkpoint.wal"

_BURN_RANK = {"ok": 0, "warning": 1, "critical": 2}


@dataclasses.dataclass(frozen=True)
class AutopilotConfig:
    """Rule thresholds (env-armed per instantiation, HVA002)."""

    #: Virtual seconds between decision windows (snapshot drains).
    decide_every_s: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("HV_AUTOPILOT_EVERY_S", 0.1)
        )
    )
    #: Largest bucket the grow rule may reach (the closed set's cap).
    max_bucket_cap: int = dataclasses.field(
        default_factory=lambda: int(
            os.environ.get("HV_AUTOPILOT_MAX_BUCKET", 64)
        )
    )
    #: queue_full sheds per window that trigger a grow.
    grow_shed_threshold: int = dataclasses.field(
        default_factory=lambda: int(
            os.environ.get("HV_AUTOPILOT_GROW_SHEDS", 1)
        )
    )
    #: Consecutive quiet windows (no queue_full sheds, near-empty
    #: queues) before a grown bucket is dropped again.
    shrink_after_windows: int = dataclasses.field(
        default_factory=lambda: int(
            os.environ.get("HV_AUTOPILOT_SHRINK_WINDOWS", 40)
        )
    )
    #: Per-tenant quantum multiplier while a tenant burns SLO budget.
    burn_quantum_boost: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("HV_AUTOPILOT_QUANTUM_BOOST", 2.0)
        )
    )
    #: Clean windows (zero new violations) before sanitizer cadence
    #: relaxes; any new violation tightens immediately.
    relax_after_windows: int = dataclasses.field(
        default_factory=lambda: int(
            os.environ.get("HV_AUTOPILOT_RELAX_WINDOWS", 8)
        )
    )
    #: Sanitizer cadence bounds (dispatches between fused sanitize
    #: passes; relax doubles toward max, tighten halves toward min).
    sanitize_every_min: int = 1
    sanitize_every_max: int = dataclasses.field(
        default_factory=lambda: int(
            os.environ.get("HV_AUTOPILOT_SANITIZE_MAX", 64)
        )
    )
    #: Roofline floor-distance above which the plane counts as busy
    #: (no headroom -> no cadence relax). None published => headroom ok.
    headroom_floor: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("HV_AUTOPILOT_HEADROOM_FLOOR", 8.0)
        )
    )
    #: WAL replay budget (estimated seconds) that triggers a background
    #: checkpoint, and the per-record replay cost estimate.
    wal_replay_budget_s: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("HV_AUTOPILOT_WAL_BUDGET_S", 0.5)
        )
    )
    wal_cost_per_record_s: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("HV_AUTOPILOT_WAL_RECORD_S", 1e-4)
        )
    )


@dataclasses.dataclass(frozen=True)
class Proposal:
    """One knob delta a rule wants applied (pure data, no side effect)."""

    rule: str          # rule family (RULE_* vocabulary)
    knob: str          # knob path, e.g. "buckets", "quantum[2]"
    before: str        # rendered prior value
    after: str         # rendered proposed value
    predicted: str     # the outcome the rule forecasts (attributed later)
    detail: dict = dataclasses.field(default_factory=dict)


class RuleEngine:
    """Deterministic fold: snapshot stream -> proposal stream."""

    def __init__(self, config: Optional[AutopilotConfig] = None) -> None:
        self.config = config or AutopilotConfig()
        self.prev: Optional[SignalSnapshot] = None
        self.quiet_windows = 0      # no queue_full sheds, queues near-empty
        self.clean_windows = 0      # no new integrity violations
        self._base_buckets: Optional[tuple] = None
        self._boosted: set[int] = set()   # tenants with boosted quantum

    def step(self, cur: SignalSnapshot) -> list[Proposal]:
        cfg = self.config
        prev, self.prev = self.prev, cur
        if self._base_buckets is None and cur.buckets:
            self._base_buckets = tuple(cur.buckets)
        if prev is None:
            return []
        out: list[Proposal] = []
        out += self._bucket_rules(cfg, prev, cur)
        out += self._quantum_rules(cfg, prev, cur)
        out += self._cadence_rules(cfg, prev, cur)
        out += self._checkpoint_rules(cfg, prev, cur)
        return out

    # ── (1) bucket grow/shrink ───────────────────────────────────────

    def _bucket_rules(self, cfg, prev, cur) -> list[Proposal]:
        if not cur.buckets:
            return []
        shed_delta = cur.shed_of("queue_full") - prev.shed_of("queue_full")
        depth_total = sum(v for _, v in cur.queue_depths)
        if shed_delta == 0 and depth_total <= min(cur.buckets):
            self.quiet_windows += 1
        else:
            self.quiet_windows = 0
        max_bucket = max(cur.buckets)
        if (
            shed_delta >= cfg.grow_shed_threshold
            and max_bucket < cfg.max_bucket_cap
        ):
            new_bucket = max_bucket * 2
            grown = tuple(sorted(set(cur.buckets) | {new_bucket}))
            return [
                Proposal(
                    rule=RULE_BUCKET_GROW,
                    knob="buckets",
                    before=str(tuple(cur.buckets)),
                    after=str(grown),
                    predicted="queue_full shed rate falls",
                    detail={
                        "new_bucket": new_bucket,
                        "shed_delta": shed_delta,
                        "depth_factor": 2,
                    },
                )
            ]
        if (
            self._base_buckets is not None
            and len(cur.buckets) > len(self._base_buckets)
            and self.quiet_windows >= cfg.shrink_after_windows
        ):
            shrunk = tuple(sorted(cur.buckets))[:-1]
            self.quiet_windows = 0
            return [
                Proposal(
                    rule=RULE_BUCKET_SHRINK,
                    knob="buckets",
                    before=str(tuple(cur.buckets)),
                    after=str(shrunk),
                    predicted="no queue_full sheds reappear",
                    detail={"dropped_bucket": max(cur.buckets)},
                )
            ]
        return []

    # ── (2) per-tenant DRR quanta ────────────────────────────────────

    def _quantum_rules(self, cfg, prev, cur) -> list[Proposal]:
        if not cur.tenant_burn or not cur.base_quantum:
            return []
        out: list[Proposal] = []
        quanta = dict(cur.tenant_quanta)
        base = float(cur.base_quantum)
        for tenant, state in cur.tenant_burn:
            burning = _BURN_RANK.get(state, 0) >= _BURN_RANK["warning"]
            boosted = tenant in self._boosted
            if burning and not boosted:
                self._boosted.add(tenant)
                out.append(
                    Proposal(
                        rule=RULE_DRR_QUANTUM,
                        knob=f"quantum[{tenant}]",
                        before=str(quanta.get(tenant, base)),
                        after=str(base * cfg.burn_quantum_boost),
                        predicted="tenant burn state recovers",
                        detail={"tenant": tenant, "burn_state": state},
                    )
                )
            elif not burning and boosted:
                self._boosted.discard(tenant)
                out.append(
                    Proposal(
                        rule=RULE_DRR_QUANTUM,
                        knob=f"quantum[{tenant}]",
                        before=str(quanta.get(tenant, base)),
                        after=str(base),
                        predicted="tenant burn state stays ok",
                        detail={"tenant": tenant, "burn_state": state},
                    )
                )
        return out

    # ── (3) scrub/sanitizer cadence ──────────────────────────────────

    def _cadence_rules(self, cfg, prev, cur) -> list[Proposal]:
        if cur.sanitize_every <= 0:
            return []
        viol_delta = cur.integrity_violations - prev.integrity_violations
        if viol_delta > 0:
            self.clean_windows = 0
            tightened = max(cfg.sanitize_every_min, cur.sanitize_every // 2)
            if tightened == cur.sanitize_every:
                return []
            return [
                Proposal(
                    rule=RULE_INTEGRITY_CADENCE,
                    knob="sanitize_every",
                    before=str(cur.sanitize_every),
                    after=str(tightened),
                    predicted="violation rate falls",
                    detail={"violation_delta": viol_delta},
                )
            ]
        self.clean_windows += 1
        headroom_ok = (
            cur.floor_distance is None
            or cur.floor_distance <= cfg.headroom_floor
        )
        if (
            self.clean_windows >= cfg.relax_after_windows
            and headroom_ok
            and cur.sanitize_every < cfg.sanitize_every_max
        ):
            self.clean_windows = 0
            relaxed = min(cfg.sanitize_every_max, cur.sanitize_every * 2)
            return [
                Proposal(
                    rule=RULE_INTEGRITY_CADENCE,
                    knob="sanitize_every",
                    before=str(cur.sanitize_every),
                    after=str(relaxed),
                    predicted="violations stay zero",
                    detail={
                        "clean_windows": cfg.relax_after_windows,
                        "floor_distance": cur.floor_distance,
                    },
                )
            ]
        return []

    # ── (4) WAL-replay-cost checkpoints ──────────────────────────────

    def _checkpoint_rules(self, cfg, prev, cur) -> list[Proposal]:
        if cur.wal_backlog <= 0:
            return []
        est_s = cur.wal_backlog * cfg.wal_cost_per_record_s
        if est_s <= cfg.wal_replay_budget_s:
            return []
        return [
            Proposal(
                rule=RULE_CHECKPOINT_WAL,
                knob="checkpoint",
                before=f"backlog={cur.wal_backlog}",
                after="checkpoint",
                predicted="wal replay estimate resets",
                detail={
                    "wal_backlog": cur.wal_backlog,
                    "replay_estimate_s": round(est_s, 4),
                    "budget_s": cfg.wal_replay_budget_s,
                },
            )
        ]


__all__ = [
    "AutopilotConfig",
    "Proposal",
    "RuleEngine",
    "RULE_BUCKET_GROW",
    "RULE_BUCKET_SHRINK",
    "RULE_CHECKPOINT_WAL",
    "RULE_DRR_QUANTUM",
    "RULE_INTEGRITY_CADENCE",
]
