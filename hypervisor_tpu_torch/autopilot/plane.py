"""The autopilot plane: drained signals -> rules -> applied knob deltas.

`Autopilot` attaches to one `HypervisorState` (like the integrity and
resilience planes: `state.autopilot = self`) over a serving
`WaveScheduler`, and optionally a tenant scheduler, an integrity plane,
and a supervisor. `step(now)` runs at the host tick cadence and is a
no-op until one decision window (`HV_AUTOPILOT_EVERY_S` virtual
seconds) has elapsed; each window it

  1. drains one `SignalSnapshot` (host counters only — no device work),
  2. attributes outcomes to decisions from earlier windows,
  3. folds the snapshot through the pure `RuleEngine`,
  4. APPLIES each proposal — growing a bucket pre-warms the new tile
     FIRST (off the hot path, bracketed by compile-telemetry reads so
     the planned compiles are ledger-accounted and the zero-UNPLANNED-
     recompile contract stays checkable), then reconfigures the front
     door under its lock,
  5. appends each decision to the ledger, bumps `hv_autopilot_*`
     metrics, and fans an `autopilot_decision` health event out to the
     facade bridge (-> `autopilot.decision` on the event bus, joined to
     the trace plane by the decision's deterministic CausalTraceId).

Kill switch: `HV_AUTOPILOT=0` (read PER CALL — hvlint HVA002) makes
`step` a no-op; already-applied knob deltas stay (the switch stops the
controller, it does not roll the runtime back).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

from hypervisor_tpu_torch.autopilot.ledger import Decision, DecisionLedger
from hypervisor_tpu_torch.autopilot.rules import (
    RULE_BUCKET_GROW,
    RULE_BUCKET_SHRINK,
    RULE_CHECKPOINT_WAL,
    RULE_DRR_QUANTUM,
    RULE_INTEGRITY_CADENCE,
    AutopilotConfig,
    Proposal,
    RuleEngine,
)
from hypervisor_tpu_torch.autopilot.signals import SignalSnapshot, drain_signals
from hypervisor_tpu_torch.observability import metrics as metrics_plane

_BURN_RANK = {"ok": 0, "warning": 1, "critical": 2}

#: Queue-depth cap the grow rule's depth doubling saturates at.
_DEPTH_CAP = 4096


def autopilot_enabled() -> bool:
    """The kill switch, read per call (HVA002)."""
    return os.environ.get("HV_AUTOPILOT", "1") != "0"


class Autopilot:
    """Host-side control plane over one serving stack."""

    def __init__(
        self,
        state,
        scheduler=None,
        config: Optional[AutopilotConfig] = None,
        tenant_scheduler=None,
        supervisor=None,
        headroom_fn: Optional[Callable[[], Optional[float]]] = None,
    ) -> None:
        self.state = state
        self.sched = scheduler
        self.front = scheduler.front_door if scheduler is not None else None
        self.tenant_sched = tenant_scheduler
        self.supervisor = supervisor
        self.config = config or AutopilotConfig()
        self.engine = RuleEngine(self.config)
        self.ledger = DecisionLedger()
        self.headroom_fn = headroom_fn
        #: Static defaults at attach time — hv_top renders live knob
        #: values against these.
        self.static_knobs = self._knob_values()
        #: Planned pre-warm compile accounting (the grow rule's ledger-
        #: bracketed compiles; soaks subtract these from the raw post-
        #: warm telemetry to compute UNPLANNED recompiles).
        self.prewarm = {"events": 0, "compiles": 0, "recompiles": 0}
        self._last_decide: Optional[float] = None
        self._seq = 0
        #: Snapshot each pending decision was made against, by decision
        #: seq — outcome attribution diffs the next window against it.
        self._decided_on: dict[int, SignalSnapshot] = {}
        state.autopilot = self

    # ── knob inventory (summary + static diff) ───────────────────────

    def _knob_values(self) -> dict:
        knobs: dict = {}
        if self.front is not None:
            knobs["buckets"] = list(self.front.config.buckets)
            knobs["queue_depths"] = dict(self.front._depths)
        if self.tenant_sched is not None:
            knobs["quantum"] = [
                self.tenant_sched.quantum_of(t)
                for t in range(self.tenant_sched.arena.num_tenants)
            ]
        plane = self.state.integrity
        if plane is not None:
            knobs["sanitize_every"] = plane.every
            knobs["scrub_every"] = plane.scrub_every
        return knobs

    # ── the decision window ──────────────────────────────────────────

    def step(self, now: float) -> list[Decision]:
        """One control pass on the virtual/host clock. Returns the
        decisions applied this window ([] when the window has not
        elapsed or `HV_AUTOPILOT=0`)."""
        if not autopilot_enabled():
            return []
        now = float(now)
        if (
            self._last_decide is not None
            and now - self._last_decide < self.config.decide_every_s
        ):
            return []
        self._last_decide = now
        snap = self._drain(now)
        self._attribute(snap)
        applied: list[Decision] = []
        for proposal in self.engine.step(snap):
            d = self._apply(proposal, snap, now)
            if d is not None:
                applied.append(d)
        return applied

    def _drain(self, now: float) -> SignalSnapshot:
        seq, self._seq = self._seq, self._seq + 1
        floor = self.headroom_fn() if self.headroom_fn is not None else None
        snap = drain_signals(
            seq=seq,
            now=now,
            front=self.front,
            tenant_sched=self.tenant_sched,
            integrity=self.state.integrity,
            supervisor=self.supervisor,
            journal=self.state.journal,
            floor_distance=floor,
        )
        return snap

    # ── applying proposals (every side effect lives here) ────────────

    def _apply(
        self, p: Proposal, snap: SignalSnapshot, now: float
    ) -> Optional[Decision]:
        detail = dict(p.detail)
        if p.rule == RULE_BUCKET_GROW:
            detail.update(self._grow_bucket(p, now))
        elif p.rule == RULE_BUCKET_SHRINK:
            self._shrink_bucket(p)
        elif p.rule == RULE_DRR_QUANTUM:
            if self.tenant_sched is None:
                return None
            self.tenant_sched.set_quantum(
                int(detail["tenant"]), float(p.after)
            )
        elif p.rule == RULE_INTEGRITY_CADENCE:
            plane = self.state.integrity
            if plane is None:
                return None
            plane.retune(every=int(p.after))
        elif p.rule == RULE_CHECKPOINT_WAL:
            if self.supervisor is None:
                return None
            try:
                ckpt = self.supervisor.checkpoint(background=True)
                detail["checkpoint"] = str(ckpt)
            except Exception as e:  # checkpointing must not kill control
                detail["checkpoint_error"] = repr(e)
        d = self.ledger.record(
            now=now,
            rule=p.rule,
            knob=p.knob,
            before=p.before,
            after=p.after,
            predicted=p.predicted,
            signal_digest=snap.digest(),
            detail=detail,
        )
        self._decided_on[d.seq] = snap
        m = self.state.metrics
        m.inc(metrics_plane.AUTOPILOT_DECISIONS)
        if self.front is not None:
            m.gauge_set(
                metrics_plane.AUTOPILOT_MAX_BUCKET,
                max(self.front.config.buckets),
            )
        if self.state.integrity is not None:
            m.gauge_set(
                metrics_plane.AUTOPILOT_SANITIZE_EVERY,
                self.state.integrity.every,
            )
        self.state.health.emit_event(
            "autopilot_decision",
            {**d.to_dict(), "trace_id": d.trace_id},
        )
        return d

    def _grow_bucket(self, p: Proposal, now: float) -> dict:
        """Pre-warm the grown tile, then widen the closed set + depths.

        Order matters for the zero-recompile contract: the new
        (program, bucket) pairs compile HERE, bracketed by compile-
        telemetry reads, BEFORE any ticket can be scheduled at the new
        shape — so the hot path never sees a cold tile and every compile
        this causes is ledger-accounted as planned.
        """
        from hypervisor_tpu_torch.observability import health as health_plane

        new_bucket = int(p.detail["new_bucket"])
        before = health_plane.compile_summary(last=0)
        self.sched.warm_bucket(new_bucket, now=now)
        after = health_plane.compile_summary(last=0)
        planned = {
            "prewarm_compiles": after["compiles"] - before["compiles"],
            "prewarm_recompiles": after["recompiles"] - before["recompiles"],
        }
        self.prewarm["events"] += 1
        self.prewarm["compiles"] += planned["prewarm_compiles"]
        self.prewarm["recompiles"] += planned["prewarm_recompiles"]
        self.state.metrics.inc(
            metrics_plane.AUTOPILOT_PREWARM_COMPILES,
            planned["prewarm_compiles"] + planned["prewarm_recompiles"],
        )
        cfg = self.front.config
        factor = int(p.detail.get("depth_factor", 2))
        grown = tuple(sorted(set(cfg.buckets) | {new_bucket}))
        self.front.reconfigure(
            dataclasses.replace(
                cfg,
                buckets=grown,
                action_queue_depth=min(
                    _DEPTH_CAP, cfg.action_queue_depth * factor
                ),
                lifecycle_queue_depth=min(
                    _DEPTH_CAP, cfg.lifecycle_queue_depth * factor
                ),
                terminate_queue_depth=min(
                    _DEPTH_CAP, cfg.terminate_queue_depth * factor
                ),
                saga_queue_depth=min(
                    _DEPTH_CAP, cfg.saga_queue_depth * factor
                ),
            )
        )
        return planned

    def _shrink_bucket(self, p: Proposal) -> None:
        cfg = self.front.config
        shrunk = tuple(sorted(cfg.buckets))[:-1]
        if not shrunk:
            return
        # Policy-only: the jit cache keeps the dropped bucket's compiled
        # tiles, so re-growing later is a cache hit, not a recompile.
        self.front.reconfigure(dataclasses.replace(cfg, buckets=shrunk))

    # ── post-hoc outcome attribution ─────────────────────────────────

    def _attribute(self, cur: SignalSnapshot) -> None:
        """Score every pending decision against the newly drained
        window: did the signal move the way the rule predicted? The
        attribution is observability (ledger + `autopilot.outcome`
        event), never a rollback — and it stays OUT of the digest."""
        for d in self.ledger.pending():
            at = self._decided_on.get(d.seq)
            if at is None or cur.seq <= at.seq:
                continue
            ok, observed = self._score(d, at, cur)
            self.ledger.attribute(d, ok, observed)
            self._decided_on.pop(d.seq, None)
            m = self.state.metrics
            m.inc(
                metrics_plane.AUTOPILOT_OUTCOMES_CONFIRMED
                if ok
                else metrics_plane.AUTOPILOT_OUTCOMES_REFUTED
            )
            self.state.health.emit_event(
                "autopilot_outcome",
                {
                    "seq": d.seq,
                    "rule": d.rule,
                    "knob": d.knob,
                    "ok": ok,
                    "observed": observed,
                    "trace_id": d.trace_id,
                },
            )

    def _score(
        self, d: Decision, at: SignalSnapshot, cur: SignalSnapshot
    ) -> tuple[bool, dict]:
        if d.rule == RULE_BUCKET_GROW:
            before_delta = int(d.detail.get("shed_delta", 0))
            new_delta = cur.shed_of("queue_full") - at.shed_of("queue_full")
            return (
                new_delta == 0 or new_delta < before_delta,
                {"queue_full_shed_delta": new_delta,
                 "was": before_delta},
            )
        if d.rule == RULE_BUCKET_SHRINK:
            new_delta = cur.shed_of("queue_full") - at.shed_of("queue_full")
            return new_delta == 0, {"queue_full_shed_delta": new_delta}
        if d.rule == RULE_DRR_QUANTUM:
            tenant = int(d.detail["tenant"])
            was = d.detail.get("burn_state", "ok")
            state = dict(cur.tenant_burn).get(tenant, "ok")
            return (
                _BURN_RANK.get(state, 0) <= _BURN_RANK.get(was, 0),
                {"burn_state": state, "was": was},
            )
        if d.rule == RULE_INTEGRITY_CADENCE:
            delta = cur.integrity_violations - at.integrity_violations
            return delta == 0, {"violation_delta": delta}
        if d.rule == RULE_CHECKPOINT_WAL:
            return (
                cur.wal_backlog < int(d.detail.get("wal_backlog", 0)),
                {"wal_backlog": cur.wal_backlog},
            )
        return True, {}

    # ── the /debug/autopilot payload ─────────────────────────────────

    def summary(self, last: int = 8) -> dict:
        return {
            "enabled": autopilot_enabled(),
            "decide_every_s": self.config.decide_every_s,
            "windows": self._seq,
            "knobs": {
                "now": self._knob_values(),
                "static": self.static_knobs,
            },
            "prewarm": dict(self.prewarm),
            **self.ledger.summary(last=last),
        }


__all__ = ["Autopilot", "autopilot_enabled"]
