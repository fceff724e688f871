"""SLO burn-rate plane: per-class objectives watched continuously.

The serving front door (PR 10) states an SLO once per BENCH round and
learns whether it held a round later. This module watches it LIVE, the
way the SRE workbook prescribes: each request class has an objective
("fraction of requests served inside their deadline ≥ target"), the
shortfall consumes an error budget, and the *burn rate* — how many
times faster than sustainable the budget is being spent — is evaluated
over multiple windows so the plane can distinguish a blip from a trend:

  * **burn rate** = (bad fraction over a window) / (1 - target).
    Rate 1.0 spends exactly the budget over the SLO period; 14.4 spends
    a 30-day budget in 2 days — the classic page threshold.
  * **multi-window confirmation** — an alert fires only when BOTH a
    long window (the trend) and a short window (is it still happening
    *now*?) exceed the threshold, so a recovered burst cannot page an
    hour later. `critical` confirms fast(5 m) + slow(1 h) at
    `critical_burn` (default 14.4); `warning` confirms the same pair at
    `warning_burn` (default 6). The long window (6 h) reports budget
    consumption.
  * **virtual clock** — every timestamp flowing in is the caller's
    clock (the soak harness drives a virtual one), so a seeded soak
    replays to an IDENTICAL alert sequence (`alert_digest()` is the
    replay key — pinned by test and by verify_tier1 gate 6g). Nothing
    here reads wall clock.

Alerts fan out through a caller-supplied `emit(kind, payload)` hook —
the front door wires `HealthMonitor.emit_event`, so the facade bridges
them onto the event bus as the append-only EventTypes
`slo.{burn_rate_warning,burn_rate_critical,recovered}` and the
resilience `Supervisor` can flip degraded mode on a critical burn
BEFORE any queue hard-fills (the same listener set the watchdog uses).

Windows shrink gracefully: a window longer than the observed history
simply covers all of it, so second-scale soaks still evaluate (the
fraction is over whatever the window holds); `min_events` keeps a cold
class from alerting off three requests.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import deque
from typing import Callable, Optional

#: Alert severities in escalation order.
OK, WARNING, CRITICAL = "ok", "warning", "critical"

#: Backoff multipliers the front door applies to Retry-After hints per
#: class state: a burning class tells clients to back off harder.
BACKOFF_MULTIPLIER = {OK: 1.0, WARNING: 2.0, CRITICAL: 4.0}


@dataclasses.dataclass(frozen=True)
class SLOObjective:
    """One request class's objective: `target` fraction of requests
    good (served inside the class deadline, not shed by overload)."""

    queue: str
    target: float          # e.g. 0.99 -> 1% error budget
    deadline_s: float      # the per-class latency budget (ServingConfig)

    @property
    def error_budget(self) -> float:
        return max(1.0 - self.target, 1e-9)

    def to_dict(self) -> dict:
        return {
            "queue": self.queue,
            "target": self.target,
            "deadline_ms": round(self.deadline_s * 1e3, 3),
            "error_budget": round(self.error_budget, 6),
        }


@dataclasses.dataclass(frozen=True)
class BurnRateAlert:
    """One alert transition (virtual-clock stamped; the replay unit)."""

    severity: str          # warning | critical | recovered
    queue: str
    at: float              # virtual seconds (caller clock)
    burn_fast: float
    burn_slow: float
    burn_long: float
    budget_remaining: float
    events: int

    def to_dict(self) -> dict:
        return {
            "severity": self.severity,
            "queue": self.queue,
            "at": round(self.at, 6),
            "burn_fast": round(self.burn_fast, 4),
            "burn_slow": round(self.burn_slow, 4),
            "burn_long": round(self.burn_long, 4),
            "budget_remaining": round(self.budget_remaining, 4),
            "events": self.events,
        }

    def replay_key(self) -> str:
        """Deterministic string for `alert_digest` (rounded so float
        noise below observability never forks a replay)."""
        return (
            f"{self.severity}:{self.queue}:{self.at:.6f}:"
            f"{self.burn_fast:.4f}:{self.burn_slow:.4f}"
        )


class _ClassWindow:
    """Per-class event ring: (t, bad) pairs on the virtual clock."""

    __slots__ = ("events", "good_total", "bad_total", "state", "last_rates")

    def __init__(self, capacity: int) -> None:
        self.events: deque[tuple[float, bool]] = deque(maxlen=capacity)
        self.good_total = 0
        self.bad_total = 0
        self.state = OK
        self.last_rates = (0.0, 0.0, 0.0)

    def bad_fraction(self, now: float, window_s: float) -> float:
        lo = now - window_s
        n = bad = 0
        for t, is_bad in self.events:
            if t >= lo:
                n += 1
                bad += is_bad
        return bad / n if n else 0.0


class SLOEngine:
    """Per-class burn-rate evaluation over one front door's traffic.

    `note(queue, t, good)` books one outcome (served-in-deadline,
    deadline miss, or overload shed); `evaluate(now)` runs the window
    math and emits alert transitions. Both take the CALLER's clock —
    virtual in soaks, wall-anchored in live serving — and the engine
    never reads time itself (replay determinism).
    """

    def __init__(
        self,
        objectives: dict[str, SLOObjective],
        *,
        fast_window_s: float = 300.0,
        slow_window_s: float = 3600.0,
        long_window_s: float = 21600.0,
        critical_burn: float = 14.4,
        warning_burn: float = 6.0,
        min_events: int = 24,
        window_capacity: int = 4096,
        metrics=None,
        emit: Optional[Callable[[str, dict], None]] = None,
        max_alerts: int = 256,
    ) -> None:
        self.objectives = dict(objectives)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.long_window_s = float(long_window_s)
        self.critical_burn = float(critical_burn)
        self.warning_burn = float(warning_burn)
        self.min_events = int(min_events)
        self.metrics = metrics
        self.emit = emit
        # Reentrant: summary()/evaluate() compose the smaller locked
        # readers, and a non-reentrant lock would deadlock on refactor.
        self._lock = threading.RLock()
        self._classes = {
            q: _ClassWindow(window_capacity) for q in self.objectives
        }
        self.alerts: deque[BurnRateAlert] = deque(maxlen=max_alerts)
        self.alert_counts = {WARNING: 0, CRITICAL: 0, "recovered": 0}
        self._digest = hashlib.sha256()

    # ── ingest ───────────────────────────────────────────────────────

    def note(self, queue: str, t: float, good: bool) -> None:
        cw = self._classes.get(queue)
        if cw is None:
            return
        with self._lock:
            cw.events.append((float(t), not good))
            if good:
                cw.good_total += 1
            else:
                cw.bad_total += 1
        if self.metrics is not None:
            from hypervisor_tpu_torch.observability import metrics as mp

            handle = (mp.SLO_GOOD if good else mp.SLO_BAD).get(queue)
            if handle is not None:
                self.metrics.inc(handle)

    # ── window math ──────────────────────────────────────────────────

    def burn_rates(self, queue: str, now: float) -> tuple[float, float, float]:
        """(fast, slow, long) burn rates at `now` (virtual clock)."""
        cw = self._classes[queue]
        budget = self.objectives[queue].error_budget
        with self._lock:
            fast = cw.bad_fraction(now, self.fast_window_s) / budget
            slow = cw.bad_fraction(now, self.slow_window_s) / budget
            long_ = cw.bad_fraction(now, self.long_window_s) / budget
        return fast, slow, long_

    def budget_remaining(self, queue: str, now: float) -> float:
        """Fraction of the error budget left over the long window
        (1.0 = untouched, 0.0 = spent, negative = overspent)."""
        cw = self._classes[queue]
        budget = self.objectives[queue].error_budget
        with self._lock:
            bad = cw.bad_fraction(now, self.long_window_s)
        return round(1.0 - bad / budget, 6)

    # ── evaluation + alerting ────────────────────────────────────────

    def evaluate(self, now: float) -> list[BurnRateAlert]:
        """One evaluation pass; returns the alert TRANSITIONS fired
        (state changes only — a burning class does not re-alert every
        tick). Deterministic in (traffic, now) — no wall clock."""
        fired: list[BurnRateAlert] = []
        for queue, cw in self._classes.items():
            fast, slow, long_ = self.burn_rates(queue, now)
            with self._lock:
                cw.last_rates = (fast, slow, long_)
                n_events = cw.good_total + cw.bad_total
                prev = cw.state
                if n_events < self.min_events:
                    new = prev  # cold class: never alert, never recover
                elif fast >= self.critical_burn and slow >= self.critical_burn:
                    new = CRITICAL
                elif fast >= self.warning_burn and slow >= self.warning_burn:
                    # A critical class stays critical until BOTH windows
                    # fall below the warning threshold (hysteresis).
                    new = CRITICAL if prev == CRITICAL else WARNING
                elif fast < self.warning_burn and slow < self.warning_burn:
                    new = OK
                else:
                    new = prev  # between thresholds: hold
                transition = new != prev
                cw.state = new
            if self.metrics is not None:
                from hypervisor_tpu_torch.observability import metrics as mp

                for window, rate in (
                    ("fast", fast), ("slow", slow), ("long", long_),
                ):
                    handle = mp.SLO_BURN_RATE.get((queue, window))
                    if handle is not None:
                        self.metrics.gauge_set(handle, rate)
            if not transition:
                continue
            severity = "recovered" if new == OK else new
            alert = BurnRateAlert(
                severity=severity,
                queue=queue,
                at=now,
                burn_fast=fast,
                burn_slow=slow,
                burn_long=long_,
                budget_remaining=self.budget_remaining(queue, now),
                events=n_events,
            )
            with self._lock:
                self.alerts.append(alert)
                self.alert_counts[severity] = (
                    self.alert_counts.get(severity, 0) + 1
                )
                self._digest.update(alert.replay_key().encode())
            if self.metrics is not None:
                from hypervisor_tpu_torch.observability import metrics as mp

                handle = mp.SLO_ALERTS.get(severity)
                if handle is not None:
                    self.metrics.inc(handle)
            if self.emit is not None:
                kind = {
                    WARNING: "slo_burn_warning",
                    CRITICAL: "slo_burn_critical",
                    "recovered": "slo_recovered",
                }[severity]
                self.emit(kind, alert.to_dict())
            fired.append(alert)
        return fired

    # ── views ────────────────────────────────────────────────────────

    def state_of(self, queue: str) -> str:
        cw = self._classes.get(queue)
        return cw.state if cw is not None else OK

    def backoff_multiplier(self, queue: str) -> float:
        """Retry-After scale for the class's current burn state — the
        front door folds this into its dynamic Retry-After hint so a
        burning class tells clients to back off harder."""
        return BACKOFF_MULTIPLIER.get(self.state_of(queue), 1.0)

    def alert_digest(self) -> str:
        """sha256 over every alert transition so far — the replay key
        (same trace + seed => same digest, gate 6g)."""
        with self._lock:
            return self._digest.hexdigest()

    def recent_alerts(self, limit: int = 16) -> list[dict]:
        with self._lock:
            return [a.to_dict() for a in list(self.alerts)[-limit:]]

    def summary(self) -> dict:
        """Per-class burn state (`/debug/slo`; no device work)."""
        out: dict[str, dict] = {}
        with self._lock:
            for queue, cw in self._classes.items():
                fast, slow, long_ = cw.last_rates
                out[queue] = {
                    "state": cw.state,
                    "good": cw.good_total,
                    "bad": cw.bad_total,
                    "burn_fast": round(fast, 4),
                    "burn_slow": round(slow, 4),
                    "burn_long": round(long_, 4),
                    "objective": self.objectives[queue].to_dict(),
                }
        return {
            "classes": out,
            "thresholds": {
                "critical_burn": self.critical_burn,
                "warning_burn": self.warning_burn,
                "min_events": self.min_events,
                "windows_s": {
                    "fast": self.fast_window_s,
                    "slow": self.slow_window_s,
                    "long": self.long_window_s,
                },
            },
            "alerts": dict(self.alert_counts),
            "alert_digest": self.alert_digest(),
        }


def objectives_from_serving_config(config) -> dict[str, SLOObjective]:
    """Per-class objectives from a `serving.ServingConfig`: the class
    deadline is the latency budget, `slo_target` the good fraction."""
    from hypervisor_tpu_torch.observability import metrics as mp

    target = getattr(config, "slo_target", 0.99)
    return {
        q: SLOObjective(
            queue=q, target=float(target), deadline_s=config.deadline_for(q)
        )
        for q in mp.SERVING_QUEUES
    }


__all__ = [
    "BACKOFF_MULTIPLIER",
    "BurnRateAlert",
    "SLOEngine",
    "SLOObjective",
    "objectives_from_serving_config",
]
