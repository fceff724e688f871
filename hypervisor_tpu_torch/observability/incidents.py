"""IncidentRecorder: the black-box flight recorder.

Subscribes to the SAME health fan-out every observability plane
bridges through (`HealthMonitor.add_listener` — the facade's one
health->bus bridge) and, when a trigger in the taxonomy fires,
captures ONE bounded, content-addressed bundle of everything an
operator needs for the postmortem: the history window around the
trigger (`observability.history.HistoryPlane`), the event-bus slice,
the stitched trace fragment for the causal trace id, the autopilot
decision-ledger slice, the WAL watermark + checkpoint id, and the
knob/SLO-state snapshot.

Identity discipline (the `DecisionLedger.digest_line` precedent —
identity vs rider): the incident id is sha256 over RULE-INPUT fields
only — class, trigger kind, capture seq, caller's-clock `now`, and
the trigger payload with its wall-clock advisory keys popped. The
context blocks (history window, bus slice, trace fragment, ledger
slice, checkpoint pointer) RIDE the bundle but stay OUT of the id, so
a same-seed drill replays to a bit-identical incident digest even
though measured walls inside the context differ. Per-class cooldown +
exact-digest dedup keep a flapping trigger from flooding the ring;
the ring is bounded and counts evictions loudly
(`hv_incidents_evicted_total` + an `incident.evicted` bus event).
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Callable, Mapping, Optional

from hypervisor_tpu_torch.observability.snapshot import canonical_blob, rule_digest

#: health-fan-out kind -> incident class. Kinds NOT in the taxonomy
#: never capture (including the recorder's own `incident_*` emissions
#: — the recursion guard is the taxonomy itself).
TRIGGER_TAXONOMY: dict[str, str] = {
    "degraded_enter": "resilience.degraded_entered",
    "slo_burn_critical": "slo.burn_rate_critical",
    "integrity_violation": "integrity.violation",
    "state_restored": "integrity.state_restored",
    "fleet_worker_suspected": "fleet.worker_suspected",
    "fleet_worker_dead": "fleet.worker_dead",
    "straggler": "watchdog.straggler",
    "scenario_uncontained": "adversarial.uncontained",
}

#: Trigger-payload keys excluded from the incident id: wall-clock
#: measurements and context pointers that differ across replays of the
#: same seeded trace. They still ride the bundle's `trigger` block.
ADVISORY_PAYLOAD_KEYS: tuple[str, ...] = (
    "at", "entered_at", "degraded_s", "wall_ms", "duration_us",
    "deadline_us", "scrape_wall_ms", "taken_at", "uptime_s",
    "compile_wall_ms", "trace_id",
)


@dataclasses.dataclass(frozen=True)
class IncidentConfig:
    """Retention/cooldown knobs, read from env PER CALL (HVA002 — the
    `LeaseConfig.from_env` pattern, never at import time)."""

    retained: int = 32          #: bundles held in the retention ring
    cooldown_s: float = 30.0    #: per-class minimum capture spacing
    window_before_s: float = 60.0   #: history window behind the trigger
    window_after_s: float = 5.0     #: ... and ahead (same-drain tail)
    bus_slice: int = 64         #: newest bus events bundled
    ledger_slice: int = 8       #: newest autopilot decisions bundled

    @classmethod
    def from_env(cls) -> "IncidentConfig":
        def _f(name: str, default: float, floor: float) -> float:
            try:
                return max(floor, float(os.environ.get(name, default)))
            except ValueError:
                return default

        return cls(
            retained=int(_f("HV_INCIDENT_RETAINED", cls.retained, 1)),
            cooldown_s=_f("HV_INCIDENT_COOLDOWN_S", cls.cooldown_s, 0.0),
            window_before_s=_f(
                "HV_INCIDENT_WINDOW_BEFORE_S", cls.window_before_s, 0.0
            ),
            window_after_s=_f(
                "HV_INCIDENT_WINDOW_AFTER_S", cls.window_after_s, 0.0
            ),
            bus_slice=int(_f("HV_INCIDENT_BUS_SLICE", cls.bus_slice, 1)),
            ledger_slice=int(
                _f("HV_INCIDENT_LEDGER_SLICE", cls.ledger_slice, 1)
            ),
        )


def incident_rule_payload(
    cls_name: str, kind: str, seq: int, now: float, trigger: Mapping
) -> dict:
    """The EXACT rule-input payload the incident id hashes — exposed
    so gate 6l and the replay tests can recompute ids from a recorded
    bundle and pin bit-identity."""
    clean = {
        k: v for k, v in dict(trigger).items()
        if k not in ADVISORY_PAYLOAD_KEYS
    }
    return {
        "class": cls_name,
        "kind": kind,
        "seq": int(seq),
        "now": round(float(now), 6),
        "trigger": clean,
    }


class IncidentRecorder:
    """Bounded black-box recorder over the health fan-out.

    `observe(kind, payload)` IS the listener signature
    (`health.add_listener(recorder.observe)`); everything else is
    reads. Context providers are registered callables — each plane
    wires its own slice (`register_provider`), so the recorder has no
    import-time coupling to any of them."""

    def __init__(
        self,
        history=None,
        metrics=None,
        clock: Optional[Callable[[], float]] = None,
        scope: str = "local",
    ) -> None:
        self.history = history
        self.metrics = metrics
        self.clock = clock
        self.scope = scope
        #: set post-construction to `health.emit_event` so captures and
        #: evictions bridge onto the event bus like every other plane.
        self.emit: Optional[Callable[[str, dict], None]] = None
        self._providers: dict[str, Callable[[dict], object]] = {}
        self._ring: collections.deque = collections.deque()
        self._by_id: dict[str, dict] = {}
        self._last_capture: dict[str, float] = {}
        self._seq = 0
        self.captured_total = 0
        self.suppressed_total = 0
        self.evicted_total = 0

    def register_provider(
        self, name: str, fn: Callable[[dict], object]
    ) -> None:
        """Attach one context block: `fn(trigger_payload)` -> block.
        A provider that raises contributes `{"error": ...}` instead of
        killing the capture."""
        self._providers[name] = fn

    # ── the listener ─────────────────────────────────────────────────

    def observe(self, kind: str, payload: dict) -> Optional[str]:
        """Health-fan-out entry point. Returns the incident id when a
        bundle captured, None when the kind is outside the taxonomy or
        cooldown/dedup suppressed it."""
        cls_name = TRIGGER_TAXONOMY.get(kind)
        if cls_name is None:
            return None
        cfg = IncidentConfig.from_env()
        trigger = dict(payload or {})
        now = trigger.get("now")
        if now is None:
            now = self.clock() if self.clock is not None else 0.0
        now = round(float(now), 6)
        last = self._last_capture.get(cls_name)
        if last is not None and 0.0 <= (now - last) < cfg.cooldown_s:
            self._suppress()
            return None
        self._seq += 1
        rule = incident_rule_payload(
            cls_name, kind, self._seq, now, trigger
        )
        incident_id = rule_digest(rule)
        if incident_id in self._by_id:
            self._seq -= 1
            self._suppress()
            return None
        bundle = {
            "id": incident_id,
            "scope": self.scope,
            "class": cls_name,
            "kind": kind,
            "seq": self._seq,
            "now": now,
            "rule": rule,
            "trigger": trigger,
            "context": self._capture_context(trigger, now, cfg),
        }
        bundle["bytes"] = len(canonical_blob(bundle).encode())
        self._ring.append(bundle)
        self._by_id[incident_id] = bundle
        self._last_capture[cls_name] = now
        self.captured_total += 1
        while len(self._ring) > cfg.retained:
            evicted = self._ring.popleft()
            self._by_id.pop(evicted["id"], None)
            self.evicted_total += 1
            if self.metrics is not None:
                from hypervisor_tpu_torch.observability import metrics as mp

                self.metrics.inc(mp.INCIDENTS_EVICTED)
            if self.emit is not None:
                self.emit(
                    "incident_evicted",
                    {"id": evicted["id"], "class": evicted["class"]},
                )
        if self.metrics is not None:
            from hypervisor_tpu_torch.observability import metrics as mp

            self.metrics.inc(mp.INCIDENTS_CAPTURED)
            self.metrics.gauge_set(mp.INCIDENTS_RETAINED, len(self._ring))
        if self.emit is not None:
            self.emit(
                "incident_captured",
                {
                    "id": incident_id,
                    "class": cls_name,
                    "kind": kind,
                    "seq": bundle["seq"],
                    "now": now,
                    "trace_id": trigger.get("trace_id"),
                    "bytes": bundle["bytes"],
                },
            )
        return incident_id

    def _suppress(self) -> None:
        self.suppressed_total += 1
        if self.metrics is not None:
            from hypervisor_tpu_torch.observability import metrics as mp

            self.metrics.inc(mp.INCIDENTS_SUPPRESSED)

    def _capture_context(
        self, trigger: dict, now: float, cfg: IncidentConfig
    ) -> dict:
        context: dict = {}
        if self.history is not None:
            try:
                context["history"] = self.history.window(
                    now, cfg.window_before_s, cfg.window_after_s
                )
            except Exception as exc:  # noqa: BLE001 — capture survives
                context["history"] = {"error": repr(exc)}
        for name, fn in self._providers.items():
            try:
                context[name] = fn(trigger)
            except Exception as exc:  # noqa: BLE001 — capture survives
                context[name] = {"error": repr(exc)}
        return context

    # ── reads ────────────────────────────────────────────────────────

    def index(self, limit: int = 0) -> list[dict]:
        """Newest-first bundle index (id + identity fields, no
        context — the `/debug/incidents` row shape)."""
        rows = [
            {
                "id": b["id"],
                "scope": b["scope"],
                "class": b["class"],
                "kind": b["kind"],
                "seq": b["seq"],
                "now": b["now"],
                "bytes": b["bytes"],
            }
            for b in reversed(self._ring)
        ]
        return rows[:limit] if limit > 0 else rows

    def get(self, incident_id: str) -> Optional[dict]:
        return self._by_id.get(incident_id)

    def replay_check(self, incident_id: str) -> bool:
        """Recompute the id from the recorded rule payload — the
        content-address verifying itself (gate 6l's cheap half)."""
        bundle = self._by_id.get(incident_id)
        if bundle is None:
            return False
        return rule_digest(bundle["rule"]) == incident_id

    def summary(self) -> dict:
        """The `/debug/incidents` payload + hv_top panel fodder."""
        return {
            "enabled": True,
            "scope": self.scope,
            "captured": self.captured_total,
            "suppressed": self.suppressed_total,
            "evicted": self.evicted_total,
            "retained": len(self._ring),
            "classes": sorted(
                {b["class"] for b in self._ring}
            ),
            "last": self.index(limit=8),
        }


__all__ = [
    "ADVISORY_PAYLOAD_KEYS",
    "IncidentConfig",
    "IncidentRecorder",
    "TRIGGER_TAXONOMY",
    "incident_rule_payload",
]
