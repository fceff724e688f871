"""Seeded attack-scenario harness: the governance model under fire.

The runnable registry over `hypervisor_tpu_torch.adversarial` — the
`--chaos` / `--corrupt` pattern applied to the GOVERNANCE layer
instead of the fault layer. Five adversary classes, each seeded and
replayable (same seed -> same attack trace -> same containment score):

    from hypervisor_tpu_torch.testing import scenarios
    result = scenarios.run_scenario("sybil_flood", seed=7)
    result.score           # min containment component, [0, 1]
    result.trace_digest    # sha256 replay key
    scenarios.run_all(seed=7)

Each scenario is scored on **containment** (`adversarial.scoring`):
did quarantine / rings / degraded mode hold, did honest admission and
sigma survive, did escrow/audit invariants hold. `hardened=False`
disables the defense mechanism under test (admission damper, collusion
detector, cascade dedupe, compensation backpressure) so the
before/after delta is measurable — the property tests pin that every
hardened score strictly dominates its legacy twin.

Every entry point takes `device=` (the card by default; `"cpu"` runs
the plain PyTorch path). A scenario's result, digest included, is the
same on both, and equal to the JAX package's at the same seed.
`chip_smoke.py` runs the whole set on the card against its CPU run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from hypervisor_tpu_torch.adversarial import ADVERSARIES
from hypervisor_tpu_torch.adversarial.scoring import ContainmentReport

#: Scenario names in canonical (registry) order.
SCENARIO_NAMES: tuple[str, ...] = tuple(ADVERSARIES)

#: Containment floor a hardened run must clear (the regression gate's
#: default; `HV_SCENARIO_FLOOR` overrides at the gate).
DEFAULT_CONTAINMENT_FLOOR = 0.8


@dataclass(frozen=True)
class ScenarioResult:
    """One scenario run, frozen for reporting."""

    name: str
    seed: int
    hardened: bool
    score: float
    components: dict
    attack_events: int
    trace_digest: str
    details: dict

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "seed": self.seed,
            "hardened": self.hardened,
            "score": self.score,
            "components": dict(self.components),
            "attack_events": self.attack_events,
            "trace_digest": self.trace_digest,
            "details": self.details,
        }


def _freeze(report: ContainmentReport) -> ScenarioResult:
    return ScenarioResult(
        name=report.name,
        seed=report.seed,
        hardened=report.hardened,
        score=round(report.score, 4),
        components=dict(report.components),
        attack_events=report.attack_events,
        trace_digest=report.trace_digest,
        details=report.details,
    )


def run_scenario(
    name: str,
    seed: int,
    *,
    hardened: bool = True,
    quick: bool = True,
    metrics=None,
    event_bus=None,
    device="cuda",
) -> ScenarioResult:
    """Run one adversary class against a fresh deployment on `device`
    (the card unless the caller asks for the CPU).

    `metrics` (an `observability.metrics.Metrics`) mirrors the run into
    the `hv_scenario_*` series of a live deployment's plane;
    `event_bus` brackets it with `adversarial.scenario_started` /
    `adversarial.scenario_scored` events. Both optional — a bare run
    is fully described by the returned ScenarioResult.
    """
    try:
        adversary = ADVERSARIES[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; one of {sorted(ADVERSARIES)}"
        ) from None
    if event_bus is not None:
        from hypervisor_tpu_torch.observability import EventType, HypervisorEvent

        event_bus.emit(HypervisorEvent(
            event_type=EventType.SCENARIO_STARTED,
            payload={"scenario": name, "seed": seed, "hardened": hardened},
        ))
    report = adversary(seed, hardened=hardened, quick=quick, device=device)
    result = _freeze(report)
    if metrics is not None:
        from hypervisor_tpu_torch.observability import metrics as metrics_plane

        metrics.inc(metrics_plane.SCENARIO_RUNS)
        metrics.inc(
            metrics_plane.SCENARIO_ATTACK_EVENTS, result.attack_events
        )
        metrics.gauge_set(
            metrics_plane.SCENARIO_CONTAINMENT, result.score
        )
        if result.score < DEFAULT_CONTAINMENT_FLOOR:
            metrics.inc(metrics_plane.SCENARIO_UNCONTAINED)
    if event_bus is not None:
        event_bus.emit(HypervisorEvent(
            event_type=EventType.SCENARIO_SCORED,
            payload=result.to_dict(),
        ))
    return result


def run_all(
    seed: int,
    *,
    hardened: bool = True,
    quick: bool = True,
    names: Optional[tuple[str, ...]] = None,
    metrics=None,
    event_bus=None,
    device="cuda",
) -> dict[str, ScenarioResult]:
    """Run every scenario (registry order) under one seed on `device`."""
    return {
        name: run_scenario(
            name, seed, hardened=hardened, quick=quick,
            metrics=metrics, event_bus=event_bus, device=device,
        )
        for name in (names or SCENARIO_NAMES)
    }


def aggregate(results: dict[str, ScenarioResult]) -> dict:
    """One summary row over a `run_all` output: per-scenario scores
    plus the floor statistic the regression gate judges."""
    scores = {name: r.score for name, r in results.items()}
    return {
        "scores": scores,
        "min_score": min(scores.values()) if scores else 0.0,
        "attack_events": sum(r.attack_events for r in results.values()),
        "trace_digests": {
            name: r.trace_digest for name, r in results.items()
        },
    }


__all__ = [
    "DEFAULT_CONTAINMENT_FLOOR",
    "SCENARIO_NAMES",
    "ScenarioResult",
    "aggregate",
    "run_all",
    "run_scenario",
]
