"""Containment scoring for adversarial scenarios.

One rubric for every adversary class (docs/OPERATIONS.md "Adversarial
drills"): a scenario reports named **components**, each a float in
[0, 1] answering one containment question —

    1.0   the defense held completely
    0.0   the attack fully achieved its goal on this axis

and the scenario's **score is the MINIMUM component**: containment is
a conjunction (an attack that breaks escrow conservation is not
"mostly contained" because honest latency stayed flat). Components are
deliberately coarse-grained fractions (admitted/attempted, clipped/
members, drained/backlog) so the same seed always reproduces the same
score bit-for-bit — no wall-clock, no sampling.

`ContainmentReport` also carries the seeded attack TRACE: an ordered
list of JSON-serializable events (no uuids, no timestamps — symbolic
labels only) whose sha256 is the replay key. Two runs with one seed
must produce identical digests; the property tests and the
`verify_tier1.sh` smoke gate pin exactly that.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field


def component(value: float) -> float:
    """Clamp one containment component into [0, 1]."""
    return max(0.0, min(1.0, float(value)))


def fraction(num: float, den: float, *, empty: float = 1.0) -> float:
    """num/den as a containment component; `empty` when den == 0
    (an attack axis that never fired did not breach)."""
    return component(num / den) if den else empty


@dataclass
class ContainmentReport:
    """What one scenario run measured."""

    name: str
    seed: int
    hardened: bool
    components: dict[str, float] = field(default_factory=dict)
    trace: list = field(default_factory=list)
    attack_events: int = 0
    details: dict = field(default_factory=dict)

    def record(self, *event) -> None:
        """Append one trace event (must be JSON-serializable and
        deterministic under the seed)."""
        self.trace.append(list(event))

    def attack(self, *event) -> None:
        """A trace event that is also one adversary action."""
        self.attack_events += 1
        self.record(*event)

    def set(self, component_name: str, value: float) -> None:
        self.components[component_name] = round(component(value), 4)

    @property
    def score(self) -> float:
        """Overall containment: the minimum component (conjunction)."""
        if not self.components:
            return 0.0
        return min(self.components.values())

    @property
    def trace_digest(self) -> str:
        payload = json.dumps(
            {"name": self.name, "seed": self.seed,
             "hardened": self.hardened, "trace": self.trace},
            sort_keys=True, separators=(",", ":"),
        )
        return hashlib.sha256(payload.encode()).hexdigest()

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "seed": self.seed,
            "hardened": self.hardened,
            "score": round(self.score, 4),
            "components": dict(self.components),
            "attack_events": self.attack_events,
            "trace_digest": self.trace_digest,
            "details": self.details,
        }


__all__ = ["ContainmentReport", "component", "fraction"]
