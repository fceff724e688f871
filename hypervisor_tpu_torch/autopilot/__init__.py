"""Autopilot observatory: a deterministic, replayable decision plane
that tunes the runtime from its own drained signals.

Layers (each importable alone; the plane composes them):

  * `signals`  — `SignalSnapshot`: the frozen, digestable drained-state
                 view every decision is a pure function of.
  * `rules`    — `RuleEngine`: the four deterministic rule families
                 (bucket grow/shrink, per-tenant DRR quanta, scrub/
                 sanitizer cadence, WAL-cost checkpoints).
  * `ledger`   — `DecisionLedger`: append-only decisions with input-
                 signal digests, knob deltas, outcome attributions, and
                 the replayable decisions digest.
  * `plane`    — `Autopilot`: attaches to a `HypervisorState`, applies
                 proposals (pre-warm first), emits `autopilot.*` events
                 and `hv_autopilot_*` metrics, serves `/debug/autopilot`.
  * `soak`     — the shifting-workload-mix soak: static config vs the
                 autopilot on the SAME seeded trace, double-replayed for
                 the digest-identity pin (bench row `autopilot_soak`,
                 verify gate 6j).

Kill switch: `HV_AUTOPILOT=0` (per-call read; docs/OPERATIONS.md
"Autopilot").
"""

from hypervisor_tpu_torch.autopilot.ledger import Decision, DecisionLedger
from hypervisor_tpu_torch.autopilot.plane import Autopilot, autopilot_enabled
from hypervisor_tpu_torch.autopilot.rules import (
    AutopilotConfig,
    Proposal,
    RuleEngine,
)
from hypervisor_tpu_torch.autopilot.signals import SignalSnapshot, drain_signals

__all__ = [
    "Autopilot",
    "AutopilotConfig",
    "Decision",
    "DecisionLedger",
    "Proposal",
    "RuleEngine",
    "SignalSnapshot",
    "autopilot_enabled",
    "drain_signals",
]
