"""The action gateway's result type.

`Hypervisor.check_action` composes every per-action gate the reference
ships but never wires together (quarantine isolation, sudo-aware ring
enforcement, per-ring rate limiting, breach-window recording) into one
ordered pipeline; this dataclass is its verdict.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from hypervisor_tpu_torch.models import ExecutionRing


@dataclass
class ActionCheckResult:
    """One action's way through the gates.

    `breach_event` is set when THIS call's recording pushed the agent's
    window over an anomaly threshold (possibly tripping the circuit
    breaker) — it can accompany an allowed call: the grant stands, the
    anomaly is reported.
    """

    allowed: bool
    reason: str
    effective_ring: ExecutionRing
    required_ring: ExecutionRing
    quarantined: bool = False
    rate_limited: bool = False
    breaker_tripped: bool = False
    ring_check: Optional[Any] = None     # rings.RingCheckResult
    breach_event: Optional[Any] = None   # rings.breach_detector.BreachEvent
