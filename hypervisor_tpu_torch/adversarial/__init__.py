"""Adversarial governance plane: seeded attacks on the trust model.

PRs 4–5 hardened the runtime against a device that dies (`resilience`)
or lies (`integrity`); this package attacks the *governance model
itself* — sigma-trust admission, rings, the vouch/bond/slash liability
graph, saga compensation, and the API surface. Five adversary classes
(`adversaries`), each a seeded, replayable driver against a LIVE state:

  * ``sybil_flood``        — mass low-sigma joins at open-workload
                             rates (the admission-rate damper's reason
                             to exist)
  * ``collusion_ring``     — a clique pumps sigma_eff through mutual
                             bonds, then defects (escrow conservation
                             is the invariant under test)
  * ``slash_cascade``      — deep/diamond liability graphs probing the
                             cascade bound and settlement determinism
  * ``compensation_storm`` — mass concurrent saga failures forcing
                             reverse-order compensation under capacity
                             pressure (the Supervisor's backpressure)
  * ``byzantine_fuzz``     — malformed / contradictory / replayed API
                             calls against the service + transports

Every scenario is scored on **containment** (`scoring`): named
components in [0, 1] — did quarantine/rings/degraded-mode hold, did
honest sigma and admission survive, did escrow/audit invariants hold —
with the overall score their MINIMUM (a breach anywhere is a breach).
The runnable registry + bench/CI glue live in
`hypervisor_tpu_torch.testing.scenarios`.
"""

from hypervisor_tpu_torch.adversarial.scoring import (
    ContainmentReport,
    component,
    fraction,
)
from hypervisor_tpu_torch.adversarial.adversaries import (
    ADVERSARIES,
    byzantine_fuzz,
    collusion_ring,
    compensation_storm,
    slash_cascade,
    sybil_flood,
)

__all__ = [
    "ADVERSARIES",
    "ContainmentReport",
    "byzantine_fuzz",
    "collusion_ring",
    "compensation_storm",
    "component",
    "fraction",
    "slash_cascade",
    "sybil_flood",
]
