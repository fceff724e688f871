"""State integrity (`hypervisor_tpu.integrity`): detect, repair, or restore
silent corruption.

  * `invariants` — the sanitizer: one pass re-checking every invariant
    over the tables, rings and logs, per-row violation bitmasks and
    counts that ride the metrics drain, plus the deterministic repairs.
  * `scrubber` — the paced Merkle scrubber: budgeted strips re-hashing
    the DeltaLog chain against its recorded digests and committed heads.
  * `plane` — `IntegrityPlane`, wiring sampling into the dispatch sites,
    detection into the drain, and the escalation ladder (repair ->
    contain -> checkpoint restore) into the Supervisor.
"""

from hypervisor_tpu_torch.integrity.invariants import (
    CATALOG,
    ESCROW_CAP,
    IntegrityResult,
    check_invariants,
)
from hypervisor_tpu_torch.integrity.plane import (
    IntegrityError,
    IntegrityPlane,
    StateRestoredError,
)
from hypervisor_tpu_torch.integrity.scrubber import MerkleScrubber

__all__ = [
    "CATALOG",
    "ESCROW_CAP",
    "IntegrityError",
    "IntegrityPlane",
    "IntegrityResult",
    "MerkleScrubber",
    "StateRestoredError",
    "check_invariants",
]

