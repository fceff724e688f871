"""Fleet observatory: merged cross-process drains, stitched traces,
a deterministic liveness plane, and durable reassignment.

Every plane below the fleet — metrics, TraceLog, SLO burn, roofline,
autopilot ledger — is host-singular. The fleet adds:

* `worker` — N worker subprocesses, each the EXISTING API server +
  `TenantArena` behind a `WorkerSpec` (tenant set / port / env / torch
  device pinned); the workers serve the existing routes unchanged.
* `registry` — the seeded, digest-replayable heartbeat/lease plane:
  leases evaluated on the caller's clock (the SLO-engine discipline),
  expiry flips alive -> suspected -> dead with hysteresis, transitions
  ride the health fan-out as `fleet.*` bus events.
* `drain` — ONE merged exposition scraping every worker's `/metrics`
  + `/debug/{health,slo,roofline,tenants,autopilot}`, stamping
  `worker="<id>"` on EVERY series (the tenant-label merge is the
  template) and folding fleet rollups into a frozen `FleetSnapshot`
  whose `digest()` covers exactly the rule-input fields.
* `trace` — cross-process trace stitching: per-worker Chrome/OTLP
  fragments for one `CausalTraceId` merged into one timeline with
  worker lanes.
* `failover` — the REASSIGN half: per-worker durable ownership
  namespaces (`WorkerDurability`, fenced WAL + watermarked per-tenant
  checkpoints under `<root>/<worker>/epoch_<E>/tenant_<t>`), the
  journaled `OwnershipMap`, and the `FailoverController` that recovers
  a convicted-dead worker's tenants from durable state onto a
  survivor's torch device, splices them into its arena with no novel
  signature, and fences the zombie at the bumped epoch.
* `rebalance` — PLANNED zero-loss migration on the same splice path:
  seven durable protocol steps (journaled intent, sealed + drained
  source, final checkpoint at the WAL tip, per-tenant fence,
  destination adoption, atomic commit), a deterministic deficit-aware
  placement policy, and failover-wins race resolution — a crash at any
  boundary degrades into the proven failover recovery.
"""

from hypervisor_tpu_torch.fleet.drain import (
    FleetObservatory,
    FleetSnapshot,
    WorkerClient,
    merge_expositions,
    sample_series_count,
    worker_label_coverage,
)
from hypervisor_tpu_torch.fleet.registry import (
    ALIVE,
    DEAD,
    SUSPECTED,
    FleetRegistry,
    LeaseConfig,
    LeaseTransition,
)
from hypervisor_tpu_torch.fleet.failover import (
    FailoverController,
    FailoverError,
    FencedWal,
    FencingError,
    ManagedWorker,
    OwnershipMap,
    OwnershipTransition,
    WorkerDurability,
)
from hypervisor_tpu_torch.fleet.rebalance import (
    PROTOCOL_STEPS,
    MigrationError,
    RebalanceController,
)
from hypervisor_tpu_torch.fleet.trace import stitch_chrome, stitch_otlp
from hypervisor_tpu_torch.fleet.worker import FleetSupervisor, WorkerSpec

__all__ = [
    "ALIVE",
    "DEAD",
    "SUSPECTED",
    "FailoverController",
    "FailoverError",
    "FencedWal",
    "FencingError",
    "FleetObservatory",
    "FleetRegistry",
    "FleetSnapshot",
    "FleetSupervisor",
    "LeaseConfig",
    "LeaseTransition",
    "ManagedWorker",
    "MigrationError",
    "OwnershipMap",
    "OwnershipTransition",
    "PROTOCOL_STEPS",
    "RebalanceController",
    "WorkerClient",
    "WorkerDurability",
    "WorkerSpec",
    "merge_expositions",
    "sample_series_count",
    "stitch_chrome",
    "stitch_otlp",
    "worker_label_coverage",
]
