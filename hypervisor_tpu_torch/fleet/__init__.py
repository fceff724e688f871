"""Fleet observatory: merged cross-process drains, stitched traces,
and a deterministic liveness plane ahead of the shard-out.

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

The reassignment half — `failover` (durable ownership namespaces, the
journaled `OwnershipMap`, the `FailoverController`) and `rebalance`
(planned zero-loss migration) — arrives with a later slice of the port;
its names refuse here with a message that says so.
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
from hypervisor_tpu_torch.fleet.trace import stitch_chrome, stitch_otlp
from hypervisor_tpu_torch.fleet.worker import FleetSupervisor, WorkerSpec

__all__ = [
    "ALIVE",
    "DEAD",
    "SUSPECTED",
    "FleetObservatory",
    "FleetRegistry",
    "FleetSnapshot",
    "FleetSupervisor",
    "LeaseConfig",
    "LeaseTransition",
    "WorkerClient",
    "WorkerSpec",
    "merge_expositions",
    "sample_series_count",
    "stitch_chrome",
    "stitch_otlp",
    "worker_label_coverage",
]

#: The reference's names that come with `fleet/failover` and
#: `fleet/rebalance`, a later slice of the port.
_LATER = {
    "FailoverController": "failover",
    "FailoverError": "failover",
    "FencedWal": "failover",
    "FencingError": "failover",
    "ManagedWorker": "failover",
    "OwnershipMap": "failover",
    "OwnershipTransition": "failover",
    "WorkerDurability": "failover",
    "PROTOCOL_STEPS": "rebalance",
    "MigrationError": "rebalance",
    "RebalanceController": "rebalance",
}


def __getattr__(name):
    if name in _LATER:
        from hypervisor_tpu_torch.core import _later

        raise _later(
            f"hypervisor_tpu_torch.fleet.{name}", f"fleet/{_LATER[name]}, ROADMAP A"
        )
    raise AttributeError(name)
