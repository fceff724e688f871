"""Tenant-dense serving: T logical hypervisors, one dispatch.

Every wave dispatch of a solo state serves exactly ONE logical
hypervisor. This package makes tenancy a leading tensor AXIS instead of
a deployment:

  * `TenantArena`: stacks every per-tenant table and ring into one
    `[T, ...]` table each and dispatches the fused governance wave over
    all tenants at once (`ops.pipeline.tenant_governance_wave`: each
    kernel in its tenant form, launched as often for T tenants as the
    solo wave launches it for one), with one drain read for all T.
  * `TenantState`: a `HypervisorState` whose device tables live in the
    arena's stacks (the lend/commit component protocol): every host op,
    WAL record, checkpoint and integrity hook works unchanged, per
    tenant.
  * `TenantFrontDoor` / `TenantWaveScheduler`: per-tenant admission
    quotas (a flooding tenant sheds against its OWN queues) and
    deficit-round-robin fair-share bucket filling across tenants.
"""

from hypervisor_tpu_torch.tenancy.arena import TenantArena, TenantState
from hypervisor_tpu_torch.tenancy.front_door import (
    TenantFrontDoor,
    TenantWaveScheduler,
)

__all__ = [
    "TenantArena",
    "TenantFrontDoor",
    "TenantState",
    "TenantWaveScheduler",
]
