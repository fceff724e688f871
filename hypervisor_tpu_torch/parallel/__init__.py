"""Multi-chip layer: mesh, shardings, ICI collectives (the distributed backend)."""

from hypervisor_tpu_torch.parallel.mesh import (
    AGENT_AXIS,
    DCN_AXIS,
    make_mesh,
    make_multislice_mesh,
)
from hypervisor_tpu_torch.parallel.sharding import lane_sharding, replicated, shard_table
from hypervisor_tpu_torch.parallel.collectives import (
    eventual_tick,
    multislice_reconcile,
    reconcile,
    reconcile_sessions,
    sharded_admission,
    sharded_chain,
    strong_tick,
)

__all__ = [
    "AGENT_AXIS",
    "DCN_AXIS",
    "make_mesh",
    "make_multislice_mesh",
    "lane_sharding",
    "replicated",
    "shard_table",
    "sharded_admission",
    "strong_tick",
    "eventual_tick",
    "reconcile",
    "reconcile_sessions",
    "multislice_reconcile",
    "sharded_chain",
]
