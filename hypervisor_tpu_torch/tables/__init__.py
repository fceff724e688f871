"""Device tables, and carrying a reference state across.

`from_state_arrays` reads the `"<table>.<column>"` dict that the JAX
package's checkpoint plane writes (`hypervisor_tpu.runtime.checkpoint.
state_arrays`) for the agents, sessions and vouches tables, plus the
optional `"sagas.<column>"`, `"elevations.<column>"`, `"delta_log.<column>"`,
`"event_log.<column>"` and `"metrics.<column>"` blocks;
`to_state_arrays` writes the same dict back, byte for byte (u32 columns
as uint32). Both packages can then run from one seeded state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hypervisor_tpu_torch.tables.logs import DeltaLog, EventLog, TraceLog
from hypervisor_tpu_torch.tables.metrics import MetricsTable
from hypervisor_tpu_torch.tables.state import (
    AgentTable,
    ElevationTable,
    SagaTable,
    SessionTable,
    VouchTable,
)
from hypervisor_tpu_torch.tables.struct import tensors

__all__ = [
    "AgentTable",
    "DeltaLog",
    "ElevationTable",
    "EventLog",
    "MetricsTable",
    "SagaTable",
    "SessionTable",
    "StateTables",
    "TraceLog",
    "VouchTable",
    "from_state_arrays",
    "to_state_arrays",
]

_TABLE_TYPES = {"agents": AgentTable, "sessions": SessionTable, "vouches": VouchTable}
#: Columns holding u32 values (int32 bits in the port), by optional block.
_OPTIONAL = {"sagas": (SagaTable, ()),
             "elevations": (ElevationTable, ()),
             "delta_log": (DeltaLog, ("body", "digest")),
             "event_log": (EventLog, ("trace", "span")),
             "metrics": (MetricsTable, ("counters", "hist"))}


@dataclasses.dataclass
class StateTables:
    """The device tables of one state (the optional ones may be None)."""

    agents: AgentTable
    sessions: SessionTable
    vouches: VouchTable
    metrics: MetricsTable | None = None
    delta_log: DeltaLog | None = None
    sagas: SagaTable | None = None
    elevations: ElevationTable | None = None
    event_log: EventLog | None = None


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def from_state_arrays(
    arrays: dict[str, np.ndarray], device: str | torch.device
) -> StateTables:
    """Port tables from a reference `state_arrays` dict (copies)."""
    out = {}
    for tname, cls in _TABLE_TYPES.items():
        out[tname] = cls(**{
            f.name: _to_tensor(arrays[f"{tname}.{f.name}"], device)
            for f in dataclasses.fields(cls)
        })
    for tname, (cls, _) in _OPTIONAL.items():
        names = [f.name for f in dataclasses.fields(cls)]
        if f"{tname}.{names[0]}" in arrays:
            out[tname] = cls(**{n: _to_tensor(arrays[f"{tname}.{n}"], device) for n in names})
    return StateTables(**out)


def to_state_arrays(tables: StateTables) -> dict[str, np.ndarray]:
    """The reference's `"<table>.<column>"` dict for these tables (copies;
    u32 columns come back as uint32)."""
    out: dict[str, np.ndarray] = {}
    for tname in _TABLE_TYPES:
        for col, t in tensors(getattr(tables, tname)).items():
            out[f"{tname}.{col}"] = t.detach().cpu().numpy().copy()
    for tname, (_, u32_cols) in _OPTIONAL.items():
        tbl = getattr(tables, tname)
        if tbl is None:
            continue
        for col, t in tensors(tbl).items():
            a = t.detach().cpu().numpy().copy()
            out[f"{tname}.{col}"] = a.view(np.uint32) if col in u32_cols else a
    return out
