"""Sharding specs for the governance tables (`hypervisor_tpu.parallel.
sharding`).

Every table's leading axis is the entity axis (agents / sessions / edges
/ lanes); all shard 1-D over the mesh's shards in their flat order. A
sharded column is split along that axis into D contiguous parts, part d
on `mesh.devices.flat[d]`. Where the part's device is the column's own,
the part is a view of the column (`narrow`), so in-place writes to it
land in the column; elsewhere it is a copy, and `write_back` returns it.
Scalars and small aggregates replicate: each shard reads the one copy,
moved to its device where that differs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from hypervisor_tpu_torch.parallel.mesh import AGENT_AXIS, Mesh
from hypervisor_tpu_torch.tables.struct import tensors


class NamedSharding(NamedTuple):
    """A placement over a mesh: `spec` () replicates, (axis,) shards the
    leading axis over the mesh's shards."""

    mesh: Mesh
    spec: tuple

    def split(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The D per-shard parts of `x` under this placement."""
        if not self.spec:
            return [x.to(d) for d in self.mesh.devices.flat]
        return split_rows(x, self.mesh)


def lane_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (entity) axis over the agent mesh axis."""
    return NamedSharding(mesh, (AGENT_AXIS,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def split_rows(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> list[torch.Tensor]:
    """D contiguous parts of `x` along `dim`, part d on shard d's device.
    A part along dim 0 of a contiguous tensor is a view; a part along
    another axis is made contiguous (a copy), as a kernel reads it."""
    d = mesh.devices.size
    n = x.shape[dim]
    if n % d:
        raise ValueError(f"axis {dim} of length {n} does not divide over {d} shards")
    step = n // d
    out = []
    for i, dev in enumerate(mesh.devices.flat):
        part = x.narrow(dim, i * step, step)
        if not part.is_contiguous():
            part = part.contiguous()
        out.append(part.to(dev))
    return out


def shard_table(table, mesh: Mesh) -> list:
    """Every column of a table split by rows: D tables of the same class,
    table d holding shard d's rows on its device (views where the device
    is the table's own)."""
    cols = {name: split_rows(t, mesh) for name, t in tensors(table).items()}
    return [dataclasses.replace(table, **{name: parts[i] for name, parts in cols.items()})
            for i in range(mesh.devices.size)]


def _is_view_of(part: torch.Tensor, whole: torch.Tensor) -> bool:
    return (part.device == whole.device
            and part.untyped_storage().data_ptr() == whole.untyped_storage().data_ptr())


def write_back(table, parts: list) -> None:
    """Copy each part that is not a view of `table`'s columns into its
    rows (a part on another device than the table's), IN PLACE."""
    for name, whole in tensors(table).items():
        step = whole.shape[0] // len(parts)
        for i, part in enumerate(parts):
            col = getattr(part, name)
            if not _is_view_of(col, whole):
                whole.narrow(0, i * step, step).copy_(col)


def gather_rows(parts: list[torch.Tensor], device, dim: int = 0) -> torch.Tensor:
    """The global tensor of D parts (shard-major along `dim`) on `device`."""
    return torch.cat([p.to(device) for p in parts], dim=dim)
