"""Device mesh construction for the agent-sharded runtime
(`hypervisor_tpu.parallel.mesh`).

The scaling axis of this framework is the number of concurrent agents /
sessions. The canonical mesh is 1-D over the `agents` axis: every table
column [N, ...] shards along it, STRONG-mode consensus is a psum over it,
and multi-slice deployments add a `dcn` outer axis for cross-slice
reconciliation.

The mesh is single-controller, as the reference's is: one process drives
every shard, the shards' parts of a sharded column live on the mesh's
devices, and the collectives (`parallel.collectives`) are explicit
functions over those parts. A mesh is an ordered array of torch devices,
so it may name one device several times: a virtual mesh of D shards on
one card (or on the CPU), the counterpart of the reference's virtual CPU
mesh. Such a mesh exists only when the caller asks for it, through
`devices=`; `make_mesh(n)` takes n distinct CUDA devices or raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

AGENT_AXIS = "agents"
DCN_AXIS = "dcn"


class Mesh:
    """An ordered array of torch devices, shape (D,) or (S, P), with one
    axis name per dimension. `devices.size` and `devices.flat` read as the
    reference's (a numpy object array); shard d of a sharded column lives
    on `devices.flat[d]`. Meshes compare and hash by their devices, their
    shape and their axis names, so per-mesh caches (the state's sharded
    programs, the facade's consistency runtimes) find an equal mesh."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        flat = [torch.device(d) for d in arr.flat]
        self.devices = np.empty(arr.shape, dtype=object)
        for i, d in enumerate(flat):
            self.devices.flat[i] = d
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"mesh of shape {self.devices.shape} needs {self.devices.ndim} axis "
                f"names, got {self.axis_names}"
            )
        if self.devices.size == 0:
            raise ValueError("a mesh needs at least one device")

    def _key(self) -> tuple:
        return (tuple(str(d) for d in self.devices.flat), self.devices.shape,
                self.axis_names)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.devices.shape}, {self.axis_names}, {[str(d) for d in self.devices.flat]})"


def _device_pool(need: Optional[int], platform: Optional[str] = None) -> list:
    """`need` shard devices of `platform`: "cpu" gives `need` CPU shards
    (one when `need` is None); otherwise (None or "cuda") the first `need`
    CUDA devices (all of them when `need` is None). Too few CUDA devices
    raise, naming both counts: there is no fallback to the host, and a
    virtual mesh on one card is asked for through `devices=`."""
    if platform == "cpu":
        return [torch.device("cpu")] * (1 if need is None else int(need))
    if platform not in (None, "cuda"):
        raise ValueError(f"unknown mesh platform {platform!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    want = have if need is None else int(need)
    if want < 1 or have < want:
        raise ValueError(
            f"requested {want}-device CUDA mesh but only {have} CUDA device(s) "
            "available; pass devices= for a virtual mesh on fewer devices"
        )
    return [torch.device("cuda", i) for i in range(want)]


def make_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence] = None,
    platform: Optional[str] = None,
) -> Mesh:
    """1-D mesh over the agent axis. `devices` names the shards' devices
    outright (repeats allowed: `[torch.device("cuda:0")] * 8` is a virtual
    8-shard mesh on one card); else `platform="cpu"` gives `n_devices` CPU
    shards, and the default takes `n_devices` distinct CUDA devices."""
    if devices is None:
        devices = _device_pool(n_devices, platform)
    return Mesh(np.asarray(list(devices), dtype=object), (AGENT_AXIS,))


def make_multislice_mesh(
    n_slices: int, per_slice: int, platform: Optional[str] = None, devices=None,
) -> Mesh:
    """2-D mesh (dcn, agents): the outer axis across slices, the inner one
    within a slice. Collectives over AGENT_AXIS stay within a slice;
    EVENTUAL-mode cross-slice reconciliation reduces over DCN_AXIS between
    batched ticks. `platform` as `make_mesh`'s; `devices` (any sequence
    of n_slices * per_slice devices, slice-major) names them outright."""
    if devices is None:
        devices = _device_pool(n_slices * per_slice, platform)
    arr = np.empty(n_slices * per_slice, dtype=object)
    flat = list(np.asarray(devices, dtype=object).flat)
    if len(flat) != n_slices * per_slice:
        raise ValueError(
            f"a {n_slices}x{per_slice} mesh needs {n_slices * per_slice} devices, "
            f"got {len(flat)}"
        )
    for i, d in enumerate(flat):
        arr[i] = d
    return Mesh(arr.reshape(n_slices, per_slice), (DCN_AXIS, AGENT_AXIS))
