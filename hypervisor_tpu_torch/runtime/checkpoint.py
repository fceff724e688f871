"""Checkpoint / resume for the batched device state.

The counterpart of `hypervisor_tpu.runtime.checkpoint`'s npz format:
periodic host-side checkpoints of the device-resident agent, session,
vouch, saga and elevation tables and the DeltaLog and EventLog rings.
The columns are copied to the host synchronously (one copy per column)
and the disk write may run on a background thread, so the waves keep
running during the write.

Format: one directory per checkpoint step containing
  * tables.npz  — every table column, keyed "<table>.<column>", with the
    reference's dtypes (u32 words as uint32)
  * host.json   — intern tables, slot cursors, membership keys, the audit
    index, Merkle frontiers, free lists, the capacity and the WAL
    watermark

The key set, dtypes and metadata are the reference's, so a checkpoint
written by either package restores on the other. Restore rebuilds a
`HypervisorState` on the caller's device whose next wave continues where
the saved one stopped (same slots, same handles, same membership).

The reference's second backend (a JAX checkpoint library with
retention and async saves) has its counterpart in
`torch.distributed.checkpoint` (DCP): `open_checkpoint_manager`,
`save_state_dcp` and `restore_state_dcp` serialize the same
(`state_arrays`, `host_metadata`) pair, one directory per step under a
manager that keeps the newest `max_to_keep`, with no process group.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from hypervisor_tpu_torch import resolve_device
from hypervisor_tpu_torch.audit.frontier import MerkleFrontier
from hypervisor_tpu_torch.config import DEFAULT_CONFIG, HypervisorConfig
from hypervisor_tpu_torch.state import HypervisorState
from hypervisor_tpu_torch.tables import StateTables, _to_tensor, to_state_arrays
from hypervisor_tpu_torch.tables.intern import InternTable
from hypervisor_tpu_torch.tables.logs import DeltaLog, EventLog
from hypervisor_tpu_torch.tables.state import (
    AI32_BD_WIN_START,
    AI32_WIDTH,
    LEGACY_SI8_MODE,
    LEGACY_SI8_STATE,
    SI32_MODE,
    SI32_STATE,
    SI32_WIDTH,
    AgentTable,
    ElevationTable,
    SagaTable,
    SessionTable,
    VouchTable,
)

logger = logging.getLogger(__name__)

_TABLE_TYPES = {
    "agents": AgentTable,
    "sessions": SessionTable,
    "vouches": VouchTable,
    "sagas": SagaTable,
    "elevations": ElevationTable,
    "delta_log": DeltaLog,
    "event_log": EventLog,
}

# One writer at a time per checkpoint target: overlapping background saves
# to e.g. "latest" must serialize or they race on the tmp files and the
# .done marker.
_writer_locks: dict[str, threading.Lock] = {}
_writer_locks_guard = threading.Lock()


def _writer_lock(target: Path) -> threading.Lock:
    key = str(target.resolve())
    with _writer_locks_guard:
        return _writer_locks.setdefault(key, threading.Lock())


def _fsync_dir(path: Path) -> None:
    """Make the directory's own entries (the os.replace renames and the
    .done marker) durable; best-effort where the OS refuses dir fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover — platform without dir-open
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover — e.g. network filesystems
        pass
    finally:
        os.close(fd)


def _intern_dump(t: InternTable) -> list[str]:
    return [t.string(h) for h in range(len(t))]


def _intern_load(strings: list[str]) -> InternTable:
    t = InternTable()
    for s in strings:
        t.intern(s)
    return t


def state_arrays(state: HypervisorState) -> dict[str, np.ndarray]:
    """Every checkpointed table column as host numpy, keyed table.column,
    in the reference's order and dtypes.

    COPIES, not views: the snapshot is one consistent cut that may be
    serialized (or compared) after later waves, and the waves write the
    tables in place (on the CPU a tensor's `.numpy()` shares its memory).
    """
    return to_state_arrays(StateTables(
        state.agents, state.sessions, state.vouches, delta_log=state.delta_log,
        sagas=state.sagas, elevations=state.elevations, event_log=state.event_log))


def host_metadata(state: HypervisorState) -> dict:
    return {
        "agent_ids": _intern_dump(state.agent_ids),
        "session_ids": _intern_dump(state.session_ids),
        "saga_ids": _intern_dump(state.saga_ids),
        "next_agent_slot": state._next_agent_slot,
        "next_session_slot": state._next_session_slot,
        "next_saga_slot": state._next_saga_slot,
        "next_edge_slot": state._next_edge_slot,
        "next_elev_slot": state._next_elev_slot,
        # [session, did] pairs on disk, as the reference writes them.
        "members": sorted(
            [[k >> 32, k & 0xFFFFFFFF] for k in state._members]
        ),
        "free_agent_slots": list(state._free_agent_slots),
        "free_edge_slots": list(state._free_edge_slots),
        "free_elev_slots": list(state._free_elev_slots),
        "epoch_base": state._epoch_base,
        "audit_rows": {str(k): v for k, v in state._audit_rows.items()},
        "chain_seed": {
            str(k): [int(w) for w in v] for k, v in state._chain_seed.items()
        },
        "turns": {str(k): v for k, v in state._turns.items()},
        # Incremental Merkle frontiers: O(log n) node stacks, so a restore
        # resumes session roots without re-hashing history.
        "frontier": {
            str(k): fr.to_meta() for k, fr in state._frontier.items()
        },
        "fanout_groups": {
            str(slot): [[policy, idxs] for policy, idxs in groups]
            for slot, groups in state._fanout_groups.items()
        },
        # Validated at restore: array shapes come from the npz while slot
        # allocation uses the live config, so a mismatch must fail loudly.
        "capacity": dataclasses.asdict(state.config.capacity),
        # WAL watermark: the last committed journal seq this snapshot
        # CONTAINS, captured synchronously with the array copy, so
        # `resilience.recovery.recover` replays exactly the suffix past it
        # (None when no journal is attached).
        "wal_seq": (
            state.journal.last_seq
            if getattr(state, "journal", None) is not None
            else None
        ),
    }


def save_state(
    state: HypervisorState,
    directory: str | Path,
    step: Optional[int] = None,
    background: bool = False,
) -> Path:
    """Checkpoint the batched state.

    The columns are copied to the host synchronously; with
    `background=True` the disk write happens on a daemon thread and the
    returned path's `.done` marker appears when durable (`wait_durable`).

    The state must be flushed first: joins staged with `enqueue_join` but
    not yet admitted by `flush_joins`, and deltas staged but not flushed,
    live only on the host and would be lost, so saving with either is an
    error.

    Overwriting a prior checkpoint at the same target is crash-consistent:
    the stale `.done` marker is removed synchronously before the writer
    starts, files are written to temp names and `os.replace`d into place,
    and `.done` appears only after both files are in place.
    """
    if state._pending_rows:
        raise RuntimeError(
            f"cannot checkpoint with {len(state._pending_rows)} staged joins; "
            "call flush_joins() first"
        )
    if state._pending_deltas:
        raise RuntimeError(
            f"cannot checkpoint with {len(state._pending_deltas)} staged "
            "deltas; call flush_deltas() first"
        )
    directory = Path(directory)
    target = directory / (f"step_{step}" if step is not None else "latest")
    target.mkdir(parents=True, exist_ok=True)
    done = target / ".done"
    done.unlink(missing_ok=True)  # readers must not trust a torn overwrite

    # ONE consistent cut for the arrays and the WAL watermark: enqueue_join
    # journals under the staging lock, so a join committed while the
    # columns copy can never land below the watermark yet miss the
    # snapshot. Re-check staged rows under the same lock.
    with state._enqueue_lock:
        if state._pending_rows:
            raise RuntimeError(
                f"cannot checkpoint with {len(state._pending_rows)} staged "
                "joins; call flush_joins() first"
            )
        arrays = state_arrays(state)      # device -> host happens here
        meta = host_metadata(state)

    def write():
        with _writer_lock(target):
            # A writer queued behind an older save drops the marker the
            # older writer just published: only the newest data earns .done.
            done.unlink(missing_ok=True)
            # tmp + fsync + os.replace + directory fsync: the data is on
            # disk before the rename makes it visible, and the renames are
            # durable before `.done` says so.
            tmp_npz = target / "tables.npz.tmp"
            with open(tmp_npz, "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp_npz, target / "tables.npz")
            tmp_json = target / "host.json.tmp"
            with open(tmp_json, "w") as f:
                f.write(json.dumps(meta))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp_json, target / "host.json")
            _fsync_dir(target)
            done.touch()
            _fsync_dir(target)

    if background:
        threading.Thread(target=write, daemon=True).start()
    else:
        write()
    return target


def _repack_legacy_packed_columns(data, tname: str, ttype) -> dict:
    """Checkpoints written before a table's column packing saved one
    array per column (`agents.sigma_raw`, `sessions.state`, ...); stack
    them into the packed blocks so old checkpoints restore losslessly.

    Schema-derived: the block layout comes from `ttype._PACKED` and every
    default (a column the legacy save predates) from `ttype.create(1)`'s
    value for that virtual column. No-op for current-format checkpoints
    and for tables absent from the save.
    """
    packed = getattr(ttype, "_PACKED", None)
    if not packed:
        return data
    out = (
        data
        if isinstance(data, dict)
        else {k: data[k] for k in data.files}
    )
    blocks = {block for block, _ in packed.values()}
    if any(f"{tname}.{block}" in out for block in blocks):
        return out  # current (packed) format
    legacy = [name for name in packed if f"{tname}.{name}" in out]
    if not legacy:
        return out  # table not in this checkpoint at all
    n = len(np.asarray(out[f"{tname}.{legacy[0]}"]))
    fresh = ttype.create(1, "cpu")

    by_block: dict[str, list[str]] = {}
    for name, (block, idx) in packed.items():
        cols = by_block.setdefault(block, [])
        while len(cols) <= idx:
            cols.append("")
        cols[idx] = name

    for block, names in by_block.items():
        fresh_block = getattr(fresh, block).numpy()
        dtype = fresh_block.dtype
        stacked = []
        for name in names:
            arr = out.pop(f"{tname}.{name}", None)
            if arr is None:
                arr = np.full((n,), getattr(fresh, name).numpy()[0])
            stacked.append(np.asarray(arr, dtype))
        built = np.stack(stacked, axis=1)
        # Blocks may be wider than their named columns (the agent i32
        # block carries the breach window as an unnamed slice): pad to the
        # live width with the freshly created defaults.
        width = fresh_block.shape[1]
        if built.shape[1] < width:
            tail = np.broadcast_to(
                fresh_block[0, built.shape[1]:], (n, width - built.shape[1])
            ).astype(dtype)
            built = np.concatenate([built, tail], axis=1)
        out[f"{tname}.{block}"] = built
    return out


def restore_state(
    checkpoint: str | Path,
    config: HypervisorConfig = DEFAULT_CONFIG,
    device: str | torch.device = "cuda",
) -> HypervisorState:
    """Rebuild a HypervisorState on `device` from a checkpoint directory
    (either package's). Raises without CUDA unless `device` says the CPU."""
    device = resolve_device(device)
    checkpoint = Path(checkpoint)
    data = np.load(checkpoint / "tables.npz")
    meta = json.loads((checkpoint / "host.json").read_text())
    return _rebuild(data, meta, config, device)


def _rebuild(data, meta: dict, config: HypervisorConfig, device) -> HypervisorState:
    """Shared restore core: arrays mapping + host metadata -> live state.

    `data` is any mapping of "table.column" -> array (an NpzFile or a
    plain dict).
    """
    saved_capacity = meta.get("capacity")
    if saved_capacity is not None:
        live_capacity = dataclasses.asdict(config.capacity)
        # Only the keys the checkpoint recorded: capacity fields added
        # later must not brick older checkpoints.
        diff = {
            k: (saved_capacity[k], live_capacity.get(k))
            for k in saved_capacity
            if k in live_capacity and saved_capacity[k] != live_capacity[k]
        }
        if diff:
            raise ValueError(
                f"checkpoint capacity mismatch (saved, restore): {diff}"
            )

    state = HypervisorState(config, device=device)
    for tname, ttype in _TABLE_TYPES.items():
        data = _repack_legacy_packed_columns(data, tname, ttype)
    # The agent i32 block's width ladder (newest last):
    #   width 5  — tumbling breach counters (did/session/flags/bd_calls/
    #              bd_privileged): the counters are dropped and the window
    #              starts fresh (zeros);
    #   width 3  — identity columns only, the sliding window in its own
    #              `agents.bd_window` array: folded back in;
    #   width 21 — current: identity + the window as block columns.
    # (`data` is a plain dict here: the repack loop above converts NpzFile
    # inputs.)
    legacy_window = data.pop("agents.bd_window", None)
    if "agents.i32" in data:
        legacy_i32 = np.asarray(data["agents.i32"])
        if legacy_i32.ndim == 2 and legacy_i32.shape[1] != AI32_WIDTH:
            n_rows = legacy_i32.shape[0]
            if legacy_window is None:
                # Never silent: name the rows whose in-flight breach
                # counters were discarded (a fast save->restore cycle
                # blinds the detector to an agent mid-probe).
                dropped = legacy_i32[:, AI32_BD_WIN_START:]
                if dropped.size and np.any(dropped != 0):
                    logger.warning(
                        "legacy checkpoint migration dropped nonzero "
                        "breach-window counters on %d agent row(s); the "
                        "sliding window restarts empty — breach analysis "
                        "is blind to pre-save probing until it refills "
                        "(~window_seconds)",
                        int(np.count_nonzero(np.any(dropped != 0, axis=1))),
                    )
            window = (
                np.asarray(legacy_window, np.int32)
                if legacy_window is not None
                else np.zeros(
                    (n_rows, AI32_WIDTH - AI32_BD_WIN_START), np.int32
                )
            )
            data["agents.i32"] = np.concatenate(
                [legacy_i32[:, :AI32_BD_WIN_START].astype(np.int32), window],
                axis=1,
            )
    # Saves written before the session state and mode codes joined the
    # i32 block carried them in an i8[S, 2] block beside a width-3 i32
    # block: widen the i32 block and fold the codes in.
    if "sessions.i8" in data:
        legacy_i8 = np.asarray(data.pop("sessions.i8"))
        sess_i32 = np.asarray(data["sessions.i32"])
        if sess_i32.ndim == 2 and sess_i32.shape[1] < SI32_WIDTH:
            widened = np.zeros((sess_i32.shape[0], SI32_WIDTH), np.int32)
            widened[:, : sess_i32.shape[1]] = sess_i32
            widened[:, SI32_STATE] = legacy_i8[:, LEGACY_SI8_STATE]
            widened[:, SI32_MODE] = legacy_i8[:, LEGACY_SI8_MODE]
            data["sessions.i32"] = widened
    for tname, ttype in _TABLE_TYPES.items():
        fields = dataclasses.fields(ttype)
        cols = {
            f.name: _to_tensor(data[f"{tname}.{f.name}"], state.device)
            for f in fields
            if f"{tname}.{f.name}" in data
        }
        if not cols:
            continue  # table added after this checkpoint was written
        fresh = getattr(state, tname)
        for f in fields:
            # Columns added after the save keep their freshly created
            # defaults (shape-compatible by the capacity check above).
            cols.setdefault(f.name, getattr(fresh, f.name))
        setattr(state, tname, ttype(**cols))

    state.agent_ids = _intern_load(meta["agent_ids"])
    state.session_ids = _intern_load(meta["session_ids"])
    state.saga_ids = _intern_load(meta.get("saga_ids", []))
    state._next_agent_slot = int(meta["next_agent_slot"])
    state._next_session_slot = int(meta["next_session_slot"])
    state._next_saga_slot = int(meta.get("next_saga_slot", 0))
    state._saga_lo = 0
    state._next_edge_slot = int(meta.get("next_edge_slot", 0))
    state._next_elev_slot = int(meta.get("next_elev_slot", 0))
    state._members = {
        (int(a) << 32) | (int(b) & 0xFFFFFFFF) for a, b in meta["members"]
    }
    state._audit_rows = {
        int(k): [int(r) for r in v] for k, v in meta.get("audit_rows", {}).items()
    }
    state._chain_seed = {
        int(k): np.array(v, np.uint32)
        for k, v in meta.get("chain_seed", {}).items()
    }
    state._turns = {int(k): int(v) for k, v in meta.get("turns", {}).items()}
    frontier_meta = meta.get("frontier")
    if frontier_meta is not None:
        state._frontier = {
            int(k): MerkleFrontier.from_meta(v)
            for k, v in frontier_meta.items()
        }
    else:
        # Legacy save (pre-frontier): rebuild each session's frontier from
        # its recorded leaf digests, once.
        digest_host = np.asarray(data["delta_log.digest"], np.uint32)
        state._frontier = {
            int(sess): MerkleFrontier.from_leaf_digests(
                digest_host[np.asarray(rows)]
            )
            for sess, rows in state._audit_rows.items()
            if rows
        }
    state._fanout_groups = {
        int(slot): [(int(policy), [int(i) for i in idxs]) for policy, idxs in groups]
        for slot, groups in meta.get("fanout_groups", {}).items()
    }
    state._free_agent_slots = [
        int(r) for r in meta.get("free_agent_slots", [])
    ]
    state._free_edge_slots = [
        int(r) for r in meta.get("free_edge_slots", [])
    ]
    state._free_elev_slots = [
        int(r) for r in meta.get("free_elev_slots", [])
    ]
    state._epoch_base = float(meta.get("epoch_base", state._epoch_base))
    # WAL watermark: recovery replays committed records PAST this seq
    # (None when the save ran without a journal: replay everything).
    state._restored_wal_seq = meta.get("wal_seq")
    # Ring-row ownership comes straight from the saved session column:
    # without it a wrap after the restore would skip eviction and leave
    # stale audit rows pointing at recycled digests.
    state._row_session = np.array(data["delta_log.session"], np.int32)
    # The host mirror of the DeltaLog cursor: the next wave appends at it.
    state._delta_cursor = int(state.delta_log.cursor)
    return state


def wait_durable(target: Path, timeout: float = 30.0) -> bool:
    """Block until a background save's .done marker exists."""
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if (target / ".done").exists():
            return True
        time.sleep(0.01)
    return False


# ── the torch.distributed.checkpoint backend ─────────────────────────
#
# The npz path above is dependency-free; this backend is the ecosystem's:
# DCP's sharded file layout and planner (on a multi-host deployment its
# cross-rank coordination), behind a step manager with retention. Both
# serialize the same (state_arrays, host_metadata) pair, so a state
# restored from either is the same column for column.


class CheckpointManager:
    """Checkpoint steps under one directory (`step_<n>/`: DCP's files,
    `host.json`, and `.done` once durable), the newest `max_to_keep` kept.
    Saves are synchronous, so `wait_until_finished` has nothing to wait
    for; it is the durability barrier's name all the same."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3) -> None:
        self.directory = Path(directory).resolve()
        self.max_to_keep = int(max_to_keep)
        self.directory.mkdir(parents=True, exist_ok=True)

    def step_dir(self, step: int) -> Path:
        return self.directory / f"step_{int(step)}"

    def all_steps(self) -> list[int]:
        """The durable steps, oldest first."""
        return sorted(int(p.name[5:]) for p in self.directory.glob("step_*")
                      if p.name[5:].isdigit() and (p / ".done").exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait_until_finished(self) -> None:
        return None

    def _retain(self) -> None:
        import shutil

        for step in self.all_steps()[:-self.max_to_keep or None]:
            shutil.rmtree(self.step_dir(step), ignore_errors=True)


def open_checkpoint_manager(directory: str | Path, max_to_keep: int = 3) -> CheckpointManager:
    """A step manager over the hypervisor state layout, keeping the
    `max_to_keep` most recent steps."""
    return CheckpointManager(directory, max_to_keep)


def save_state_dcp(state: HypervisorState, manager: CheckpointManager, step: int) -> Path:
    """Checkpoint through `torch.distributed.checkpoint` (no process
    group: `no_dist=True`); the same staged-join/delta contract and the
    same consistent cut as `save_state`. Returns the step's directory."""
    import shutil

    import torch.distributed.checkpoint as dcp

    if state._pending_rows or state._pending_deltas:
        raise RuntimeError("cannot checkpoint with staged joins/deltas; flush first")
    with state._enqueue_lock:
        arrays = state_arrays(state)
        meta = host_metadata(state)
    target = manager.step_dir(step)
    shutil.rmtree(target, ignore_errors=True)
    target.mkdir(parents=True)
    dcp.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()},
             checkpoint_id=str(target), no_dist=True)
    # DCP keeps a 0-d tensor as one element of shape (1,): the columns'
    # own shapes ride the host metadata's file.
    meta = {**meta, "column_shapes": {k: list(v.shape) for k, v in arrays.items()}}
    with open(target / "host.json", "w") as f:
        f.write(json.dumps(meta))
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(target)
    (target / ".done").touch()
    _fsync_dir(target)
    manager._retain()
    return target


def restore_state_dcp(
    manager: CheckpointManager,
    step: Optional[int] = None,
    config: HypervisorConfig = DEFAULT_CONFIG,
    device: str | torch.device = "cuda",
) -> HypervisorState:
    """Rebuild a HypervisorState on `device` from a DCP step (the latest
    by default), with `restore_state`'s capacity checks and column
    policy. Raises without CUDA unless `device` says the CPU."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    device = resolve_device(device)
    if step is None:
        step = manager.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint steps found")
    target = manager.step_dir(step)
    layout = dcp.FileSystemReader(str(target)).read_metadata().state_dict_metadata
    tables = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
              for k, m in layout.items() if isinstance(m, TensorStorageMetadata)}
    with warnings.catch_warnings():
        # DCP notes that no process group is set up: by design here.
        warnings.filterwarnings("ignore", "torch.distributed is disabled")
        dcp.load(tables, checkpoint_id=str(target), no_dist=True)
    meta = json.loads((target / "host.json").read_text())
    shapes = meta.pop("column_shapes")
    return _rebuild({k: t.numpy().reshape(shapes[k]) for k, t in tables.items()}, meta,
                    config, device)


__all__ = [
    "CheckpointManager",
    "host_metadata",
    "open_checkpoint_manager",
    "restore_state",
    "restore_state_dcp",
    "save_state",
    "save_state_dcp",
    "state_arrays",
    "wait_durable",
]
