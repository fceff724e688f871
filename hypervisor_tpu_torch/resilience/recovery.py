"""Crash recovery: newest durable checkpoint + committed WAL suffix.

The counterpart of `hypervisor_tpu.resilience.recovery`, onto a state on
the caller's device (CUDA by default; without CUDA it raises unless the
caller asks for the CPU). It reads either package's checkpoints and
logs: the op names and payloads are the reference's, and the replay
handlers take them as they are (a `use_pallas` key, the reference's
kernel switch, is ignored: the port has none).

The restore sequence (`recover`):

  1. **Locate** the newest durable checkpoint under the directory — a
     step directory whose `.done` marker exists (torn saves never earn
     the marker, `runtime.checkpoint.save_state`).
  2. **Restore** it (`restore_state`) and **verify the audit chain
     heads**: every session's recorded chain seed must equal the last
     DeltaLog digest its audit index points at. A mismatch means the
     checkpoint's tables and host metadata disagree — refusing here is
     what keeps a corrupt save from silently re-anchoring every future
     Merkle root.
  3. **Replay** the WAL suffix: committed records with seq past the
     checkpoint's watermark (`host.json` `wal_seq`, captured at the
     same moment the arrays were snapshotted) re-execute in seq order
     against the restored state. Ops journal explicit `now` values, so
     replay is time-deterministic; journaling is disabled during replay
     (the records already exist). On a CUDA state the replayed waves run
     the main path's kernels.

An op with an INTENT but no COMMIT is skipped by construction
(`wal.scan`): the crash hit mid-dispatch, the device mutation never
became observable, and the transition simply never happened. After
recover, the device tables and audit chain heads are bit-identical to an
uninterrupted run at the same committed prefix.

A replay publishes on the recovered deployment's own planes: the
`hv_wal_replayed_ops_total` host counter and the health plane's
`wal_replayed` event.
"""

from __future__ import annotations

import re
from contextlib import nullcontext
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from hypervisor_tpu_torch import resolve_device, u32
from hypervisor_tpu_torch.config import DEFAULT_CONFIG, HypervisorConfig
from hypervisor_tpu_torch.models import ConsistencyMode, SessionConfig, SessionState
from hypervisor_tpu_torch.observability.metrics import WAL_REPLAYED_OPS
from hypervisor_tpu_torch.resilience.wal import WalRecord, WriteAheadLog, scan
from hypervisor_tpu_torch.runtime.checkpoint import restore_state, save_state
from hypervisor_tpu_torch.state import HypervisorState

_STEP_RE = re.compile(r"^step_(\d+)$")


class RecoveryError(RuntimeError):
    """Restore refused: no durable checkpoint, or integrity failed."""


# ── checkpointing with a WAL watermark ───────────────────────────────


def checkpoint_with_watermark(
    state: HypervisorState,
    directory: str | Path,
    step: Optional[int] = None,
    background: bool = False,
) -> Path:
    """`save_state` + the WAL watermark the restore replays from.

    The watermark (`host.json` `wal_seq`) is captured by
    `checkpoint.host_metadata` synchronously with the array snapshot,
    so it names exactly the last committed op the checkpoint contains —
    call this from the dispatch thread (or under the same serialization
    as dispatches), like `save_state` itself.
    """
    return save_state(state, directory, step=step, background=background)


def step_checkpoints(
    directory: str | Path, durable_only: bool = False
) -> list[tuple[int, Path]]:
    """`(step, path)` for every `step_<N>` child, ascending by step: the
    one step-directory enumerator, so the naming scheme cannot drift
    between writers and readers."""
    directory = Path(directory)
    if not directory.is_dir():
        return []
    out = []
    for child in directory.iterdir():
        m = _STEP_RE.match(child.name)
        if not (m and child.is_dir()):
            continue
        if durable_only and not (child / ".done").exists():
            continue
        out.append((int(m.group(1)), child))
    out.sort()
    return out


def latest_durable_checkpoint(directory: str | Path) -> Optional[Path]:
    """Newest checkpoint directory whose `.done` marker exists.

    "Newest" is by the marker's mtime — the moment the save became
    durable — with the step number as tiebreak, so a fresher bare
    `latest` save beats an older `step_<N>` and vice versa. None when
    nothing durable.
    """
    directory = Path(directory)
    if not directory.is_dir():
        return None
    candidates = []
    for child in directory.iterdir():
        done = child / ".done"
        if not (child.is_dir() and done.exists()):
            continue
        m = _STEP_RE.match(child.name)
        step = int(m.group(1)) if m else -1
        candidates.append((done.stat().st_mtime, step, child))
    if not candidates:
        return None
    return max(candidates)[2]


# ── audit-chain verification ─────────────────────────────────────────


def verify_audit_heads(state: HypervisorState) -> int:
    """Check every session's chain seed against its last DeltaLog
    digest; returns sessions verified, raises RecoveryError on any
    divergence (tables vs host metadata disagree — the checkpoint is
    not trustworthy)."""
    digest_host = u32.to_numpy_u32(state.delta_log.digest)
    verified = 0
    for sess, rows in state._audit_rows.items():
        if not rows:
            continue
        seed = state._chain_seed.get(sess)
        if seed is None:
            raise RecoveryError(
                f"session {sess} has {len(rows)} audit rows but no "
                "recorded chain seed"
            )
        if not np.array_equal(
            np.asarray(seed, np.uint32), digest_host[rows[-1]]
        ):
            raise RecoveryError(
                f"audit chain head mismatch for session {sess}: the "
                "recorded seed does not match the DeltaLog tail digest"
            )
        verified += 1
    return verified


# ── WAL replay ───────────────────────────────────────────────────────


def _session_config(a: dict) -> SessionConfig:
    return SessionConfig(
        consistency_mode=ConsistencyMode(a["mode"]),
        max_participants=int(a["max_participants"]),
        max_duration_seconds=int(a["max_duration_seconds"]),
        min_sigma_eff=float(a["min_sigma_eff"]),
        enable_audit=bool(a["enable_audit"]),
    )


def _opt_arr(v, dtype):
    return None if v is None else np.asarray(v, dtype)


def _r_create_session(st: HypervisorState, a: dict) -> None:
    st.create_session(a["sid"], _session_config(a), now=a["now"])


def _r_create_sessions_batch(st: HypervisorState, a: dict) -> None:
    st.create_sessions_batch(a["sids"], _session_config(a))


def _r_enqueue_join(st: HypervisorState, a: dict) -> None:
    st.enqueue_join(
        int(a["session_slot"]), a["did"], float(a["sigma_raw"]),
        trustworthy=bool(a["trustworthy"]),
    )


def _r_flush_joins(st: HypervisorState, a: dict) -> None:
    pad_to = a.get("pad_to")
    st.flush_joins(
        now=float(a["now"]),
        pad_to=None if pad_to is None else int(pad_to),
    )


def _r_governance_wave(st: HypervisorState, a: dict) -> None:
    st.run_governance_wave(
        np.asarray(a["session_slots"], np.int32),
        list(a["dids"]),
        np.asarray(a["agent_sessions"], np.int32),
        np.asarray(a["sigma_raw"], np.float32),
        np.asarray(a["delta_bodies"], np.uint32),
        now=float(a["now"]),
        omega=float(a["omega"]),
        trustworthy=_opt_arr(a.get("trustworthy"), bool),
        actions=(
            None
            if a.get("actions") is None
            else {k: np.asarray(v) for k, v in a["actions"].items()}
        ),
        # Bucket padding must replay identically: the padded wave claimed
        # agent rows for its pad lanes too.
        pad_to=(
            None
            if a.get("pad_to") is None
            else (int(a["pad_to"][0]), int(a["pad_to"][1]))
        ),
    )


def _r_stage_delta(st: HypervisorState, a: dict) -> None:
    st.stage_delta(
        int(a["session_slot"]), int(a["agent_slot"]), ts=float(a["ts"]),
        change_words=_opt_arr(a.get("change_words"), np.uint32),
        digest_words=_opt_arr(a.get("digest_words"), np.uint32),
    )


def _r_flush_deltas(st: HypervisorState, a: dict) -> None:
    st.flush_deltas()


def _r_create_saga(st: HypervisorState, a: dict) -> None:
    st.create_saga(a["saga_id"], int(a["session_slot"]), a["steps"])


def _r_fanout_groups(st: HypervisorState, a: dict) -> None:
    st._fanout_groups[int(a["slot"])] = [
        (int(policy), [int(i) for i in idxs]) for policy, idxs in a["groups"]
    ]


def _r_saga_round(st: HypervisorState, a: dict) -> None:
    st.saga_round(
        {int(k): bool(v) for k, v in (a.get("exec") or {}).items()},
        {int(k): bool(v) for k, v in (a.get("undo") or {}).items()},
    )


def _r_fanout_settle(st: HypervisorState, a: dict) -> None:
    st.fanout_settle(
        {(int(s), int(i)): bool(ok) for s, i, ok in a["outcomes"]}
    )


def _r_gateway_wave(st: HypervisorState, a: dict) -> None:
    st.check_actions_wave(
        np.asarray(a["slots"], np.int32),
        np.asarray(a["required_rings"], np.int8),
        np.asarray(a["is_read_only"], bool),
        np.asarray(a["has_consensus"], bool),
        np.asarray(a["has_sre_witness"], bool),
        np.asarray(a["host_tripped"], bool),
        now=float(a["now"]),
    )


def _r_apply_slash(st: HypervisorState, a: dict) -> None:
    st.apply_slash(
        int(a["session_slot"]), int(a["vouchee_slot"]),
        float(a["risk_weight"]), now=float(a["now"]),
    )


def _r_terminate(st: HypervisorState, a: dict) -> None:
    st.terminate_sessions(
        [int(s) for s in a["session_slots"]], now=float(a["now"]),
    )


def _r_add_vouch(st: HypervisorState, a: dict) -> None:
    st.add_vouch(
        int(a["voucher_slot"]), int(a["vouchee_slot"]),
        int(a["session_slot"]), float(a["bond"]),
        bond_pct=float(a["bond_pct"]), expiry=float(a["expiry"]),
    )


def _r_release_vouch(st: HypervisorState, a: dict) -> None:
    st.release_vouch(int(a["edge_row"]))


def _r_leave_agent(st: HypervisorState, a: dict) -> None:
    st.leave_agent(int(a["session_slot"]), a["did"])


def _r_set_session_state(st: HypervisorState, a: dict) -> None:
    st.set_session_state(int(a["slot"]), SessionState(a["state"]))


def _r_force_session_mode(st: HypervisorState, a: dict) -> None:
    st.force_session_mode(
        int(a["slot"]), ConsistencyMode(a["mode"]),
        has_nonreversible=bool(a["has_nonreversible"]),
    )


def _r_grant_elevation(st: HypervisorState, a: dict) -> None:
    st.grant_elevation(
        int(a["agent_slot"]), int(a["granted_ring"]), now=float(a["now"]),
        ttl_seconds=a.get("ttl_seconds"),
    )


def _r_revoke_elevation(st: HypervisorState, a: dict) -> None:
    st.revoke_elevation(int(a["row"]), expected_agent=a.get("expected_agent"))


def _r_elevation_tick(st: HypervisorState, a: dict) -> None:
    st.elevation_tick(float(a["now"]))


def _r_quarantine_rows(st: HypervisorState, a: dict) -> None:
    st.quarantine_rows(
        [int(r) for r in a["rows"]], now=float(a["now"]),
        duration=a.get("duration"),
    )


def _r_quarantine_tick(st: HypervisorState, a: dict) -> None:
    st.quarantine_tick(float(a["now"]))


def _r_breach_sweep(st: HypervisorState, a: dict) -> None:
    st.breach_sweep_tick(float(a["now"]))


def _r_record_calls(st: HypervisorState, a: dict) -> None:
    st.record_calls(
        [int(s) for s in a["agent_slots"]],
        [int(r) for r in a["called_rings"]],
        now=float(a["now"]),
    )


def _r_consume_rate(st: HypervisorState, a: dict) -> None:
    st.consume_rate(
        [int(s) for s in a["slots"]], now=float(a["now"]),
        rings=None if a.get("rings") is None else [int(r) for r in a["rings"]],
    )


def _r_set_agent_ring(st: HypervisorState, a: dict) -> None:
    st.set_agent_ring(int(a["slot"]), int(a["ring"]), now=float(a["now"]))


def _r_set_agent_risk(st: HypervisorState, a: dict) -> None:
    st.set_agent_risk(int(a["slot"]), float(a["risk"]))


def _r_blacklist_rows(st: HypervisorState, a: dict) -> None:
    st.blacklist_rows([int(r) for r in a["rows"]])


def _r_free_edge_rows(st: HypervisorState, a: dict) -> None:
    st.free_edge_rows([int(r) for r in a["rows"]])


#: op name -> replay handler. Every journaled site in `state.py` has a
#: row here, and no row lacks a site (the port's tests walk both).
REPLAY: dict[str, Callable[[HypervisorState, dict], None]] = {
    "create_session": _r_create_session,
    "create_sessions_batch": _r_create_sessions_batch,
    "enqueue_join": _r_enqueue_join,
    "flush_joins": _r_flush_joins,
    "governance_wave": _r_governance_wave,
    "stage_delta": _r_stage_delta,
    "flush_deltas": _r_flush_deltas,
    "create_saga": _r_create_saga,
    "register_fanout_groups": _r_fanout_groups,
    "saga_round": _r_saga_round,
    "fanout_settle": _r_fanout_settle,
    "gateway_wave": _r_gateway_wave,
    "apply_slash": _r_apply_slash,
    "terminate_sessions": _r_terminate,
    "add_vouch": _r_add_vouch,
    "release_vouch": _r_release_vouch,
    "leave_agent": _r_leave_agent,
    "set_session_state": _r_set_session_state,
    "force_session_mode": _r_force_session_mode,
    "grant_elevation": _r_grant_elevation,
    "revoke_elevation": _r_revoke_elevation,
    "elevation_tick": _r_elevation_tick,
    "quarantine_rows": _r_quarantine_rows,
    "quarantine_tick": _r_quarantine_tick,
    "breach_sweep_tick": _r_breach_sweep,
    "record_calls": _r_record_calls,
    "consume_rate": _r_consume_rate,
    "set_agent_ring": _r_set_agent_ring,
    "set_agent_risk": _r_set_agent_risk,
    "blacklist_rows": _r_blacklist_rows,
    "free_edge_rows": _r_free_edge_rows,
}


def replay(state: HypervisorState, records) -> int:
    """Re-execute committed WAL records against a restored state.

    Journaling, fault injection, degraded-mode policy, and the
    admission damper are disabled for the duration: the records
    already exist, chaos must not corrupt a replay, and neither a shed
    policy nor a freshly-tripped damper (a journaled join burst all
    lands at replay wall-clock, trivially exceeding any arrival-rate
    threshold) may refuse transitions that already committed. Returns
    ops replayed.
    """
    # The degraded-policy swap honours the state's policy lock even here:
    # a restore may re-enter replay on a live process where the damper
    # races the swap.
    policy_lock = getattr(state, "_policy_lock", None) or nullcontext()
    saved = (
        state.journal,
        state.fault_injector,
        state.degraded_policy,
        getattr(state, "admission_damper", None),
    )
    state.journal = None
    state.fault_injector = None
    with policy_lock:
        state.degraded_policy = None
    state.admission_damper = None
    n = 0
    try:
        for rec in records:
            handler = REPLAY.get(rec.op)
            if handler is None:
                raise RecoveryError(
                    f"WAL record seq {rec.seq} names unknown op "
                    f"{rec.op!r} — log written by a newer build?"
                )
            handler(state, rec.args)
            n += 1
    finally:
        state.journal = saved[0]
        state.fault_injector = saved[1]
        with policy_lock:
            state.degraded_policy = saved[2]
        state.admission_damper = saved[3]
    return n


# ── the restore sequence ─────────────────────────────────────────────


def recover(
    checkpoint_dir: str | Path,
    wal_path: Optional[str | Path] = None,
    config: HypervisorConfig = DEFAULT_CONFIG,
    attach_journal: bool = False,
    device: str | torch.device = "cuda",
) -> tuple[HypervisorState, dict]:
    """Newest durable checkpoint -> audit verification -> WAL replay, on
    `device` (it raises without CUDA unless `device` says the CPU).

    Returns (state, report). With `attach_journal=True` the WAL is
    reopened (torn tail truncated, seq numbering resumed) and attached
    to the recovered state so new dispatches keep journaling into the
    same file.
    """
    device = resolve_device(device)
    target = latest_durable_checkpoint(checkpoint_dir)
    if target is None:
        raise RecoveryError(
            f"no durable checkpoint (directory with a .done marker) "
            f"under {checkpoint_dir}"
        )
    state = restore_state(target, config, device=device)
    sessions_verified = verify_audit_heads(state)
    watermark = state._restored_wal_seq or 0
    replayed = 0
    torn_bytes = 0
    open_intents = 0
    if wal_path is not None and Path(wal_path).exists():
        s = scan(wal_path, after_seq=watermark)
        torn_bytes = s.torn_bytes
        open_intents = s.open_intents
        replayed = replay(state, s.committed)
        if replayed:
            state.metrics.inc(WAL_REPLAYED_OPS, replayed)
            state.health.emit_event(
                "wal_replayed",
                {
                    "records": replayed,
                    "watermark_seq": watermark,
                    "open_intents_skipped": open_intents,
                    "torn_tail_bytes": torn_bytes,
                    "checkpoint": str(target),
                },
            )
        if attach_journal:
            state.journal = WriteAheadLog(wal_path)
    report = {
        "checkpoint": str(target),
        "wal": None if wal_path is None else str(wal_path),
        "wal_watermark_seq": watermark,
        "wal_records_replayed": replayed,
        "wal_open_intents_skipped": open_intents,
        "wal_torn_tail_bytes": torn_bytes,
        "audit_sessions_verified": sessions_verified,
    }
    return state, report


def recover_tenant(
    bundle_dir: str | Path,
    tenant: int,
    config: HypervisorConfig = DEFAULT_CONFIG,
    attach_journal: bool = False,
    device: str | torch.device = "cuda",
) -> tuple[HypervisorState, dict]:
    """`recover()` over one tenant's namespace of a multi-tenant
    durability bundle, `<bundle>/tenant_<t>/{wal.log, step_<N>/}`: the
    newest durable checkpoint of that tenant, audit-head verification,
    and its committed-WAL suffix replayed through the solo REPLAY
    handlers, onto a solo state on `device`.
    """
    device = resolve_device(device)
    tdir = Path(bundle_dir) / f"tenant_{int(tenant)}"
    if not tdir.is_dir():
        raise RecoveryError(
            f"no durable namespace for tenant {tenant} under {bundle_dir}"
        )
    wal_path = tdir / "wal.log"
    state, report = recover(
        tdir,
        wal_path if wal_path.exists() else None,
        config=config,
        attach_journal=attach_journal,
        device=device,
    )
    report["tenant"] = int(tenant)
    return state, report


__all__ = [
    "REPLAY",
    "RecoveryError",
    "WalRecord",
    "checkpoint_with_watermark",
    "latest_durable_checkpoint",
    "recover",
    "recover_tenant",
    "replay",
    "step_checkpoints",
    "verify_audit_heads",
]
