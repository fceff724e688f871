"""The state-integrity plane: sampling, detection, repair, escalation.

The torch counterpart of `hypervisor_tpu.integrity.plane`.
`IntegrityPlane(state)` attaches like the Supervisor: it publishes
itself as `state.integrity`, after which the state's dispatch gate
(`HypervisorState._predispatch`) calls `on_dispatch` at every wave
dispatch site. Every `HV_INTEGRITY_EVERY` dispatches the plane runs the
sanitizer (`invariants.check_invariants`, on the state's device; its
escrow through the contribution kernel on CUDA) — queued work whose
counts land in the metrics table and ride the next drain; no extra read
on the clean path. At the facade wave's gate the check folds into the
wave itself (`ops.pipeline.governance_wave(sanitize=True)`). When
`HV_SCRUB_EVERY` > 0 the
Merkle scrubber ticks on the same cadence-counter (each tick verifies a
budgeted strip of the DeltaLog chain: kernel B1 on CUDA).

Detection closes at the drain: `HypervisorState.metrics_snapshot()`
calls `observe_snapshot`, and a nonzero `hv_integrity_violation_rows`
gauge marks the plane dirty. The NEXT dispatch gate (or an explicit
`sanitize()`) then pulls the device-resident masks — the plane's one
deliberate sync, paid only when something is wrong — and walks the
escalation ladder:

  1. **repair** — deterministic in-place fixes (clamp sigma, recompute
     rings, mask flags, clamp token buckets / participant counts),
  2. **contain** — quarantine corrupt membership rows through the
     existing liability quarantine path; deactivate corrupt vouch
     edges and elevation grants,
  3. **restore** — FSM-code damage, escrow-conservation breaks,
     ring-cursor/turn-chain damage, and every scrub mismatch escalate
     to `Supervisor.restore_state()` (newest durable checkpoint +
     committed-WAL replay, on the state's own device). Without a
     supervisor wired for restore the
     plane raises `IntegrityError` — corruption it cannot fix must
     never be silently served.

`HV_INTEGRITY_LADDER=restore` forces EVERY violation up the restore
rung (the corruption-drill posture: the restored state is bit-identical
to the uninterrupted history, where an in-place clamp is merely legal).

All violations/repairs/restores fan out through the health monitor's
listener set (kinds `integrity_violation`, `scrub_mismatch`,
`row_quarantined`, `state_restored`), which the facade bridges onto the
event bus as the append-only `integrity.*` EventTypes.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from hypervisor_tpu_torch.integrity import invariants as inv
from hypervisor_tpu_torch.integrity.scrubber import MerkleScrubber
from hypervisor_tpu_torch.observability import health as health_plane
from hypervisor_tpu_torch.observability import metrics as metrics_plane

_CHECK_INVARIANTS = health_plane.instrument(
    "integrity_check", inv.check_invariants, static_argnames=("config",),
)
_REPAIR_AGENTS = health_plane.instrument(
    "integrity_repair_agents", inv.repair_agents, static_argnames=("config",),
)
_REPAIR_SESSIONS = health_plane.instrument(
    "integrity_repair_sessions", inv.repair_sessions
)
_REPAIR_VOUCHES = health_plane.instrument(
    "integrity_repair_vouches", inv.repair_vouches
)
_REPAIR_ELEVATIONS = health_plane.instrument(
    "integrity_repair_elevations", inv.repair_elevations
)


class IntegrityError(RuntimeError):
    """Restore-class corruption with no restore path wired."""


class StateRestoredError(IntegrityError):
    """Raised from a dispatch gate AFTER a successful restore: the
    state object the caller dispatched against was replaced (its
    tables were corrupt), so the in-flight wave was refused BEFORE any
    mutation — re-issue it against `supervisor.state`. Nothing
    committed was lost: the refused wave never journaled an intent."""


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    try:
        return int(raw) if raw is not None else default
    except ValueError:
        return default


def _mask_detail(mask: np.ndarray, table: str) -> list[dict]:
    """[(row, [check names])] for the nonzero rows of one table mask."""
    out = []
    for row in np.nonzero(mask)[0][:32]:  # cap payloads; counts are exact
        bits = int(mask[row])
        names = [
            name
            for t, name, _klass, bit in inv.CATALOG
            if t == table and bits & bit
        ]
        out.append({"row": int(row), "checks": names})
    return out


class IntegrityPlane:
    """One deployment's state-integrity plane over a `HypervisorState`."""

    def __init__(
        self,
        state,
        *,
        every: Optional[int] = None,
        scrub_every: Optional[int] = None,
        scrub_budget: Optional[int] = None,
        ladder: Optional[str] = None,
        quarantine_duration: Optional[float] = None,
    ) -> None:
        self.state = state
        self.every = (
            every if every is not None else _env_int("HV_INTEGRITY_EVERY", 8)
        )
        self.scrub_every = (
            scrub_every
            if scrub_every is not None
            else _env_int("HV_SCRUB_EVERY", 0)
        )
        self.ladder = (
            ladder
            if ladder is not None
            else os.environ.get("HV_INTEGRITY_LADDER", "repair")
        )
        if self.ladder not in ("repair", "restore"):
            raise ValueError(f"unknown ladder policy {self.ladder!r}")
        self.quarantine_duration = (
            quarantine_duration
            if quarantine_duration is not None
            else state.config.quarantine.default_duration_seconds
        )
        self.scrubber = MerkleScrubber(state, budget=scrub_budget)

        self._lock = threading.Lock()
        self._dispatches = 0
        self._pending = False           # drain saw a nonzero gauge
        self._fused_due = False         # cadence armed a fused-wave check
        self._last_result = None        # device-resident IntegrityResult
        self._last_check_dispatch = 0
        self.checks = 0
        self.violations_seen = 0
        self.repairs = 0
        self.rows_quarantined = 0
        self.restores = 0
        self.scrub_mismatches = 0
        self.last_violations: list[dict] = []
        self.last_repair: Optional[dict] = None
        self.last_restore: Optional[dict] = None
        state.integrity = self

    def retune(
        self,
        every: Optional[int] = None,
        scrub_every: Optional[int] = None,
    ) -> dict:
        """Retune the sanitizer/scrub cadence live and return the
        before/after knob values. Cadence checks read `self.every` per
        dispatch, so the new pace applies from the next wave; 0 still
        means off. The autopilot tightens on violation deltas and
        relaxes after a clean-window streak with roofline headroom."""
        before = {"every": self.every, "scrub_every": self.scrub_every}
        with self._lock:
            if every is not None:
                self.every = max(0, int(every))
            if scrub_every is not None:
                self.scrub_every = max(0, int(scrub_every))
        return {
            "before": before,
            "after": {"every": self.every, "scrub_every": self.scrub_every},
        }

    # -- the dispatch-site gate -----------------------------------------

    def on_dispatch(self, stage: str, fused: bool = False) -> None:
        """Cadence hook at every wave dispatch site (host-side, before
        the wave): settle any drain-flagged damage first — a known-dirty
        table must not serve one more wave — then maybe sample.

        `fused`: the upcoming dispatch is a fused governance wave that
        can fold the sanitizer into its own program — a cadence hit
        arms `_fused_due` (the bridge consumes it via `take_fused_due`
        and dispatches the sanitize=True wave variant, then hands the
        masks back through `absorb_fused`) instead of dispatching
        `check_invariants` separately. Same cadence, same masks, zero
        extra dispatch steps.

        If settling (or a paced scrub) escalates to a restore, the
        in-flight dispatch is refused with `StateRestoredError` BEFORE
        it mutates anything: the state object it targeted was replaced.
        Re-issue the wave against `supervisor.state`.
        """
        with self._lock:
            pending = self._pending
            self._dispatches += 1
            n = self._dispatches
        if pending:
            report = self.sanitize()
            if report.get("restored"):
                raise StateRestoredError(
                    f"state restored before {stage} dispatch (corrupt "
                    "tables replaced) — re-issue against supervisor.state"
                )
        if self.every > 0 and n % self.every == 0:
            if fused:
                with self._lock:
                    self._fused_due = True
            else:
                self._run_check()
        if self.scrub_every > 0 and n % self.scrub_every == 0:
            report = self.scrub_tick()
            if report.get("restored"):
                raise StateRestoredError(
                    f"state restored before {stage} dispatch (Merkle "
                    "scrub mismatch) — re-issue against supervisor.state"
                )

    def _run_check(self):
        """Queue the sanitizer on the state's device; NO host sync —
        counts ride the metrics table (booked in place) into the next
        drain, masks stay on the device."""
        st = self.state
        result = _CHECK_INVARIANTS(
            st.agents,
            st.sessions,
            st.vouches,
            st.sagas,
            st.elevations,
            st.delta_log,
            st.event_log,
            st.tracer.table,
            st.config.rate_limit.ring_bursts,
            metrics=st.metrics.table,
            config=st.config,
        )
        with self._lock:
            self.checks += 1
            self._last_result = result
            self._last_check_dispatch = self._dispatches
        return result

    # -- the fused-wave variant -----------------------------------------

    def take_fused_due(self) -> bool:
        """Consume the fused-sanitizer arming (`on_dispatch(fused=True)`
        set it): True exactly once per cadence hit — the bridge then
        dispatches the wave's sanitize=True variant."""
        with self._lock:
            due, self._fused_due = self._fused_due, False
        return due

    def absorb_fused(self, result) -> None:
        """Book a sanitizer pass that rode the fused wave: `result` is
        `WaveResult.sanitizer` (an IntegrityResult — the counts already
        rode the wave's metrics table, in place). Masks stay device-resident exactly as `_run_check`
        leaves them; detection still closes at the drain."""
        if result is None:
            return
        with self._lock:
            self.checks += 1
            self._last_result = result
            self._last_check_dispatch = self._dispatches

    # -- drain-side detection -------------------------------------------

    def observe_snapshot(self, snap) -> None:
        """Metrics-drain hook: a nonzero violation gauge marks the
        plane dirty; the next dispatch gate (or an explicit
        `sanitize()`) settles it. Pure host arithmetic on the snapshot
        the drain already pulled."""
        if snap.gauge(metrics_plane.INTEGRITY_VIOLATION_ROWS) > 0:
            with self._lock:
                self._pending = True

    # -- the synchronous path (detection -> ladder) ----------------------

    def sanitize(self, now: Optional[float] = None) -> dict:
        """Run one check NOW, pull the masks, walk the ladder.

        The plane's one deliberate device sync: the masks and counts come
        back as ONE copy of their concatenation. Returns the report
        (violations by table, repairs applied, restore escalation).
        """
        st = self.state
        # Repairs rewrite tables outside the journal/dispatch gates: the
        # fused-epilogue gauge rows may go stale here.
        st._gauges_fresh = False
        result = self._run_check()
        parts = (
            result.agent_mask, result.session_mask, result.vouch_mask,
            result.saga_mask, result.elev_mask, result.log_mask,
            result.total.reshape(1), result.unrepairable.reshape(1),
        )
        flat = torch.cat([p.reshape(-1).to(torch.int32) for p in parts]).cpu().numpy()
        splits = np.cumsum([p.numel() for p in parts])[:-1]
        (agent_m, session_m, vouch_m, saga_m, elev_m, log_m,
         total, unrepairable) = np.split(flat, splits)
        total, unrepairable = total[0], unrepairable[0]
        total = int(total)
        unrepairable = int(unrepairable)
        with self._lock:
            self._pending = False
            self.violations_seen += total
        report = {
            "total": total,
            "unrepairable": unrepairable,
            "violations": {},
            "repaired_rows": 0,
            "quarantined_rows": 0,
            "restored": False,
        }
        if total == 0:
            return report

        detail = {
            name: rows
            for name, rows in (
                ("agents", _mask_detail(agent_m, "agents")),
                ("sessions", _mask_detail(session_m, "sessions")),
                ("vouches", _mask_detail(vouch_m, "vouches")),
                ("sagas", _mask_detail(saga_m, "sagas")),
                ("elevations", _mask_detail(elev_m, "elevations")),
                ("logs", _mask_detail(log_m, "logs")),
            )
            if rows
        }
        report["violations"] = detail
        with self._lock:
            self.last_violations = [
                {"table": t, **row} for t, rows in detail.items()
                for row in rows
            ]
        st.health.emit_event(
            "integrity_violation",
            {
                "total": total,
                "unrepairable": unrepairable,
                "violations": detail,
                "dispatch": self._dispatches,
            },
        )
        if unrepairable > 0 or self.ladder == "restore":
            report["restored"] = self._escalate_restore(
                f"{total} integrity violation(s), {unrepairable} "
                "restore-class"
            )
            return report
        repaired, quarantined = self._repair(
            agent_m, session_m, vouch_m, elev_m,
            now=st.now() if now is None else now,
        )
        # Re-check so the drained gauge reflects the repaired tables
        # (async — the recheck's counts ride the next drain like any
        # sampled pass; a clean recheck also stops re-flagging).
        self._run_check()
        report["repaired_rows"] = repaired
        report["quarantined_rows"] = quarantined
        return report

    def _repair(
        self, agent_m, session_m, vouch_m, elev_m, now: float
    ) -> tuple[int, int]:
        """The repair/contain rungs: deterministic fixes through
        `invariants.repair_*` on the state's device, written back into
        the state's tables in place.

        Returns (repaired_rows, quarantined_rows) — ONE accounting rule
        for the report, `hv_integrity_repairs_total`, and
        `hv_integrity_rows_quarantined_total`: a row counts as repaired
        when something was fixed IN PLACE (clamp/recompute/mask on
        agents/sessions, edge/grant deactivation); a contain-only agent
        row counts as quarantined, not repaired.
        """
        st = self.state
        repaired = int(
            ((agent_m & inv.REPAIRABLE_AGENT_BITS) != 0).sum()
            + ((session_m & inv.REPAIRABLE_SESSION_BITS) != 0).sum()
            + ((vouch_m & inv.CONTAIN_VOUCH_BITS) != 0).sum()
            + ((elev_m & inv.E_RANGE) != 0).sum()
        )
        quarantined = int(((agent_m & inv.CONTAIN_AGENT_BITS) != 0).sum())
        def put(mask):
            return torch.from_numpy(np.ascontiguousarray(mask)).to(st.device)

        def write_back(table, repaired):
            for f in dataclasses.fields(table):
                getattr(table, f.name).copy_(getattr(repaired, f.name))

        if agent_m.any():
            write_back(st.agents, _REPAIR_AGENTS(
                st.agents,
                put(agent_m),
                st.config.rate_limit.ring_bursts,
                now,
                self.quarantine_duration,
                config=st.config,
            ))
        if session_m.any():
            write_back(st.sessions, _REPAIR_SESSIONS(st.sessions, put(session_m)))
        if vouch_m.any():
            write_back(st.vouches, _REPAIR_VOUCHES(st.vouches, put(vouch_m)))
        if elev_m.any():
            write_back(st.elevations, _REPAIR_ELEVATIONS(st.elevations, put(elev_m)))
        with self._lock:
            self.repairs += repaired
            self.rows_quarantined += quarantined
            self.last_repair = {
                "rows": repaired,
                "quarantined": quarantined,
                "at": time.time(),
            }
        if repaired:
            st.metrics.inc(metrics_plane.INTEGRITY_REPAIRS, repaired)
        if quarantined:
            st.metrics.inc(
                metrics_plane.INTEGRITY_ROWS_QUARANTINED, quarantined
            )
            st.health.emit_event(
                "row_quarantined",
                {
                    "rows": int(quarantined),
                    "reason": "integrity containment (corrupt session ref)",
                },
            )
        return repaired, quarantined

    # -- scrubbing -------------------------------------------------------

    def scrub_tick(self) -> dict:
        """One budgeted scrubber strip; mismatches escalate (restore)."""
        report = self.scrubber.tick()
        st = self.state
        if report["links"] or report["heads"]:
            st.metrics.inc(
                metrics_plane.INTEGRITY_SCRUB_LINKS,
                report["links"] + report["heads"],
            )
        if report["mismatches"]:
            n = len(report["mismatches"])
            with self._lock:
                self.scrub_mismatches += n
            st.metrics.inc(metrics_plane.INTEGRITY_SCRUB_MISMATCHES, n)
            st.health.emit_event(
                "scrub_mismatch",
                {"mismatches": report["mismatches"], "count": n},
            )
            report["restored"] = self._escalate_restore(
                f"{n} Merkle scrub mismatch(es): the DeltaLog chain no "
                "longer re-hashes to its committed digests"
            )
        return report

    # -- restore escalation ---------------------------------------------

    def _escalate_restore(self, reason: str) -> bool:
        """The ladder's last rung: checkpoint + committed-WAL replay.

        Needs a Supervisor wired with a checkpoint_dir and a journal;
        without one the plane raises — restore-class damage must never
        be served silently.
        """
        st = self.state
        sup = st.resilience
        if sup is None or not getattr(sup, "can_restore", lambda: False)():
            # Escalation triggered but impossible: count it, keep the
            # plane DIRTY (every later gate must refuse again — known
            # corruption is never silently served), and raise.
            with self._lock:
                self._pending = True
            st.metrics.inc(metrics_plane.INTEGRITY_RESTORES)
            raise IntegrityError(
                f"unrepairable state corruption ({reason}) and no "
                "supervisor restore path wired — attach a "
                "resilience.Supervisor with checkpoint_dir + WAL to "
                "enable the restore rung"
            )
        try:
            sup.restore_state(reason)
        except Exception:
            with self._lock:
                self._pending = True  # still corrupt; keep refusing
            raise
        # Book the restore only once it SUCCEEDED, on the surviving
        # metrics plane (the corrupt state's plane died with it; the
        # supervisor rebinds this plane onto the recovered state).
        with self._lock:
            self.restores += 1
            self.last_restore = {"reason": reason, "at": time.time()}
        self.state.metrics.inc(metrics_plane.INTEGRITY_RESTORES)
        return True

    # -- re-attachment after a restore -----------------------------------

    def attach(self, state) -> None:
        """Move this plane onto a recovered state (cumulative stats
        survive; sweep/sample cursors reset — the new tables deserve a
        fresh sweep)."""
        with self._lock:
            self.state = state
            self._pending = False
            self._last_result = None
        old = self.scrubber
        self.scrubber = MerkleScrubber(state, budget=old.budget)
        self.scrubber.adopt_stats(old)
        state.integrity = self

    # -- the /debug/integrity payload ------------------------------------

    def summary(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "sampling": {
                    "every": self.every,
                    "dispatches": self._dispatches,
                    "checks": self.checks,
                    "last_check_dispatch": self._last_check_dispatch,
                    "pending": self._pending,
                },
                "ladder": self.ladder,
                "violations_seen": self.violations_seen,
                "last_violations": self.last_violations[-8:],
                "repairs": {
                    "rows_repaired": self.repairs,
                    "rows_quarantined": self.rows_quarantined,
                    "last": self.last_repair,
                },
                "restores": {
                    "count": self.restores,
                    "last": self.last_restore,
                },
                "scrub": {
                    **self.scrubber.summary(),
                    "every": self.scrub_every,
                    "escalated_mismatches": self.scrub_mismatches,
                },
                "catalog": [
                    {"table": t, "check": name, "action": klass}
                    for t, name, klass, _bit in inv.CATALOG
                ],
            }
