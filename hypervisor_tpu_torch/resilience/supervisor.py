"""Degraded-mode supervisor: detection -> bounded retry -> shedding.

The torch counterpart of `hypervisor_tpu.resilience.supervisor`. The
health plane *detects* (watchdog stragglers, capacity warnings,
recompiles); this loop *acts*. The supervisor wraps wave dispatches in
bounded retry-with-exponential-backoff, subscribes to the deployment's
`HealthMonitor` for straggler/capacity pressure, and past thresholds
flips the degraded-mode policy onto the state (`resilience.policy`):
new admissions shed, saga fan-out pauses, terminations and audit
commits keep flowing. Enter/exit fan out through the health monitor's
listener set, so the facade bridges them onto the event bus
(`resilience.degraded_entered` / `resilience.degraded_exited`) exactly
like straggler events — and `/debug/resilience` serves `summary()` on
both API transports.

Retry scope is deliberate: by default only injected chaos faults
(`testing.chaos.InjectedWaveFault`) retry — the one class guaranteed
to fire before any mutation, so a re-dispatch cannot double-apply
(widen via `retryable=` only for paths known to fail pre-mutation).
`InjectedDeviceLoss` (the simulated preemption) never retries:
a lost device needs `recovery.recover`, and retrying against dead
buffers would convert one clean failure into undefined behavior; it
counts as an immediate degraded trigger and re-raises. Nothing else is
caught on the dispatch path: a CUDA error, a failed kernel build or a
refused launch propagates as it was raised. The restore rung recovers
onto the state's own device (`recovery.recover(device=...)`).

Knobs (env, read at construction): `HV_SUP_MAX_RETRIES` (default 4),
`HV_SUP_BACKOFF_S` (base backoff, default 0.02), `HV_SUP_DEGRADE_FAILS`
(consecutive exhausted dispatches before degrading, default 2),
`HV_SUP_DEGRADE_STRAGGLERS` / `HV_SUP_DEGRADE_CAPACITY` (health-event
pressure thresholds, defaults 4 / 2), `HV_SUP_EXIT_CLEAN` (clean
dispatches to exit degraded mode, default 8), `HV_SUP_DEGRADE_SLO`
(flip degraded mode on a CRITICAL SLO burn-rate alert from the latency
observatory — `observability.slo` fans `slo_burn_critical` through the
same listener set — default 1; 0 leaves the SLO plane observe-only).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Optional

import torch

from hypervisor_tpu_torch.observability import metrics as metrics_plane
from hypervisor_tpu_torch.resilience.policy import DegradedPolicy
from hypervisor_tpu_torch.testing.chaos import InjectedDeviceLoss, InjectedWaveFault


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    try:
        return float(raw) if raw is not None else default
    except ValueError:
        return default


#: Dispatch exceptions worth a retry. The default is ONLY the injected
#: chaos fault, because it is the one class guaranteed to fire BEFORE a
#: wave mutates anything (the `_chaos` gate contract) — re-running is
#: provably safe. A real TimeoutError/OSError can surface AFTER the
#: mutation committed (e.g. the WAL commit append failing on a full
#: disk), and retrying a committed wave double-applies it. Operators
#: who know their dispatch path fails pre-mutation can widen the set
#: via `Supervisor(retryable=...)`.
RETRYABLE: tuple[type, ...] = (InjectedWaveFault,)


def _device_fault(e: BaseException) -> bool:
    """A fault of the card itself (a CUDA error surfacing through torch):
    never swallowed, not even by a periodic checkpoint."""
    accel = getattr(torch, "AcceleratorError", None)
    return (accel is not None and isinstance(e, accel)) or "CUDA error" in str(e)


class Supervisor:
    """One deployment's recovery loop over a `HypervisorState`.

    Attach is explicit: `Supervisor(state)` hooks the state's health
    monitor and publishes itself as `state.resilience` (what
    `/debug/resilience` serves). Dispatch through `dispatch()` to get
    retry + degraded accounting; direct state calls still work and
    still honour the active shed policy.
    """

    def __init__(
        self,
        state,
        *,
        max_retries: Optional[int] = None,
        backoff_base_s: Optional[float] = None,
        backoff_cap_s: float = 2.0,
        degrade_after_failures: Optional[int] = None,
        degrade_after_stragglers: Optional[int] = None,
        degrade_after_capacity: Optional[int] = None,
        degrade_after_comp_backlog: Optional[int] = None,
        degrade_on_slo_critical: Optional[bool] = None,
        exit_after_clean: Optional[int] = None,
        policy: Optional[DegradedPolicy] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        retryable: tuple[type, ...] = RETRYABLE,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self.state = state
        self.max_retries = (
            max_retries
            if max_retries is not None
            else int(_env_float("HV_SUP_MAX_RETRIES", 4))
        )
        self.backoff_base_s = (
            backoff_base_s
            if backoff_base_s is not None
            else _env_float("HV_SUP_BACKOFF_S", 0.02)
        )
        self.backoff_cap_s = backoff_cap_s
        self.degrade_after_failures = (
            degrade_after_failures
            if degrade_after_failures is not None
            else int(_env_float("HV_SUP_DEGRADE_FAILS", 2))
        )
        self.degrade_after_stragglers = (
            degrade_after_stragglers
            if degrade_after_stragglers is not None
            else int(_env_float("HV_SUP_DEGRADE_STRAGGLERS", 4))
        )
        self.degrade_after_capacity = (
            degrade_after_capacity
            if degrade_after_capacity is not None
            else int(_env_float("HV_SUP_DEGRADE_CAPACITY", 2))
        )
        # Compensation-storm backpressure: `state.saga_work` emits a
        # `comp_backlog` health event when the COMPENSATING backlog
        # crosses its warn line; at/above this threshold the supervisor
        # flips degraded mode (fan-out pauses, admissions shed) so the
        # backlog drains before new load piles on.
        self.degrade_after_comp_backlog = (
            degrade_after_comp_backlog
            if degrade_after_comp_backlog is not None
            else int(_env_float("HV_SUP_DEGRADE_COMP", 64))
        )
        # SLO burn-rate escalation: a CRITICAL multi-window
        # burn alert means the error budget is being spent 14x+ faster
        # than sustainable on BOTH confirmation windows — degrading NOW
        # sheds new load before any ingestion queue hard-fills, instead
        # of discovering the overload at the next bench round.
        self.degrade_on_slo_critical = (
            degrade_on_slo_critical
            if degrade_on_slo_critical is not None
            else _env_float("HV_SUP_DEGRADE_SLO", 1.0) != 0.0
        )
        self.exit_after_clean = (
            exit_after_clean
            if exit_after_clean is not None
            else int(_env_float("HV_SUP_EXIT_CLEAN", 8))
        )
        self._policy_template = policy or DegradedPolicy()
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.checkpoint_keep = 3
        # Optional publication gate consulted before EVERY checkpoint
        # save: raising refuses publication with nothing written. The
        # failover plane hangs its fencing check here
        # (`fleet.failover.WorkerDurability.check_fence`) so a
        # stale-epoch zombie's periodic checkpoint can never earn a
        # `.done` marker a recovery would trust.
        self.checkpoint_gate = None
        self.retryable = retryable
        self.sleep = sleep

        self._lock = threading.Lock()
        self.dispatches = 0
        self.retries = 0
        self.failed_dispatches = 0
        self.device_losses = 0
        self.degraded_entries = 0
        self.degraded_exits = 0
        self._fail_streak = 0
        self._clean_streak = 0
        self._straggler_pressure = 0
        self._capacity_pressure = 0
        self._comp_backlog = 0
        self.comp_backpressure_entries = 0
        self.slo_critical_alerts = 0
        self.slo_degraded_entries = 0
        self.last_slo_alert: Optional[dict] = None
        self.last_error: Optional[str] = None
        self.recovery_latencies_ms: deque[float] = deque(maxlen=256)
        self.last_checkpoint: Optional[dict] = None
        self.checkpoints_skipped = 0
        self.last_checkpoint_error: Optional[str] = None
        self.state_restores = 0
        self.last_restore: Optional[dict] = None
        self._since_checkpoint = 0
        # Resume the step counter past whatever an earlier life wrote
        # (markerless dirs included — a torn save's slot is burned, not
        # reused): each save gets a FRESH step directory, so the
        # previous durable checkpoint's .done is never retracted while
        # the new one is still being written (a crash mid-save must
        # leave recover() something durable to restore).
        self._ckpt_step = 0
        if checkpoint_dir:
            from hypervisor_tpu_torch.resilience.recovery import step_checkpoints

            self._ckpt_step = max(
                (s for s, _ in step_checkpoints(checkpoint_dir)), default=0
            )

        state.resilience = self
        state.health.add_listener(self._on_health_event)

    # -- dispatch with bounded retry ------------------------------------

    def dispatch(self, stage: str, fn: Callable, *args, **kwargs):
        """Run one wave dispatch under the retry ladder.

        Transient faults retry with exponential backoff (base × 2^k,
        capped); exhaustion counts toward the degraded threshold and
        re-raises the last fault. A simulated device loss degrades
        immediately and re-raises without retry.
        """
        with self._lock:
            self.dispatches += 1
        fault_at: Optional[float] = None
        attempt = 0
        while True:
            try:
                out = fn(*args, **kwargs)
            except InjectedDeviceLoss as e:
                with self._lock:
                    self.device_losses += 1
                    self.last_error = f"{stage}: {e}"
                self._enter_degraded(f"device loss during {stage}")
                raise
            except self.retryable as e:
                if fault_at is None:
                    fault_at = time.perf_counter()
                attempt += 1
                with self._lock:
                    self.retries += 1
                    self.last_error = f"{stage}: {e}"
                self.state.metrics.inc(metrics_plane.DISPATCH_RETRIES)
                if attempt > self.max_retries:
                    degrade = False
                    with self._lock:
                        self.failed_dispatches += 1
                        self._fail_streak += 1
                        self._clean_streak = 0
                        if self._fail_streak >= self.degrade_after_failures:
                            degrade = True
                    self.state.metrics.inc(metrics_plane.DISPATCH_FAILURES)
                    if degrade:
                        self._enter_degraded(
                            f"{self._fail_streak} consecutive {stage} "
                            "dispatches exhausted their retry budget"
                        )
                    raise
                self.state.health.emit_event(
                    "dispatch_retry",
                    {
                        "stage": stage,
                        "attempt": attempt,
                        "max_retries": self.max_retries,
                        "error": str(e),
                    },
                )
                self.sleep(
                    min(
                        self.backoff_base_s * (2 ** (attempt - 1)),
                        self.backoff_cap_s,
                    )
                )
                continue
            if fault_at is not None:
                self.recovery_latencies_ms.append(
                    (time.perf_counter() - fault_at) * 1e3
                )
            self._note_clean()
            self._maybe_checkpoint()
            return out

    def _note_clean(self) -> None:
        exit_now = False
        with self._lock:
            self._fail_streak = 0
            self._clean_streak += 1
            if (
                self.state.degraded_policy is not None
                and self._clean_streak >= self.exit_after_clean
            ):
                exit_now = True
        if exit_now:
            self._exit_degraded()

    # -- health-plane pressure ------------------------------------------

    def _on_health_event(self, kind: str, payload: dict) -> None:
        """HealthMonitor listener: stragglers and capacity warnings are
        pressure toward degraded mode (recompiles are routine)."""
        reason = None
        with self._lock:
            if kind == "straggler":
                self._straggler_pressure += 1
                if self._straggler_pressure >= self.degrade_after_stragglers:
                    reason = (
                        f"{self._straggler_pressure} wave stragglers since "
                        "last recovery"
                    )
            elif kind == "capacity":
                self._capacity_pressure += 1
                if self._capacity_pressure >= self.degrade_after_capacity:
                    reason = (
                        f"{self._capacity_pressure} capacity warnings since "
                        "last recovery"
                    )
            elif kind == "slo_burn_critical":
                # The latency observatory's page-severity alert: the
                # class is burning budget 14x+ faster than sustainable
                # on both confirmation windows. Degrade BEFORE the
                # ingestion queues hard-fill (the whole point of
                # watching burn rate instead of queue depth).
                self.slo_critical_alerts += 1
                self.last_slo_alert = dict(payload)
                if self.degrade_on_slo_critical:
                    entering = self.state.degraded_policy is None
                    reason = (
                        f"SLO burn-rate critical on {payload.get('queue')}: "
                        f"fast {payload.get('burn_fast')}x / slow "
                        f"{payload.get('burn_slow')}x the error budget"
                    )
                    if entering:
                        self.slo_degraded_entries += 1
            elif kind == "comp_backlog":
                # Absolute, not cumulative: the event carries the LIVE
                # compensation backlog, so the pressure reading tracks
                # it (a draining storm de-pressurizes by itself).
                self._comp_backlog = int(payload.get("backlog", 0))
                if self._comp_backlog >= self.degrade_after_comp_backlog:
                    entering = self.state.degraded_policy is None
                    reason = (
                        f"compensation storm: {self._comp_backlog} sagas "
                        "compensating concurrently"
                    )
                    if entering:
                        self.comp_backpressure_entries += 1
        if reason is not None:
            self._enter_degraded(reason)

    # -- mode transitions ------------------------------------------------

    @property
    def degraded(self) -> bool:
        return self.state.degraded_policy is not None

    def _policy_lock(self):
        """The STATE's policy-swap lock — shared with the admission
        damper so check-and-swap on `degraded_policy` is atomic across
        both writers. States without one share the damper module's
        fallback (a per-call fresh Lock would serialize nothing)."""
        from hypervisor_tpu_torch.resilience.policy import _FALLBACK_POLICY_LOCK

        lock = getattr(self.state, "_policy_lock", None)
        return lock if lock is not None else _FALLBACK_POLICY_LOCK

    def _enter_degraded(self, reason: str) -> None:
        with self._lock, self._policy_lock():
            existing = self.state.degraded_policy
            if existing is not None and (
                existing.shed_admissions or existing.pause_saga_fanout
            ):
                return  # already fully degraded; first reason stands
            # A TARGETED policy (the sybil damper's sigma-floor shed —
            # neither full shed nor fanout pause) must not suppress
            # supervisor escalation: a comp-backlog storm or failure
            # streak outranks it, so the full policy replaces it (the
            # damper notices the swap and forgets its handle).
            policy = DegradedPolicy(
                shed_admissions=self._policy_template.shed_admissions,
                pause_saga_fanout=self._policy_template.pause_saga_fanout,
                reason=reason,
                entered_at=time.time(),
            )
            self.state.degraded_policy = policy
            self.degraded_entries += 1
            self._clean_streak = 0
        self.state.metrics.inc(metrics_plane.DEGRADED_ENTRIES)
        self.state.health.emit_event("degraded_enter", policy.to_dict())

    def _exit_degraded(self) -> None:
        with self._lock, self._policy_lock():
            policy = self.state.degraded_policy
            if policy is None:
                return
            if not (policy.shed_admissions or policy.pause_saga_fanout):
                # A TARGETED policy (the sybil damper's sigma-floor
                # shed) is not ours to clear: the damper uninstalls it
                # when ITS window cools. Clean dispatches during a
                # damped flood must not leak sybils one join at a time.
                return
            self.state.degraded_policy = None
            self.degraded_exits += 1
            self._straggler_pressure = 0
            self._capacity_pressure = 0
            self._comp_backlog = 0
        self.state.health.emit_event(
            "degraded_exit",
            {
                "reason": policy.reason,
                "entered_at": policy.entered_at,
                "degraded_s": round(time.time() - policy.entered_at, 3),
            },
        )

    def force_degraded(self, reason: str = "operator request") -> None:
        """Operator-forced shed (runbook escape hatch)."""
        self._enter_degraded(reason)

    def force_recovered(self) -> None:
        self._exit_degraded()

    # -- periodic checkpoints --------------------------------------------

    def _maybe_checkpoint(self) -> None:
        if not self.checkpoint_dir or self.checkpoint_every <= 0:
            return
        with self._lock:
            self._since_checkpoint += 1
            if self._since_checkpoint < self.checkpoint_every:
                return
            self._since_checkpoint = 0
        # A periodic checkpoint must never fail the dispatch that
        # triggered it: staged joins/deltas legitimately refuse a save
        # (`save_state`'s flush contract), and disk/permission errors
        # from the synchronous prelude are a checkpointing problem, not
        # the wave's — the wave already committed. Record the skip and
        # try again after the next `checkpoint_every` clean dispatches.
        try:
            self.checkpoint(background=True)
        except Exception as e:  # noqa: BLE001 — see contract above
            if _device_fault(e):
                raise
            with self._lock:
                self.checkpoints_skipped += 1
                self.last_checkpoint_error = str(e)

    def checkpoint(self, background: bool = False):
        """One watermarked checkpoint into `checkpoint_dir` (async by
        default on the periodic path — the orbax-style split that keeps
        ticks running during the disk write).

        Every save lands in a FRESH `step_<n>` directory and the oldest
        beyond `checkpoint_keep` are pruned first — re-targeting one
        directory would retract its `.done` before the write, leaving a
        crash-during-save with NOTHING durable to recover from.
        """
        from hypervisor_tpu_torch.resilience.recovery import (
            checkpoint_with_watermark,
        )

        if not self.checkpoint_dir:
            raise RuntimeError("supervisor has no checkpoint_dir configured")
        gate = self.checkpoint_gate
        if gate is not None:
            gate()  # a raise refuses publication; nothing was written
        with self._lock:
            self._ckpt_step += 1
            step = self._ckpt_step
        self._prune_checkpoints(keep=max(self.checkpoint_keep - 1, 1))
        target = checkpoint_with_watermark(
            self.state, self.checkpoint_dir, step=step, background=background
        )
        self.last_checkpoint = {
            "path": str(target),
            "step": step,
            "at": time.time(),
            "wal_seq": (
                self.state.journal.last_seq
                if self.state.journal is not None
                else None
            ),
        }
        return target

    # -- restore escalation (the integrity ladder's last rung) -----------

    def can_restore(self) -> bool:
        """True when the restore rung is wired: a checkpoint_dir to
        recover from and a journal whose committed suffix can replay."""
        return bool(self.checkpoint_dir) and self.state.journal is not None

    def restore_state(self, reason: str):
        """Rebuild the state from the newest durable checkpoint + the
        committed WAL suffix and take over supervising the result.

        The integrity plane escalates here when it finds restore-class
        corruption (chain mismatch, FSM-code damage, conservation
        break): the live tables can no longer be trusted, but the
        checkpoint + committed WAL are exactly the transitions the
        system promised — recovery lands bit-identical to an
        uninterrupted history at the same committed prefix.

        The supervisor rebinds itself (and any attached IntegrityPlane)
        onto the recovered state; the fault injector carries over (a
        chaos drill keeps its schedule), degraded mode clears (the
        restored plane starts clean). Callers holding the OLD state
        object must re-read `supervisor.state`. Returns the new state.
        """
        from hypervisor_tpu_torch.resilience.recovery import recover

        if not self.can_restore():
            raise RuntimeError(
                "restore_state needs checkpoint_dir and an attached WAL"
            )
        old = self.state
        journal = old.journal
        wal_path = journal.path
        journal.flush()
        journal.close()
        old.journal = None
        t0 = time.perf_counter()
        state, report = recover(
            self.checkpoint_dir, wal_path, config=old.config,
            attach_journal=True, device=old.device,
        )
        wall_ms = (time.perf_counter() - t0) * 1e3
        # Take over the new state: supervisor, health listener, chaos
        # schedule, and the integrity plane all move across.
        state.resilience = self
        state.fault_injector = old.fault_injector
        # The sybil damper is host-side hardening, not table state: it
        # must survive a restore or a flood mid-restore resumes
        # admitting unchecked. Its installed policy handle does NOT
        # carry over (the fresh state starts with no degraded policy;
        # the damper re-trips from its own window if the flood is
        # still live).
        damper = getattr(old, "admission_damper", None)
        if damper is not None:
            damper.forget_installed()
        state.admission_damper = damper
        self.state = state
        state.health.add_listener(self._on_health_event)
        plane = getattr(old, "integrity", None)
        if plane is not None:
            plane.attach(state)
        with self._lock:
            self.state_restores += 1
            self._fail_streak = 0
            self._clean_streak = 0
            self.last_restore = {
                "reason": reason,
                "at": time.time(),
                "wall_ms": round(wall_ms, 3),
                **report,
            }
        state.health.emit_event(
            "state_restored",
            {"reason": reason, "wall_ms": round(wall_ms, 3), **report},
        )
        return state

    def _prune_checkpoints(self, keep: int) -> None:
        """Delete the oldest durable step directories beyond `keep`
        (markerless dirs — in-flight or torn saves — are left for the
        writer/operator; the durable scan ignores them anyway)."""
        import shutil

        from hypervisor_tpu_torch.resilience.recovery import step_checkpoints

        durable = step_checkpoints(self.checkpoint_dir, durable_only=True)
        for _, victim in durable[:-keep] if keep else durable:
            shutil.rmtree(victim, ignore_errors=True)

    # -- the /debug/resilience payload -----------------------------------

    def summary(self) -> dict:
        with self._lock:
            policy = self.state.degraded_policy
            latencies = sorted(self.recovery_latencies_ms)
            summary = {
                "enabled": True,
                "mode": "degraded" if policy is not None else "normal",
                "degraded": {
                    "active_policy": (
                        policy.to_dict() if policy is not None else None
                    ),
                    "entries": self.degraded_entries,
                    "exits": self.degraded_exits,
                },
                "dispatch": {
                    "dispatches": self.dispatches,
                    "retries": self.retries,
                    "failed": self.failed_dispatches,
                    "device_losses": self.device_losses,
                    "fail_streak": self._fail_streak,
                    "clean_streak": self._clean_streak,
                    "last_error": self.last_error,
                },
                "pressure": {
                    "stragglers": self._straggler_pressure,
                    "capacity_warnings": self._capacity_pressure,
                    "comp_backlog": self._comp_backlog,
                    "comp_backpressure_entries": (
                        self.comp_backpressure_entries
                    ),
                    "slo_critical_alerts": self.slo_critical_alerts,
                    "slo_degraded_entries": self.slo_degraded_entries,
                    "last_slo_alert": self.last_slo_alert,
                },
                "thresholds": {
                    "max_retries": self.max_retries,
                    "backoff_base_s": self.backoff_base_s,
                    "degrade_after_failures": self.degrade_after_failures,
                    "degrade_after_stragglers": self.degrade_after_stragglers,
                    "degrade_after_capacity": self.degrade_after_capacity,
                    "degrade_after_comp_backlog": (
                        self.degrade_after_comp_backlog
                    ),
                    "degrade_on_slo_critical": self.degrade_on_slo_critical,
                    "exit_after_clean": self.exit_after_clean,
                },
                "recovery_latency_ms": (
                    {
                        "n": len(latencies),
                        "p50": round(latencies[len(latencies) // 2], 3),
                        "max": round(latencies[-1], 3),
                    }
                    if latencies
                    else {"n": 0}
                ),
                "checkpoint": self.last_checkpoint,
                "checkpoints_skipped": self.checkpoints_skipped,
                "last_checkpoint_error": self.last_checkpoint_error,
                "restores": {
                    "count": self.state_restores,
                    "last": self.last_restore,
                },
            }
        journal = self.state.journal
        summary["journal"] = journal.status() if journal is not None else None
        return summary


__all__ = ["RETRYABLE", "Supervisor"]
