"""Deadline-aware wave scheduler: pending requests -> shape-bucketed waves.

The scheduler is the front door's drain: each `tick(now)` inspects the
five ingestion queues and dispatches any class that is DUE — its bucket
filled, or its oldest request is about to miss its latency deadline —
through the fused wave programs, padded to the CLOSED bucket set so no
dispatch after warm-up shows the compile watch a novel signature (the
port's recompile: `observability.health`):

  class       program                              bucket shapes
  ──────────  ───────────────────────────────────  ─────────────────────
  join        donated admission wave               buckets (pad lanes)
              (`flush_joins(pad_to=...)`)
  lifecycle   ONE-program fused governance wave    buckets x buckets
              (PR 9; `run_governance_wave(
              pad_to=(B, B))`)
  action      fused gateway wave                   powers of two
              (`check_actions_wave`, pads itself)  (<= max bucket)
  terminate   terminate wave, park-padded          buckets
              (`terminate_sessions(pad_to=...)`)
  saga        whole-table saga round               static (table shape)

`warm(now)` dispatches every (program, bucket) pair once — including
the sanitize variant of the fused wave when an integrity plane is
attached — so an open-workload soak after warmup holds ZERO novel
signatures, and the roofline observatory has counted each of them.

Each dispatch's wave wall ends after the wave's results are on the
host: the lifecycle and action waves read their lanes back inside the
bracket, and the saga round, which reads nothing back, waits for the
device (`_settle`), so on a card the wall covers the device time.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from hypervisor_tpu_torch.ops import admission
from hypervisor_tpu_torch.ops.merkle import BODY_WORDS
from hypervisor_tpu_torch.serving.front_door import FrontDoor, Ticket


def _host(column) -> np.ndarray:
    """A wave output on the host (a device read waits for the wave)."""
    if isinstance(column, torch.Tensor):
        return column.cpu().numpy()
    return np.asarray(column)


def _settle(state) -> None:
    """Wait for the state's device to finish what was enqueued."""
    if state.device.type == "cuda":
        torch.cuda.current_stream(state.device).synchronize()


class WaveScheduler:
    """Drains a `FrontDoor`'s queues into shape-bucketed waves."""

    def __init__(self, front_door: FrontDoor) -> None:
        self.front_door = front_door
        self.state = front_door.state
        self.ticks = 0

    @property
    def config(self):
        """Live view of the front door's config — stays current across
        `FrontDoor.reconfigure` (the autopilot's knob path), so a grown
        bucket set is dispatchable the tick after it is applied."""
        return self.front_door.config

    # ── bucket arithmetic ────────────────────────────────────────────

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (n must fit the largest bucket)."""
        for b in self.config.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"wave of {n} exceeds the largest bucket "
            f"{self.config.max_bucket}; queue depths must cap chunks"
        )

    def _due(self, queue, deadline_s: float, now: float) -> bool:
        if not queue:
            return False
        if len(queue) >= self.config.max_bucket:
            return True
        oldest = queue[0].submitted_at
        return now + self.config.dispatch_margin_s >= oldest + deadline_s

    @staticmethod
    def _take(queue, n: int) -> list[Ticket]:
        return [queue.popleft() for _ in range(min(n, len(queue)))]

    # ── the tick ─────────────────────────────────────────────────────

    def tick(
        self,
        now: Optional[float] = None,
        classes: Optional[tuple] = None,
    ) -> dict:
        """One scheduling pass; dispatches every due class. Returns a
        report of dispatched waves per class.

        `classes` restricts the pass to a subset of request classes —
        the tenant scheduler (`tenancy.front_door.TenantWaveScheduler`)
        drains lifecycles itself through the batched tenant wave and
        runs each tenant's solo pass for the rest."""
        fd = self.front_door
        now = self.state.now() if now is None else float(now)
        report = {q: 0 for q in fd._queues}
        with fd._lock:
            self.ticks += 1
            # Lifecycles first: full buckets drain in exact quanta, a
            # deadline flush pads the remainder.
            if classes is None or "lifecycle" in classes:
                while len(fd.lifecycles) >= self.config.max_bucket:
                    self._dispatch_lifecycles(
                        self._take(fd.lifecycles, self.config.max_bucket),
                        now,
                    )
                    report["lifecycle"] += 1
                if self._due(
                    fd.lifecycles, self.config.lifecycle_deadline_s, now
                ):
                    self._dispatch_lifecycles(
                        self._take(fd.lifecycles, self.config.max_bucket),
                        now,
                    )
                    report["lifecycle"] += 1
            # Joins: the staging queue IS the wave; one padded flush
            # serves everything pending.
            if (classes is None or "join" in classes) and self._due(
                fd.joins, self.config.join_deadline_s, now
            ):
                self._dispatch_joins(now)
                report["join"] += 1
            # Actions: chunk to the largest bucket (the gateway pads
            # each chunk to a power of two itself).
            if classes is None or "action" in classes:
                while self._due(
                    fd.actions, self.config.action_deadline_s, now
                ):
                    self._dispatch_actions(
                        self._take(fd.actions, self.config.max_bucket), now
                    )
                    report["action"] += 1
            # Terminations: park-padded buckets.
            if classes is None or "terminate" in classes:
                while self._due(
                    fd.terminations, self.config.terminate_deadline_s, now
                ):
                    self._dispatch_terminations(
                        self._take(fd.terminations, self.config.max_bucket),
                        now,
                    )
                    report["terminate"] += 1
            # Saga settles: one whole-table round, outcomes deduped by
            # slot (later outcomes for the same saga wait a round).
            if (classes is None or "saga" in classes) and self._due(
                fd.saga_steps, self.config.saga_deadline_s, now
            ):
                self._dispatch_sagas(now)
                report["saga"] += 1
            fd.refresh_depth_gauges()
            # One burn-rate evaluation per scheduling pass: cheap host
            # window math on the virtual clock (alerts fan through the
            # health monitor -> supervisor + event bus).
            fd.slo.evaluate(now)
        return report

    def drain(self, now: Optional[float] = None, max_ticks: int = 64) -> int:
        """Tick until every queue is empty (deadline checks bypassed by
        forcing dispatch of whatever is pending). Returns waves run."""
        fd = self.front_door
        now = self.state.now() if now is None else float(now)
        waves = 0
        for _ in range(max_ticks):
            if not any(len(q) for q in fd._queues.values()):
                break
            with fd._lock:
                if fd.lifecycles:
                    self._dispatch_lifecycles(
                        self._take(fd.lifecycles, self.config.max_bucket), now
                    )
                    waves += 1
                if fd.joins:
                    self._dispatch_joins(now)
                    waves += 1
                if fd.actions:
                    self._dispatch_actions(
                        self._take(fd.actions, self.config.max_bucket), now
                    )
                    waves += 1
                if fd.terminations:
                    self._dispatch_terminations(
                        self._take(fd.terminations, self.config.max_bucket),
                        now,
                    )
                    waves += 1
                if fd.saga_steps:
                    self._dispatch_sagas(now)
                    waves += 1
                fd.refresh_depth_gauges()
                fd.slo.evaluate(now)
        return waves

    # ── per-class dispatches ─────────────────────────────────────────

    def _dispatch_joins(self, now: float) -> None:
        fd = self.front_door
        tickets = list(fd.joins)
        fd.joins.clear()
        n = len(tickets)
        bucket = self.bucket_for(n)
        newest = max(t.submitted_at for t in tickets) if tickets else now
        t0 = time.perf_counter()
        self.state.flush_joins(now=now, pad_to=bucket)
        wall = time.perf_counter() - t0
        rec = self.state.tracer.last_closed
        results = self.state.last_join_results
        from hypervisor_tpu_torch.state import _mkey

        for t in tickets:
            key = _mkey(t.payload["session_slot"], t.payload["did"])
            status = results.get(key)
            if status is None:
                # Harvested by a concurrent facade flush; membership is
                # the ground truth.
                admitted = self.state.is_member(
                    t.payload["session_slot"], t.payload["agent_did"]
                )
                status = (
                    admission.ADMIT_OK if admitted
                    else admission.ADMIT_BAD_STATE
                )
            fd.resolve(
                t,
                ok=status == admission.ADMIT_OK,
                now=now,
                wall_s=wall,
                status=int(status),
                newest_submit=newest,
                wave_record=rec,
            )
        fd.note_wave("join", n, bucket, now=now)

    def _dispatch_lifecycles(self, tickets: list[Ticket], now: float) -> None:
        if not tickets:
            return
        fd = self.front_door
        k = len(tickets)
        bucket = self.bucket_for(k)
        turns = self.config.lifecycle_turns
        bodies = np.zeros((turns, k, BODY_WORDS), np.uint32)
        for i, t in enumerate(tickets):
            bodies[:, i, :] = t.payload["bodies"]
        newest = max(t.submitted_at for t in tickets)
        t0 = time.perf_counter()
        slots = self.state.create_sessions_batch(
            [t.payload["session_id"] for t in tickets],
            self._lifecycle_config(),
        )
        result = self.state.run_governance_wave(
            slots,
            [t.payload["agent_did"] for t in tickets],
            slots.copy(),
            np.array([t.payload["sigma_raw"] for t in tickets], np.float32),
            bodies,
            now=now,
            trustworthy=np.array(
                [t.payload["trustworthy"] for t in tickets], bool
            ),
            # ALWAYS padded (even at k == bucket) so every lifecycle
            # wave shares the one valid-operand program family.
            pad_to=(bucket, bucket),
        )
        status = _host(result.status)
        roots = _host(result.merkle_root).view(np.uint32)
        wall = time.perf_counter() - t0
        rec = self.state.tracer.last_closed
        for i, t in enumerate(tickets):
            fd.resolve(
                t,
                ok=status[i] == admission.ADMIT_OK,
                now=now,
                wall_s=wall,
                status=int(status[i]),
                result={"merkle_root": roots[i].tolist()},
                newest_submit=newest,
                wave_record=rec,
            )
        fd.note_wave("lifecycle", k, bucket, now=now)

    def _lifecycle_config(self):
        from hypervisor_tpu_torch.models import SessionConfig

        return SessionConfig(min_sigma_eff=0.0, max_participants=4)

    def _dispatch_actions(self, tickets: list[Ticket], now: float) -> None:
        if not tickets:
            return
        fd = self.front_door
        n = len(tickets)
        newest = max(t.submitted_at for t in tickets)
        t0 = time.perf_counter()
        result = self.state.check_actions_wave(
            [t.payload["slot"] for t in tickets],
            [t.payload["required_ring"] for t in tickets],
            [t.payload["is_read_only"] for t in tickets],
            [t.payload["has_consensus"] for t in tickets],
            [t.payload["has_sre_witness"] for t in tickets],
            [False] * n,
            now=now,
        )
        verdict = _host(result.verdict)
        ring_status = _host(result.ring_status)
        wall = time.perf_counter() - t0
        rec = self.state.tracer.last_closed
        for i, t in enumerate(tickets):
            fd.resolve(
                t,
                ok=bool(verdict[i]),
                now=now,
                wall_s=wall,
                status=int(ring_status[i]),
                newest_submit=newest,
                wave_record=rec,
            )
        # The gateway pads itself to the next power of two.
        bucket = max(1, 1 << max(0, (n - 1).bit_length()))
        fd.note_wave("action", n, bucket, now=now)

    def _dispatch_terminations(self, tickets: list[Ticket], now: float) -> None:
        if not tickets:
            return
        fd = self.front_door
        # Dedupe within the wave: terminating one slot twice in one
        # program is a wasted lane, not an error.
        seen: dict[int, list[Ticket]] = {}
        for t in tickets:
            seen.setdefault(t.payload["session_slot"], []).append(t)
        slots = list(seen)
        k = len(slots)
        bucket = self.bucket_for(k)
        newest = max(t.submitted_at for t in tickets)
        t0 = time.perf_counter()
        roots = self.state.terminate_sessions(
            slots, now=now, pad_to=bucket, pad_slot=fd.park_slot(now)
        )
        wall = time.perf_counter() - t0
        rec = self.state.tracer.last_closed
        for i, slot in enumerate(slots):
            for t in seen[slot]:
                fd.resolve(
                    t,
                    ok=True,
                    now=now,
                    wall_s=wall,
                    result={"merkle_root": roots[i].tolist()},
                    newest_submit=newest,
                    wave_record=rec,
                )
        fd.note_wave("terminate", k, bucket, now=now)

    def _dispatch_sagas(self, now: float) -> None:
        fd = self.front_door
        outcomes: dict[int, bool] = {}
        taken: list[Ticket] = []
        remaining: list[Ticket] = []
        while fd.saga_steps:
            t = fd.saga_steps.popleft()
            slot = t.payload["saga_slot"]
            if slot in outcomes:
                remaining.append(t)
            else:
                outcomes[slot] = t.payload["ok"]
                taken.append(t)
        fd.saga_steps.extend(remaining)
        if not taken:
            return
        newest = max(t.submitted_at for t in taken)
        t0 = time.perf_counter()
        self.state.saga_round(exec_outcomes=outcomes)
        _settle(self.state)
        wall = time.perf_counter() - t0
        rec = self.state.tracer.last_closed
        for t in taken:
            fd.resolve(
                t, ok=True, now=now, wall_s=wall,
                newest_submit=newest, wave_record=rec,
            )
        fd.note_wave("saga", len(taken), len(taken), now=now)

    # ── warmup ───────────────────────────────────────────────────────

    def warm(self, now: Optional[float] = None) -> dict:
        """Dispatch every (program, bucket) pair the scheduler can
        dispatch, so the soak that follows holds zero recompiles: one
        padded join flush, lifecycle wave (both sanitizer variants when
        an integrity plane is attached), and park-padded terminate per
        bucket, plus each power-of-two gateway shape and one saga
        round. Returns the compile-telemetry totals afterward — the
        baseline the soak's zero-recompile assertion diffs against."""
        from hypervisor_tpu_torch.models import SessionConfig
        from hypervisor_tpu_torch.observability import health as health_plane

        fd = self.front_door
        state = self.state
        now = state.now() if now is None else float(now)
        with fd._lock:
            plane = state.integrity
            sanitize_passes = (False, True) if plane is not None else (False,)
            for bucket in self.config.buckets:
                for sanitized in sanitize_passes:
                    slots = state.create_sessions_batch(
                        [
                            f"serving:warm:b{bucket}:s{int(sanitized)}",
                        ],
                        self._lifecycle_config(),
                    )
                    if sanitized:
                        plane._fused_due = True  # arm the fused variant
                    state.run_governance_wave(
                        slots,
                        [f"did:serving:warm:b{bucket}:s{int(sanitized)}"],
                        slots.copy(),
                        np.full(1, 0.8, np.float32),
                        np.zeros(
                            (self.config.lifecycle_turns, 1, BODY_WORDS),
                            np.uint32,
                        ),
                        now=now,
                        pad_to=(bucket, bucket),
                    )
                # Join flush at this bucket (one real lane, padded).
                warm_sess = state.create_session(
                    f"serving:warm:join:b{bucket}",
                    SessionConfig(min_sigma_eff=0.0),
                    now=now,
                )
                state.enqueue_join(
                    warm_sess, f"did:serving:warm:join:b{bucket}", 0.8,
                    now=now,
                )
                state.flush_joins(now=now, pad_to=bucket)
                # Park-padded terminate at this bucket.
                state.terminate_sessions(
                    [warm_sess], now=now, pad_to=bucket,
                    pad_slot=fd.park_slot(now),
                )
            # Gateway shapes: one standing member, every power of two.
            gw_sess = state.create_session(
                "serving:warm:gw", SessionConfig(min_sigma_eff=0.0), now=now
            )
            state.enqueue_join(gw_sess, "did:serving:warm:gw", 0.8, now=now)
            state.flush_joins(now=now, pad_to=self.bucket_for(1))
            row = state.agent_row("did:serving:warm:gw", gw_sess)
            if row is not None:
                shape = 1
                while shape <= self.config.max_bucket:
                    state.check_actions_wave(
                        [row["slot"]] * shape,
                        [2] * shape,
                        [True] * shape,
                        [False] * shape,
                        [False] * shape,
                        [False] * shape,
                        now=now,
                    )
                    shape *= 2
            state.saga_round()
            # The drain's gauge-refresh program compiles here too, so a
            # mid-soak /metrics scrape cannot count as a fresh compile.
            state.metrics_snapshot()
        summary = health_plane.compile_summary(last=0)
        return {
            k: summary[k]
            for k in (
                "programs", "compiles", "recompiles", "donation_failures",
            )
        }

    def warm_bucket(
        self, bucket: int, now: Optional[float] = None, tag: str = ""
    ) -> None:
        """Compile every per-bucket program at ONE (possibly new)
        bucket shape — the autopilot grow rule's off-hot-path pre-warm.

        Covers the shapes a dispatch at `bucket` can reach: the fused
        lifecycle wave at (bucket, bucket) in both sanitizer variants
        (when an integrity plane is attached), a padded join flush, a
        park-padded terminate, and — when `bucket` is a power of two —
        the gateway at that width (action chunks cap at the new max
        bucket, and the gateway pads to powers of two, so smaller
        shapes were covered by the initial `warm`). Runs under the
        front-door lock, BETWEEN scheduling passes — never inside one —
        so the hot path only ever sees warm tiles.
        """
        from hypervisor_tpu_torch.models import SessionConfig

        fd = self.front_door
        state = self.state
        now = state.now() if now is None else float(now)
        stamp = f"b{bucket}" + (f":{tag}" if tag else "")
        with fd._lock:
            plane = state.integrity
            sanitize_passes = (False, True) if plane is not None else (False,)
            for sanitized in sanitize_passes:
                slots = state.create_sessions_batch(
                    [f"serving:prewarm:{stamp}:s{int(sanitized)}"],
                    self._lifecycle_config(),
                )
                if sanitized:
                    plane._fused_due = True  # arm the fused variant
                state.run_governance_wave(
                    slots,
                    [f"did:serving:prewarm:{stamp}:s{int(sanitized)}"],
                    slots.copy(),
                    np.full(1, 0.8, np.float32),
                    np.zeros(
                        (self.config.lifecycle_turns, 1, BODY_WORDS),
                        np.uint32,
                    ),
                    now=now,
                    pad_to=(bucket, bucket),
                )
            warm_sess = state.create_session(
                f"serving:prewarm:join:{stamp}",
                SessionConfig(min_sigma_eff=0.0),
                now=now,
            )
            state.enqueue_join(
                warm_sess, f"did:serving:prewarm:join:{stamp}", 0.8,
                now=now,
            )
            state.flush_joins(now=now, pad_to=bucket)
            row = state.agent_row(
                f"did:serving:prewarm:join:{stamp}", warm_sess
            )
            if row is not None and bucket & (bucket - 1) == 0:
                state.check_actions_wave(
                    [row["slot"]] * bucket,
                    [2] * bucket,
                    [True] * bucket,
                    [False] * bucket,
                    [False] * bucket,
                    [False] * bucket,
                    now=now,
                )
            state.terminate_sessions(
                [warm_sess], now=now, pad_to=bucket,
                pad_slot=fd.park_slot(now),
            )


__all__ = ["WaveScheduler"]
