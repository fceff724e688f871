"""Chaos injection: seeded, reproducible fault plans for BOTH layers.

The reference's fault injection is ad-hoc per test (flaky lambdas,
injected drift scores — SURVEY §5 "no chaos framework"). This module is
the framework-level version, covering:

  * **Saga executors** (`ChaosExecutorFactory`) — wraps any async
    executor with configurable failure, timeout-hang, and latency
    behavior drawn from one seeded stream.
  * **The wave layer** (`WaveChaosInjector`) — a dispatch interposer
    `hypervisor_tpu_torch.state` consults at every wave dispatch and drain
    site (`HypervisorState.fault_injector`). It can raise a transient
    `InjectedWaveFault` (the supervisor's retry ladder exercises),
    stall the dispatch (`hang_seconds` of host sleep — the watchdog's
    straggler path exercises), or raise `InjectedDeviceLoss` on a
    drain (simulated preemption/device loss — the checkpoint+WAL
    restore path exercises).

Because every plan is seeded, a chaos run that surfaces a bug replays
exactly. Faults are injected per CALL (retries roll fresh outcomes), so
retry ladders and compensation paths genuinely exercise.

Usage::

    chaos = ChaosExecutorFactory(ChaosPlan(seed=7, fail_rate=0.3))
    sched.register(slot, idx, chaos.wrap(real_executor, key="step-3"))
    ...
    chaos.report()        # {'calls': N, 'failures': k, 'hangs': h}
    chaos.cancel_hangs()  # teardown: no pending tasks leak past the loop

    state.fault_injector = WaveChaosInjector(WaveChaosPlan(seed=7,
                                                           fail_rate=0.2))
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Optional

Executor = Callable[[], Awaitable[Any]]


class ChaosFailure(RuntimeError):
    """Injected executor failure."""


class InjectedWaveFault(RuntimeError):
    """Injected transient wave-dispatch failure (retryable)."""


class InjectedDeviceLoss(RuntimeError):
    """Injected device loss / preemption: NOT retryable — the recovery
    path (checkpoint restore + WAL replay) is the only way forward."""


@dataclass(frozen=True)
class ChaosPlan:
    """Fault mix; rates are per-call probabilities in [0, 1]."""

    seed: int = 0
    fail_rate: float = 0.2
    hang_rate: float = 0.0        # sleep far past the step timeout
    latency_seconds: float = 0.0  # added to every surviving call
    hang_seconds: float = 3600.0


@dataclass
class ChaosStats:
    calls: int = 0
    failures: int = 0
    hangs: int = 0
    by_key: dict = field(default_factory=dict)


class ChaosExecutorFactory:
    """Wraps executors with a shared, seeded fault stream.

    Hang injection is CANCELLABLE: every hanging call registers its
    task so `cancel_hangs()` (teardown) cancels whatever is still
    sleeping — chaos tests must not leak pending asyncio tasks past the
    event loop they ran in.
    """

    def __init__(self, plan: ChaosPlan) -> None:
        self.plan = plan
        self._rng = random.Random(plan.seed)
        self.stats = ChaosStats()
        self._hanging: set[asyncio.Task] = set()

    def wrap(self, executor: Executor, key: str = "?") -> Executor:
        async def chaotic() -> Any:
            self.stats.calls += 1
            per = self.stats.by_key.setdefault(
                key, {"calls": 0, "failures": 0, "hangs": 0}
            )
            per["calls"] += 1
            roll = self._rng.random()
            if roll < self.plan.fail_rate:
                self.stats.failures += 1
                per["failures"] += 1
                raise ChaosFailure(f"injected failure for {key}")
            if roll < self.plan.fail_rate + self.plan.hang_rate:
                self.stats.hangs += 1
                per["hangs"] += 1
                task = asyncio.current_task()
                if task is not None:
                    self._hanging.add(task)
                try:
                    await asyncio.sleep(self.plan.hang_seconds)
                finally:
                    if task is not None:
                        self._hanging.discard(task)
            if self.plan.latency_seconds:
                await asyncio.sleep(self.plan.latency_seconds)
            return await executor()

        return chaotic

    @property
    def hanging_tasks(self) -> int:
        """Tasks currently parked in an injected hang."""
        return len(self._hanging)

    def cancel_hangs(self) -> int:
        """Cancel every task still parked in an injected hang; returns
        how many were cancelled. Call on teardown (must run inside the
        event loop that owns the tasks)."""
        cancelled = 0
        for task in list(self._hanging):
            if not task.done():
                task.cancel()
                cancelled += 1
        self._hanging.clear()
        return cancelled

    def report(self) -> dict:
        return {
            "calls": self.stats.calls,
            "failures": self.stats.failures,
            "hangs": self.stats.hangs,
            "by_key": dict(self.stats.by_key),
        }


# ── wave-layer fault injection ───────────────────────────────────────


@dataclass(frozen=True)
class InjectedCorruption:
    """One REAL silent-data-corruption event against the device tables.

    Unlike every other fault here, this does not raise or stall: it
    flips bits / rewrites rows in the HBM-resident state, exactly the
    damage the integrity plane (`hypervisor_tpu_torch.integrity`) exists to
    catch. Applied at the dispatch gate once the injector's armed
    dispatch counter reaches `at_dispatch` (1-based), BEFORE the wave
    runs, from a dedicated rng stream — adding corruptions to a plan
    never perturbs the fault/hang/drain-loss schedule of its seed.

    Kinds:
      * ``bit_flip``   — flip a high/exponent bit of one word in the
        named `table` ("agents" sigma, "vouches" bond, or a
        "delta_log" body word), chosen seeded. Detectable bits on
        purpose: the drill validates the detection machinery; a
        mantissa flip that stays in-range is invisible to semantic
        checks by construction (only the scrubber's hash sees those,
        which is why delta_log targets flip ANY bit).
      * ``row_rewrite`` — rewrite one row of the named `table` with
        out-of-band garbage (several violation classes at once).
      * ``chain_tamper`` — flip one random bit of a recorded DeltaLog
        chain digest (the Merkle scrubber's restore-class case).

    A corruption whose target table holds no eligible row yet stays
    pending and retries at the next gate.
    """

    kind: str                    # bit_flip | row_rewrite | chain_tamper
    at_dispatch: int = 1
    table: str = "agents"        # bit_flip / row_rewrite target


@dataclass(frozen=True)
class InjectedFleetFault:
    """One FLEET-layer fault, scheduled by drill round (1-based).

    These describe failures ABOVE the dispatch interposer — whole
    workers and their durable artifacts — so the injector does not
    apply them itself: the drill harness (gate 6m, `bench_suite
    --failover`, `FleetSupervisor`-based tests) polls
    `WaveChaosInjector.take_fleet_faults(round)` at each round boundary
    and delivers what comes due (signals via the supervisor, torn
    checkpoints by truncating the named worker's newest checkpoint
    artifact, partitioned scrapes by skipping the worker in the merged
    drain). Keeping the schedule in the plan keeps it SEEDED: the same
    plan replays the same kill at the same round, which is what lets
    the failover drill pin bit-identical ownership digests.

    Kinds: ``worker_sigkill`` | ``worker_sigstop`` |
    ``torn_checkpoint`` | ``partitioned_scrape``.

    Migration-window kinds (round 21 — faults timed INSIDE a planned
    rebalance, delivered by the drill harness at the named protocol
    boundary of the worker's in-flight migration):

    * ``migration_kill_source`` — SIGKILL the migration SOURCE
      mid-drain (between ``seal_source`` and ``final_checkpoint``);
      failover must win the race, abort the journaled intent, and
      recover the tenant from the source's durable state.
    * ``migration_kill_dest`` — SIGKILL the DESTINATION mid-adopt
      (after ``fence_source_tenant``); the abort must salvage the
      drained tenant onto a live worker (the source is per-tenant
      fenced and can never write it again).
    * ``torn_ownership_record`` — tear the worker's durable FENCE doc
      to garbage bytes mid-handoff; the worker must fail CLOSED
      (floor ``1 << 62``), refusing every write until failed over.
    * ``handoff_partition`` — the supervisor loses the worker between
      intent and commit (the migration stalls at its current step);
      conviction then resolves it through the abort path.
    * ``zombie_source_resume`` — the fenced source resumes after its
      per-tenant fence burned and retries an append; the refusal must
      land with ZERO bytes on disk.
    """

    kind: str = "worker_sigkill"
    at_round: int = 1
    worker: str = "w0"


@dataclass(frozen=True)
class WaveChaosPlan:
    """Dispatch-interposer fault mix; rates are per-dispatch
    probabilities in [0, 1], drawn from one seeded stream in dispatch
    order (same workload + same seed -> same fault schedule).

    `stages` narrows injection to named dispatch sites (the stage
    vocabulary of `observability.metrics.STAGES` plus
    `"metrics_drain"`); None hits every site. `drain_loss_rate` fires
    only on drain sites — a corrupt/failed drain IS device loss from
    the host's point of view, so it raises `InjectedDeviceLoss`.
    (`corrupt_rate` is the pre-rename alias for the same knob, kept so
    committed plans and seeds replay identically: it was never table
    corruption, only drain loss — REAL corruption is the separate
    seeded `corruptions` schedule, `InjectedCorruption`, drawn from its
    own rng stream so a seed's fault schedule is reproducible across
    the rename and across adding/removing corruption events.)
    """

    seed: int = 0
    fail_rate: float = 0.0
    hang_rate: float = 0.0
    drain_loss_rate: float = 0.0
    corrupt_rate: float = 0.0     # deprecated alias for drain_loss_rate
    hang_seconds: float = 0.05    # host stall simulating a wedged wave
    stages: Optional[tuple[str, ...]] = None
    corruptions: tuple[InjectedCorruption, ...] = ()
    #: Fleet-layer faults (worker kills/stops, torn checkpoints,
    #: partitioned scrapes) the DRILL HARNESS delivers at round
    #: boundaries via `take_fleet_faults` — see `InjectedFleetFault`.
    fleet_faults: tuple = ()

    @property
    def effective_drain_loss_rate(self) -> float:
        """`drain_loss_rate`, honouring the deprecated alias."""
        return self.drain_loss_rate or self.corrupt_rate


class WaveChaosInjector:
    """The dispatch interposer `HypervisorState.fault_injector` holds.

    `on_dispatch(stage)` runs before a wave mutates anything — an
    injected raise leaves the tables untouched, so the supervisor's
    retry re-dispatches cleanly and the WAL bracket records an abort
    (or nothing), never a phantom commit.
    """

    def __init__(self, plan: WaveChaosPlan, sleep=time.sleep) -> None:
        self.plan = plan
        self._rng = random.Random(plan.seed)
        # Dedicated corruption stream: drawing targets here never
        # advances the fault/hang schedule above, so seed S replays the
        # same raises with or without a corruption list.
        self._corrupt_rng = random.Random(plan.seed ^ 0x5DC0FFEE)
        self._sleep = sleep
        self.dispatches = 0
        self.faults = 0
        self.hangs = 0
        self.losses = 0
        self.by_stage: dict[str, dict] = {}
        self._pending_corruptions = sorted(
            plan.corruptions, key=lambda c: c.at_dispatch
        )
        self.corruptions_applied: list[dict] = []
        self._pending_fleet_faults = sorted(
            plan.fleet_faults, key=lambda f: f.at_round
        )
        self.fleet_faults_taken: list[dict] = []

    def _armed(self, stage: str) -> bool:
        return self.plan.stages is None or stage in self.plan.stages

    def _per(self, stage: str) -> dict:
        return self.by_stage.setdefault(
            stage, {"dispatches": 0, "faults": 0, "hangs": 0, "losses": 0}
        )

    def on_dispatch(self, stage: str) -> None:
        """Consult the plan before one wave dispatch; may raise
        `InjectedWaveFault`, stall, or pass through."""
        if not self._armed(stage):
            return
        self.dispatches += 1
        per = self._per(stage)
        per["dispatches"] += 1
        roll = self._rng.random()
        if roll < self.plan.fail_rate:
            self.faults += 1
            per["faults"] += 1
            raise InjectedWaveFault(
                f"injected {stage} dispatch fault #{self.faults} "
                f"(seed {self.plan.seed})"
            )
        if roll < self.plan.fail_rate + self.plan.hang_rate:
            self.hangs += 1
            per["hangs"] += 1
            self._sleep(self.plan.hang_seconds)

    def on_drain(self, stage: str = "metrics_drain") -> None:
        """Consult the plan before a host drain (`device_get` site); a
        failed/corrupt drain surfaces as device loss (the recovery
        path's problem, not the integrity plane's — real TABLE
        corruption is `InjectedCorruption`)."""
        if not self._armed(stage):
            return
        self.dispatches += 1
        per = self._per(stage)
        per["dispatches"] += 1
        roll = self._rng.random()
        if roll < self.plan.effective_drain_loss_rate:
            self.losses += 1
            per["losses"] += 1
            raise InjectedDeviceLoss(
                f"injected corrupt {stage} (simulated preemption, seed "
                f"{self.plan.seed})"
            )

    # ── real table corruption (silent-data-corruption drills) ────────

    @property
    def has_pending_corruptions(self) -> bool:
        return bool(self._pending_corruptions)

    @property
    def has_pending_fleet_faults(self) -> bool:
        return bool(self._pending_fleet_faults)

    def take_fleet_faults(self, round_: int) -> list:
        """Pop every fleet fault due at or before drill round `round_`
        (1-based). The DRILL HARNESS delivers them — the injector only
        keeps the seeded schedule and the taken log; each fault is
        handed out exactly once."""
        due: list = []
        while (
            self._pending_fleet_faults
            and self._pending_fleet_faults[0].at_round <= round_
        ):
            f = self._pending_fleet_faults.pop(0)
            due.append(f)
            self.fleet_faults_taken.append({
                "kind": f.kind, "worker": f.worker,
                "at_round": f.at_round, "taken_at_round": int(round_),
            })
        return due

    def apply_due_corruptions(self, state) -> list[dict]:
        """Apply every scheduled corruption whose dispatch has come.

        Called by the state's dispatch gate right after `on_dispatch`
        (so `self.dispatches` counts this gate). Mutates the device
        tables IN PLACE — that is the point: the hardware lied, and
        nothing raised. Returns the records applied this call.
        """
        applied: list[dict] = []
        while (
            self._pending_corruptions
            and self.dispatches >= self._pending_corruptions[0].at_dispatch
        ):
            c = self._pending_corruptions[0]
            record = self._apply_one(state, c)
            if record is None:
                break  # no eligible target yet; retry at the next gate
            self._pending_corruptions.pop(0)
            record.update(
                kind=c.kind, table=c.table, at_dispatch=c.at_dispatch,
                applied_at_dispatch=self.dispatches,
            )
            self.corruptions_applied.append(record)
            applied.append(record)
        return applied

    def _apply_one(self, state, c: InjectedCorruption) -> Optional[dict]:
        # The port's tables are torch tensors on the state's device: each
        # corruption is an in-place write there, drawing its row, word and
        # bit from the same rng calls as the reference, so one plan damages
        # the same places on both packages. u32 words are stored as int32
        # (the `u32` convention): a flip of bit 31 is the int32 sign bit.
        import numpy as np
        import torch

        rng = self._corrupt_rng

        def flip(column, index, bit: int) -> None:
            words = column.view(torch.int32) if column.dtype == torch.float32 else column
            words[index] ^= int(np.uint32(1 << bit).view(np.int32))

        if c.kind == "bit_flip":
            if c.table == "agents":
                rows = np.nonzero(state.agents.did.cpu().numpy() >= 0)[0]
                if not len(rows):
                    return None
                row = int(rows[rng.randrange(len(rows))])
                from hypervisor_tpu_torch.tables.state import AF32_SIGMA_EFF

                # Exponent bit 30: guaranteed out of [0, 1] for any
                # stored sigma, so the semantic sanitizer must see it.
                flip(state.agents.f32, (row, AF32_SIGMA_EFF), 30)
                return {"row": row, "column": "sigma_eff", "bit": 30}
            if c.table == "vouches":
                rows = np.nonzero(state.vouches.active.cpu().numpy())[0]
                if not len(rows):
                    return None
                row = int(rows[rng.randrange(len(rows))])
                flip(state.vouches.bond, row, 30)
                return {"row": row, "column": "bond", "bit": 30}
            if c.table == "delta_log":
                live = int(state.delta_log.cursor)
                cap = state.delta_log.body.shape[0]
                if live <= 0:
                    return None
                row = rng.randrange(min(live, cap))
                word = rng.randrange(state.delta_log.body.shape[1])
                bit = rng.randrange(32)
                flip(state.delta_log.body, (row, word), bit)
                return {"row": row, "column": f"body[{word}]", "bit": bit}
            raise ValueError(f"bit_flip target {c.table!r} not supported")
        if c.kind == "row_rewrite":
            if c.table == "agents":
                rows = np.nonzero(state.agents.did.cpu().numpy() >= 0)[0]
                if not len(rows):
                    return None
                row = int(rows[rng.randrange(len(rows))])
                from hypervisor_tpu_torch.tables.state import (
                    AF32_RL_TOKENS,
                    AF32_SIGMA_EFF,
                    AF32_SIGMA_RAW,
                    AI32_FLAGS,
                )

                a = state.agents
                a.f32[row, AF32_SIGMA_RAW] = -3.5
                a.f32[row, AF32_SIGMA_EFF] = 7.25
                a.f32[row, AF32_RL_TOKENS] = -50.0
                a.i32[row, AI32_FLAGS] |= 1 << 13
                a.ring[row] = 101
                return {"row": row, "column": "sigma/flags/ring/tokens"}
            if c.table == "sessions":
                rows = np.nonzero(state.sessions.sid.cpu().numpy() >= 0)[0]
                if not len(rows):
                    return None
                row = int(rows[rng.randrange(len(rows))])
                from hypervisor_tpu_torch.tables.state import SI32_STATE

                state.sessions.i32[row, SI32_STATE] = 99
                return {"row": row, "column": "state"}
            if c.table == "vouches":
                rows = np.nonzero(state.vouches.active.cpu().numpy())[0]
                if not len(rows):
                    return None
                row = int(rows[rng.randrange(len(rows))])
                state.vouches.voucher[row] = state.agents.did.shape[0] + 12345
                state.vouches.bond[row] = -1.0
                return {"row": row, "column": "voucher/bond"}
            raise ValueError(f"row_rewrite target {c.table!r} not supported")
        if c.kind == "chain_tamper":
            live = int(state.delta_log.cursor)
            cap = state.delta_log.digest.shape[0]
            if live <= 0:
                return None
            row = rng.randrange(min(live, cap))
            word = rng.randrange(8)
            bit = rng.randrange(32)
            flip(state.delta_log.digest, (row, word), bit)
            return {"row": row, "column": f"digest[{word}]", "bit": bit}
        raise ValueError(f"unknown corruption kind {c.kind!r}")

    def report(self) -> dict:
        return {
            "seed": self.plan.seed,
            "dispatches": self.dispatches,
            "faults": self.faults,
            "hangs": self.hangs,
            "losses": self.losses,
            "corruptions_applied": list(self.corruptions_applied),
            "corruptions_pending": len(self._pending_corruptions),
            "fleet_faults_taken": list(self.fleet_faults_taken),
            "fleet_faults_pending": len(self._pending_fleet_faults),
            "by_stage": dict(self.by_stage),
        }
