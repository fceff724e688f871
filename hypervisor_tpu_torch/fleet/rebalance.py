"""Planned zero-loss tenant migration on the failover splice path.

Round 20 built the CRASH half of push0's detect-and-reassign
(PAPERS.md; ROADMAP item 1): a convicted-dead worker's tenants are
recovered from durable state and spliced into survivors behind a
durable fence. This module is the PLANNED half — live rebalancing —
built so that both halves share ONE journaled ownership protocol and
ONE splice path (`FailoverController._absorb`): a crash at any
migration step degrades into the already-proven failover recovery
instead of a new failure mode.

The protocol is seven durable steps, each a crash boundary::

    1. journal_intent        OwnershipMap.migrate_intent (no move yet)
    2. seal_source           the tenant's FrontDoor stops admitting
    3. drain_source          queued work flushes through the scheduler
    4. final_checkpoint      source checkpoints at the WAL tip
    5. fence_source_tenant   per-tenant durable fence at the bumped
                             epoch (siblings keep serving)
    6. adopt_destination     recover_tenant + splice into a spare slot
                             (zero recompiles) + re-journal + checkpoint
    7. journal_commit        the ATOMIC record at which ownership moves;
                             then the source detaches its fenced copy

Ownership changes hands ONLY at step 7's journal record, so there is
exactly-one owner at every boundary: a crash before the commit leaves
the source the owner (failover recovers from the source's durable
state, which steps 3–4 made current), a crash after it leaves the
destination the owner (step 6 already made it durable there). The
failover-vs-rebalance race resolves failover-first: `failover()`
aborts any in-flight migration touching the dead worker (journaled
`migrate_abort`), rolls back a partial destination adoption, and —
when the destination died AFTER the per-tenant fence burned — salvages
the drained tenant onto a live worker through the same splice path.

Placement is a deterministic deficit-aware policy over the fleet's
ownership state (most-loaded donor -> least-loaded receiver with a
spare slot, worker id as tiebreak), digest-replayable like the
autopilot plane's decisions: same fleet state => same proposals, same
plan digest.
"""

from __future__ import annotations

import hashlib
import shutil
from typing import Callable, Optional

from hypervisor_tpu_torch.fleet.failover import (
    FailoverController,
    ManagedWorker,
    OwnershipMap,
    WorkerDurability,
)

#: The migration protocol's durable steps, in order. `migrate(...,
#: stop_after=step)` returns right after that step completes — the
#: kill-at-every-protocol-step drill's crash-boundary hook.
PROTOCOL_STEPS = (
    "journal_intent",
    "seal_source",
    "drain_source",
    "final_checkpoint",
    "fence_source_tenant",
    "adopt_destination",
    "journal_commit",
)


class MigrationError(RuntimeError):
    """A planned migration could not start or proceed (unknown worker,
    no spare slot, tenant already in flight, ...). Nothing moved."""


class RebalanceController:
    """Executes planned zero-loss tenant migrations between live
    workers, sharing the `FailoverController`'s worker registry,
    ownership journal, and `_absorb` splice path.

    Construction wires the race resolution: `failover.rebalance` is
    pointed at this controller so a conviction mid-migration aborts
    the migration (journaled) before reassignment begins.
    """

    def __init__(
        self,
        ownership: OwnershipMap,
        failover: FailoverController,
        emit: Optional[Callable[[str, dict], None]] = None,
        metrics=None,
    ) -> None:
        self.ownership = ownership
        self.failover = failover
        self.emit = emit if emit is not None else ownership.emit
        self.metrics = metrics
        self.migrations: list[dict] = []
        self.aborted: list[dict] = []
        # worker_id -> (TenantFrontDoor, TenantWaveScheduler|None):
        # the serving handles seal/drain act on. Optional — durability
        # -only deployments migrate without a serving plane.
        self._serving: dict[str, tuple] = {}
        failover.rebalance = self

    @property
    def workers(self) -> dict[str, ManagedWorker]:
        return self.failover.workers

    def attach_serving(
        self, worker_id: str, front, scheduler=None
    ) -> None:
        """Register a worker's serving plane so `seal_source` /
        `drain_source` quiesce real queues (doors are indexed by the
        worker's arena SLOT)."""
        self._serving[str(worker_id)] = (front, scheduler)

    # ── placement: deterministic deficit-aware plan ──────────────────

    def plan(self, now: float = 0.0) -> dict:
        """Propose migrations that level the fleet: repeatedly move
        one tenant from the most-loaded worker to the least-loaded
        worker holding a spare slot, while the imbalance is >= 2
        (moving across a deficit of 1 only flips it). Pure function
        of the current ownership state — the same digest-replayable
        decision discipline as the autopilot plane: same fleet state
        => same proposals, same plan digest. Dry-run only; `execute`
        applies it."""
        loads = {
            wid: len(w.slot_of) for wid, w in self.workers.items()
        }
        spares = {
            wid: len(w.spare_slots) for wid, w in self.workers.items()
        }
        owned = {
            wid: sorted(w.slot_of) for wid, w in self.workers.items()
        }
        busy = set(self.ownership.inflight)
        proposals: list[dict] = []
        digest = hashlib.sha256(b"rebalance-plan:")
        while True:
            donors = [
                wid for wid in sorted(loads)
                if any(t not in busy for t in owned[wid])
            ]
            receivers = [
                wid for wid in sorted(loads) if spares[wid] > 0
            ]
            if not donors or not receivers:
                break
            src = max(donors, key=lambda wid: (loads[wid], wid))
            # First movable tenant with an eligible receiver: a worker
            # whose per-tenant fence for that tenant burned (it sent
            # the tenant away earlier in this epoch) can't take it
            # back — floors only rise.
            tenant = dst = None
            for cand in owned[src]:
                if cand in busy:
                    continue
                dst = min(
                    (
                        wid for wid in receivers
                        if wid != src
                        and not self._fenced_for(wid, cand)
                    ),
                    key=lambda wid: (loads[wid], wid),
                    default=None,
                )
                if dst is not None:
                    tenant = cand
                    break
            if (
                tenant is None
                or dst is None
                or loads[src] - loads[dst] < 2
            ):
                break
            proposals.append({
                "tenant": tenant,
                "source": src,
                "dest": dst,
                "reason": (
                    f"deficit {loads[src]}-{loads[dst]}"
                ),
            })
            digest.update(
                f"{len(proposals)}|{tenant}|{src}->{dst}".encode()
            )
            owned[src].remove(tenant)
            owned[dst].append(tenant)
            busy.add(tenant)
            loads[src] -= 1
            loads[dst] += 1
            spares[dst] -= 1
            spares[src] += 1
        return {
            "now": round(float(now), 6),
            "proposals": proposals,
            "plan_digest": digest.hexdigest(),
            "loads": {
                wid: len(w.slot_of)
                for wid, w in sorted(self.workers.items())
            },
        }

    def execute(self, now: float) -> dict:
        """Plan, then run every proposed migration in order."""
        planned = self.plan(now)
        results = [
            self.migrate(p["tenant"], p["dest"], now)
            for p in planned["proposals"]
        ]
        return {"plan": planned, "results": results}

    # ── the migration state machine ──────────────────────────────────

    def migrate(
        self,
        tenant: int,
        dest: str,
        now: float,
        stop_after: Optional[str] = None,
    ) -> dict:
        """Move one live tenant to `dest` through the seven-step
        protocol. `stop_after` returns right after the named step —
        the state on disk and in the journal is then exactly what a
        crash AT that boundary leaves, and resolves through
        `FailoverController.failover` with exactly-one ownership.

        Re-submitting a migration that already completed (the tenant
        is owned by `dest` with nothing in flight) is a no-op."""
        t = int(tenant)
        now = float(now)
        if stop_after is not None and stop_after not in PROTOCOL_STEPS:
            raise MigrationError(
                f"unknown protocol step {stop_after!r} "
                f"(steps: {PROTOCOL_STEPS})"
            )
        dst_mw = self.workers.get(dest)
        if dst_mw is None:
            raise MigrationError(
                f"unknown destination worker {dest!r}"
            )
        owner = self.ownership.owner_of(t)
        if (
            owner is not None
            and owner[0] == dest
            and t not in self.ownership.inflight
        ):
            return {
                "status": "noop",
                "tenant": t,
                "owner": dest,
                "epoch": owner[1],
                "now": round(now, 6),
            }
        if owner is None:
            raise MigrationError(f"tenant {t} has no owner")
        src = owner[0]
        src_mw = self.workers.get(src)
        if src_mw is None or t not in src_mw.slot_of:
            raise MigrationError(
                f"tenant {t} owner {src!r} is not a managed worker "
                "holding the tenant"
            )
        if not dst_mw.spare_slots:
            raise MigrationError(
                f"destination {dest!r} has no spare arena slot for "
                f"tenant {t}"
            )
        if self._fenced_for(dest, t):
            raise MigrationError(
                f"destination {dest!r} is fenced for tenant {t} in "
                "its current epoch (it migrated the tenant away "
                "earlier; floors only rise)"
            )
        epoch = self.ownership.epoch + 1
        report: dict = {
            "status": "committed",
            "tenant": t,
            "source": src,
            "dest": dest,
            "epoch": epoch,
            "steps": [],
            "now": round(now, 6),
        }

        def stopped(step: str) -> bool:
            report["steps"].append(step)
            if stop_after == step:
                report["status"] = "stopped"
                report["stopped_after"] = step
                return True
            return False

        # 1. Journal the intent — durable BEFORE anything moves, so a
        # crash from here on is visibly mid-migration to recovery.
        self.ownership.migrate_intent(t, src, dest, epoch, now)
        self._gauge_inflight()
        if stopped("journal_intent"):
            return report

        # 2. Seal the tenant's front door: new admissions shed with
        # the standard queue_full refusal, queued work still drains.
        self._door(src, src_mw.slot_of.get(t), seal=(
            f"migrating tenant {t} -> {dest}"
        ))
        if stopped("seal_source"):
            return report

        # 3. Flush the sealed tenant's queued work through the wave
        # scheduler so the WAL tip reflects every admitted request.
        serving = self._serving.get(src)
        if serving is not None and serving[1] is not None:
            serving[1].drain(now)
        if stopped("drain_source"):
            return report

        # 4. Final checkpoint at the WAL tip: the clean adoption path
        # replays ZERO records.
        state = src_mw.arena.tenants[src_mw.slot_of[t]]
        src_mw.durability.checkpoint(state, t)
        if stopped("final_checkpoint"):
            return report

        # 5. Per-tenant durable fence at the bumped epoch: the source
        # can never write THIS tenant again (its siblings keep
        # serving), so adoption reads a frozen truth.
        WorkerDurability.write_fence(
            src_mw.durability.root, src, epoch, tenant=t
        )
        if stopped("fence_source_tenant"):
            return report

        # 6. Destination adoption — the SAME splice path failover
        # uses: newest checkpoint + committed-WAL suffix, spare slot
        # (zero recompiles), re-journal, immediate checkpoint.
        slot, rec = self.failover._absorb(
            t, src_mw.durability.epoch_dir, dst_mw
        )
        report["dest_slot"] = slot
        report["replayed_ops"] = rec["wal_records_replayed"]
        report["checkpoint"] = rec["checkpoint"]
        if self.metrics is not None and rec["wal_records_replayed"]:
            from hypervisor_tpu_torch.observability import metrics as mp

            self.metrics.inc(
                mp.REBALANCE_REPLAYED_OPS,
                rec["wal_records_replayed"],
            )
        if stopped("adopt_destination"):
            return report

        # 7. The atomic commit: ownership moves in ONE journal record,
        # then the source sheds its fenced copy (slot back to the
        # spare pool, WAL handle closed, door reopened for reuse).
        self.ownership.migrate_commit(t, now)
        self._detach_source(src_mw, t)
        self._gauge_inflight()
        report["steps"].append("journal_commit")
        report["ownership_digest"] = self.ownership.transition_digest()
        self.migrations.append(report)
        if self.metrics is not None:
            from hypervisor_tpu_torch.observability import metrics as mp

            self.metrics.inc(mp.REBALANCE_MIGRATIONS)
        return report

    # ── the failover race: abort + salvage ───────────────────────────

    def abort_inflight_for(
        self, dead: str, now: float, reason: str = "failover"
    ) -> list[dict]:
        """Abort every in-flight migration touching `dead` — called by
        `FailoverController.failover` BEFORE reassignment (failover
        wins the race). Each abort is journaled, a partial destination
        adoption is rolled back (slot to the spare pool, WAL handle
        closed, the half-written tenant dir removed — no orphaned
        epoch directories), and a live source reopens its door. When
        the DESTINATION died after the source's per-tenant fence
        burned, the drained tenant is salvaged onto a live worker
        through the same splice path."""
        out: list[dict] = []
        for t, rec in sorted(self.ownership.inflight.items()):
            if dead not in (rec["source"], rec["dest"]):
                continue
            src_mw = self.workers.get(rec["source"])
            dst_mw = self.workers.get(rec["dest"])
            self.ownership.migrate_abort(t, now, reason=str(reason))
            if dst_mw is not None:
                self._rollback_dest(dst_mw, t)
            entry = {
                "tenant": t,
                "source": rec["source"],
                "dest": rec["dest"],
                "epoch": rec["epoch"],
                "reason": str(reason),
                "now": round(float(now), 6),
                "salvaged": False,
            }
            if rec["source"] != dead and src_mw is not None:
                burned = (
                    src_mw.durability.fence_floor_for(t)
                    >= rec["epoch"]
                )
                if not burned:
                    # The source never lost the tenant: reopen its
                    # door and keep serving.
                    self._door(
                        rec["source"], src_mw.slot_of.get(t),
                        seal=None,
                    )
                else:
                    entry.update(
                        self._salvage(t, rec, src_mw, dead, now)
                    )
            self.aborted.append(entry)
            out.append(entry)
            if self.metrics is not None:
                from hypervisor_tpu_torch.observability import metrics as mp

                self.metrics.inc(mp.REBALANCE_ABORTED)
        self._gauge_inflight()
        return out

    def _salvage(
        self, t: int, rec: dict, src_mw: ManagedWorker, dead: str,
        now: float,
    ) -> dict:
        """The destination died AFTER the source's per-tenant fence
        burned: the source holds the tenant but can never write it.
        Recover the drained durable state (final checkpoint at the WAL
        tip) and splice it onto the least-loaded live worker at the
        intent's bumped epoch."""
        eligible = [
            w for wid, w in sorted(self.workers.items())
            if wid not in (dead, src_mw.worker_id)
            and w.spare_slots
            and not self._fenced_for(wid, t)
        ]
        if not eligible:
            # Leave the tenant on the fenced source: readable, not
            # writable — the loud degraded state, not a silent loss.
            return {"salvaged": False, "salvage": "no_target"}
        target = min(
            eligible, key=lambda w: (len(w.slot_of), w.worker_id)
        )
        slot, report = self.failover._absorb(
            t, src_mw.durability.epoch_dir, target
        )
        self._detach_source(src_mw, t)
        self.ownership.assign(
            src_mw.worker_id, src_mw.owned, rec["epoch"], now
        )
        self.ownership.assign(
            target.worker_id, target.owned, rec["epoch"], now
        )
        return {
            "salvaged": True,
            "salvage": target.worker_id,
            "slot": slot,
            "replayed_ops": report["wal_records_replayed"],
        }

    # ── physical bookkeeping ─────────────────────────────────────────

    def _rollback_dest(self, dst_mw: ManagedWorker, t: int) -> None:
        """Undo a partial (uncommitted) destination adoption: the
        spliced slot returns to the spare pool, the WAL handle closes,
        and the half-written tenant dir under the destination's epoch
        namespace is removed."""
        slot = dst_mw.slot_of.pop(t, None)
        if slot is not None:
            dst_mw.spare_slots.append(slot)
            dst_mw.spare_slots.sort()
            dst_mw.arena.tenants[slot].journal = None
        w = dst_mw.durability._wals.pop(t, None)
        if w is not None:
            w.close()
        shutil.rmtree(
            dst_mw.durability.tenant_dir(t), ignore_errors=True
        )

    def _detach_source(self, src_mw: ManagedWorker, t: int) -> None:
        """Shed the source's (fenced) copy after the tenant moved:
        slot back to the spare pool, WAL handle closed, door reopened
        for whatever splices there next."""
        slot = src_mw.slot_of.pop(t, None)
        if slot is not None:
            src_mw.spare_slots.append(slot)
            src_mw.spare_slots.sort()
            src_mw.arena.tenants[slot].journal = None
        w = src_mw.durability._wals.pop(t, None)
        if w is not None:
            w.close()
        self._door(src_mw.worker_id, slot, seal=None)

    def _door(
        self, worker_id: str, slot: Optional[int],
        seal: Optional[str],
    ) -> None:
        """Seal (detail string) or unseal (None) the door at a
        worker's arena slot, when a serving plane is attached."""
        serving = self._serving.get(str(worker_id))
        if serving is None or slot is None:
            return
        try:
            door = serving[0].doors[slot]
        except (AttributeError, IndexError, TypeError):
            return
        if seal is None:
            door.unseal()
        else:
            door.seal(seal)

    def _fenced_for(self, worker_id: str, tenant: int) -> bool:
        """True when the worker's per-tenant fence for `tenant` is
        above its own epoch — it sent the tenant away earlier in this
        epoch and can never write it again (floors only rise), so it
        is not an eligible destination."""
        w = self.workers.get(worker_id)
        if w is None:
            return True
        return (
            w.durability.fence_floor_for(tenant) > w.durability.epoch
        )

    def _gauge_inflight(self) -> None:
        if self.metrics is not None:
            from hypervisor_tpu_torch.observability import metrics as mp

            self.metrics.gauge_set(
                mp.REBALANCE_INFLIGHT, len(self.ownership.inflight)
            )

    # ── views ────────────────────────────────────────────────────────

    def summary(self, tail: int = 8) -> dict:
        """JSON-able controller view (what `GET /fleet/rebalance`
        serves): in-flight migrations, the committed/aborted history,
        and the current dry-run plan."""
        return {
            "inflight": {
                t: dict(rec)
                for t, rec in sorted(
                    self.ownership.inflight.items()
                )
            },
            "migrations": self.migrations[-tail:],
            "migration_count": len(self.migrations),
            "aborted": self.aborted[-tail:],
            "aborted_count": len(self.aborted),
            "plan": self.plan(0.0),
            "protocol_steps": list(PROTOCOL_STEPS),
            "epoch": self.ownership.epoch,
            "ownership_digest": self.ownership.transition_digest(),
        }


__all__ = [
    "MigrationError",
    "PROTOCOL_STEPS",
    "RebalanceController",
]
