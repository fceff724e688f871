"""Fleet failover: durable per-worker ownership + fenced reassignment.

The REASSIGNMENT half of push0's detect-and-reassign (PAPERS.md;
ROADMAP item 1). Round 18 built conviction (`fleet.registry` walks a
silent worker alive -> suspected -> dead on the caller's clock) and
round 19 froze the postmortem (`fleet.drain` captures the FLEET-scope
incident bundle at conviction). This module closes the loop: a dead
worker's tenants are recovered from its DURABLE state and absorbed by
survivors, and the dead worker — which may merely have been SIGSTOP'd
and can resume at any moment — is FENCED so it can never double-apply.

Three layers, each replay-deterministic:

* `WorkerDurability` — the per-worker durability namespace
  ``<root>/<worker_id>/epoch_<E>/tenant_<t>/{wal.log, step_<N>/}``
  plus the worker-level ``FENCE`` floor file. Namespacing by
  (worker id, fencing epoch, tenant) means two specs sharing one
  durability root can never collide, and `adopt()` REFUSES a worker
  directory that already carries a NEWER epoch — a zombie restarting
  with a stale spec fails loudly at startup, not silently at its first
  overwrite.
* `FencedWal` / the checkpoint fence — every WAL append and every
  checkpoint publication consults the durable fence floor FIRST:
  a stale-epoch writer raises `FencingError` with ZERO bytes on disk
  (`resilience.wal.WriteAheadLog.pre_append` fires before framing;
  `WorkerDurability.checkpoint` checks before `save_state`). A
  SIGSTOP'd-then-resumed worker wakes, tries to journal, and refuses —
  the double-apply window is closed at the durability boundary, not by
  trusting the dead process to stay dead.
* `OwnershipMap` — which worker owns which tenant set at which fencing
  epoch, journaled and digest-replayable exactly like `FleetRegistry`:
  `assign`/`fence` observations on the caller's clock, a sha256
  transition digest over replay keys, and a `replay()` classmethod
  that re-runs a journal bit-identically (the gate-6m pin).

`FailoverController.failover(dead, now)` is the reassignment state
machine: freeze the incident bundle (round 19's recorder), bump the
fencing epoch, write the zombie's durable fence floor, pick survivors
by deficit-aware spread (fewest owned tenants first, worker id as the
deterministic tiebreak), recover each orphaned tenant from its newest
durable checkpoint + committed-WAL suffix (`resilience.recovery.
recover_tenant` — the restore sequence per tenant), splice it into
the survivor's arena (`TenantArena.splice_tenant` — the `[T, …]`
shapes are fixed, so a warmed survivor absorbs with ZERO recompiles),
re-journal it under the survivor's own durability, checkpoint it there
immediately, and record the new ownership at the bumped epoch.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
from pathlib import Path
from typing import Callable, Optional

from hypervisor_tpu_torch.resilience.wal import WriteAheadLog

_EPOCH_RE = re.compile(r"^epoch_(\d+)$")
FENCE_FILE = "FENCE"


class FencingError(RuntimeError):
    """A stale-epoch writer was refused: WAL append, checkpoint
    publication, or directory adoption below the durable fence floor
    (or behind a newer epoch). Nothing was written."""


class FailoverError(RuntimeError):
    """The reassignment state machine could not complete (no survivors
    with spare capacity, unknown dead worker, ...)."""


# ── the per-worker durability namespace ──────────────────────────────


class WorkerDurability:
    """One worker's durable ground truth under a SHARED fleet root.

    Layout (everything the failover controller reads after a kill)::

        <root>/<worker_id>/
            FENCE                      # {"min_epoch": E} — durable floor
            epoch_<E>/
                manifest.json          # worker id, epoch, tenant set
                tenant_<t>/
                    wal.log            # that tenant's fenced WAL
                    step_<N>/          # per-tenant checkpoints (.done)

    The namespace is (worker id, fencing epoch, tenant): two specs
    sharing one root never collide, and epoch bumps give the zombie
    hazard a durable boundary — `adopt()` refuses when the worker dir
    already holds a NEWER epoch or the fence floor is above the
    adopter's epoch.
    """

    def __init__(
        self,
        root: str | Path,
        worker_id: str,
        epoch: int = 0,
        tenants=(),
        fsync: bool = True,
        metrics=None,
        emit: Optional[Callable[[str, dict], None]] = None,
    ) -> None:
        self.root = Path(root)
        self.worker_id = str(worker_id)
        self.epoch = int(epoch)
        self.tenants = tuple(int(t) for t in tenants)
        self.fsync = fsync
        self.metrics = metrics
        self.emit = emit
        self._wals: dict[int, "FencedWal"] = {}
        # Parsed FENCE doc cached keyed on the file's stat identity so
        # the append hot path pays one `stat` instead of a read+parse.
        self._fence_cache: Optional[tuple] = None

    # ── paths ────────────────────────────────────────────────────────

    @property
    def worker_dir(self) -> Path:
        return self.root / self.worker_id

    @property
    def epoch_dir(self) -> Path:
        return self.worker_dir / f"epoch_{self.epoch}"

    def tenant_dir(self, tenant: int) -> Path:
        return self.epoch_dir / f"tenant_{int(tenant)}"

    # ── adoption (satellite: loud refusal of newer epochs) ───────────

    @staticmethod
    def newest_epoch(root: str | Path, worker_id: str) -> Optional[int]:
        """Highest `epoch_<E>` under the worker dir, None when empty."""
        wdir = Path(root) / str(worker_id)
        if not wdir.is_dir():
            return None
        epochs = [
            int(m.group(1))
            for child in wdir.iterdir()
            if child.is_dir() and (m := _EPOCH_RE.match(child.name))
        ]
        return max(epochs) if epochs else None

    def adopt(self) -> "WorkerDurability":
        """Claim (create or resume) this worker's epoch namespace.

        Refuses — loudly, before touching anything — when the worker
        directory already records a NEWER epoch (a later incarnation or
        a completed failover owns the truth now) or when the durable
        fence floor is above this adopter's epoch (the failover
        controller fenced this worker while it was down)."""
        newest = self.newest_epoch(self.root, self.worker_id)
        if newest is not None and newest > self.epoch:
            raise FencingError(
                f"worker {self.worker_id!r} refusing to adopt epoch "
                f"{self.epoch}: the durability root already holds epoch "
                f"{newest} — a newer incarnation owns this namespace"
            )
        floor = self.fence_floor()
        if self.epoch < floor:
            raise FencingError(
                f"worker {self.worker_id!r} epoch {self.epoch} is below "
                f"the durable fence floor {floor} — fenced by a "
                "completed failover; this incarnation must not write"
            )
        self.epoch_dir.mkdir(parents=True, exist_ok=True)
        manifest = self.epoch_dir / "manifest.json"
        doc = {
            "worker_id": self.worker_id,
            "epoch": self.epoch,
            "tenants": list(self.tenants),
        }
        if manifest.exists():
            prior = json.loads(manifest.read_text())
            if prior.get("worker_id") != self.worker_id:
                raise FencingError(
                    f"epoch dir {self.epoch_dir} belongs to worker "
                    f"{prior.get('worker_id')!r}, not {self.worker_id!r}"
                )
        tmp = manifest.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(doc, sort_keys=True))
        os.replace(tmp, manifest)
        return self

    # ── the fence ────────────────────────────────────────────────────

    def fence_floor(self) -> int:
        """The durable minimum epoch allowed to write (0 = unfenced)."""
        return self._fence_doc()["min_epoch"]

    def fence_floor_for(self, tenant: int) -> int:
        """The effective floor for ONE tenant: max of the worker-level
        floor and that tenant's own floor (planned migration fences
        only the migrating tenant, leaving siblings writable)."""
        doc = self._fence_doc()
        return max(doc["min_epoch"], doc["tenants"].get(int(tenant), 0))

    @staticmethod
    def read_fence(root: str | Path, worker_id: str) -> int:
        return WorkerDurability.read_fence_doc(root, worker_id)[
            "min_epoch"
        ]

    @staticmethod
    def read_fence_doc(root: str | Path, worker_id: str) -> dict:
        """The full durable fence doc:
        ``{"min_epoch": E, "tenants": {t: E_t}}``. Legacy
        ``{"min_epoch": E}`` files parse with an empty tenant table.
        An unreadable/torn doc fails CLOSED: worker floor ``1 << 62``
        rather than letting a zombie write through a torn fence."""
        path = Path(root) / str(worker_id) / FENCE_FILE
        if not path.exists():
            return {"min_epoch": 0, "tenants": {}}
        try:
            doc = json.loads(path.read_text())
            return {
                "min_epoch": int(doc["min_epoch"]),
                "tenants": {
                    int(t): int(e)
                    for t, e in doc.get("tenants", {}).items()
                },
            }
        except (ValueError, KeyError, TypeError, AttributeError):
            return {"min_epoch": 1 << 62, "tenants": {}}

    @staticmethod
    def write_fence(
        root: str | Path,
        worker_id: str,
        min_epoch: int,
        tenant: Optional[int] = None,
    ) -> Path:
        """Durably raise a fence floor (atomic replace + fsync — the
        floor must survive the same crash the WAL does). Floors only
        ever rise: a lower write is ignored. With `tenant`, only THAT
        tenant's floor rises — a planned migration fences the
        migrating tenant while the source's other tenants keep
        serving; without, the worker-level floor rises."""
        wdir = Path(root) / str(worker_id)
        wdir.mkdir(parents=True, exist_ok=True)
        path = wdir / FENCE_FILE
        doc = WorkerDurability.read_fence_doc(root, worker_id)
        if tenant is None:
            doc["min_epoch"] = max(int(min_epoch), doc["min_epoch"])
        else:
            t = int(tenant)
            doc["tenants"][t] = max(
                int(min_epoch), doc["tenants"].get(t, 0)
            )
        out: dict = {"min_epoch": doc["min_epoch"]}
        if doc["tenants"]:
            out["tenants"] = {
                str(t): e for t, e in sorted(doc["tenants"].items())
            }
        tmp = wdir / (FENCE_FILE + ".tmp")
        with open(tmp, "w") as f:
            f.write(json.dumps(out, sort_keys=True))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path

    def _fence_doc(self) -> dict:
        """The parsed FENCE doc, cached keyed on the file's stat
        identity ``(st_ino, st_mtime_ns, st_size)`` so the WAL append
        path pays one `stat` instead of a read+parse per record.
        `write_fence` publishes via atomic replace — a new inode — so
        a fence bump is honored before the very next framed record. A
        torn doc parses to the fail-closed floor and caches exactly
        like a healthy one (keyed to the torn bytes)."""
        path = self.worker_dir / FENCE_FILE
        try:
            st = os.stat(path)
        except OSError:
            self._fence_cache = None
            return {"min_epoch": 0, "tenants": {}}
        key = (st.st_ino, st.st_mtime_ns, st.st_size)
        cached = self._fence_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        doc = self.read_fence_doc(self.root, self.worker_id)
        self._fence_cache = (key, doc)
        return doc

    def check_fence(self, tenant: Optional[int] = None) -> None:
        """Raise `FencingError` when this worker's epoch is below the
        durable floor — consulted before EVERY WAL append and EVERY
        checkpoint publication, so refusal happens with zero bytes
        written. A zombie that was SIGSTOP'd across the fence write
        wakes into the refusal: the atomic fence replace invalidates
        the stat-keyed cache. With `tenant`, the tenant's own floor is
        honored too (per-tenant migration fence)."""
        doc = self._fence_doc()
        floor = doc["min_epoch"]
        scope = f"worker {self.worker_id!r}"
        if tenant is not None:
            tfloor = doc["tenants"].get(int(tenant), 0)
            if tfloor > floor:
                floor = tfloor
                scope = (
                    f"worker {self.worker_id!r} tenant {int(tenant)}"
                )
        if self.epoch < floor:
            if self.metrics is not None:
                from hypervisor_tpu_torch.observability import metrics as mp

                self.metrics.inc(mp.FAILOVER_FENCED_APPENDS)
            if self.emit is not None:
                self.emit("fleet_worker_fenced", {
                    "worker": self.worker_id,
                    "epoch": self.epoch,
                    "fence_floor": floor,
                    "tenant": None if tenant is None else int(tenant),
                })
            raise FencingError(
                f"{scope} epoch {self.epoch} fenced "
                f"below floor {floor}: write refused (zero bytes)"
            )

    # ── durable writes (all fence-gated) ─────────────────────────────

    def wal(self, tenant: int) -> "FencedWal":
        """That tenant's fenced WAL (cached — one handle per tenant)."""
        t = int(tenant)
        w = self._wals.get(t)
        if w is None:
            self.check_fence(t)
            tdir = self.tenant_dir(t)
            tdir.mkdir(parents=True, exist_ok=True)
            w = FencedWal(
                tdir / "wal.log",
                fence_check=lambda t=t: self.check_fence(t),
                fsync=self.fsync,
            )
            self._wals[t] = w
        return w

    def checkpoint(self, state, tenant: int, step: Optional[int] = None):
        """One watermarked per-tenant checkpoint into the tenant's
        namespace — fence-checked BEFORE anything is written, so a
        fenced zombie can never publish a `.done` marker a recovery
        would trust."""
        from hypervisor_tpu_torch.resilience.recovery import (
            checkpoint_with_watermark,
        )

        self.check_fence(int(tenant))
        return checkpoint_with_watermark(
            state, self.tenant_dir(tenant), step=step
        )

    def close(self) -> None:
        for w in self._wals.values():
            w.close()
        self._wals.clear()

    def summary(self) -> dict:
        return {
            "worker_id": self.worker_id,
            "epoch": self.epoch,
            "tenants": list(self.tenants),
            "root": str(self.root),
            "fence_floor": self.fence_floor(),
            "tenant_fences": dict(
                sorted(self._fence_doc()["tenants"].items())
            ),
            "fenced_appends": sum(
                w.fenced_appends for w in self._wals.values()
            ),
        }


class FencedWal(WriteAheadLog):
    """A `WriteAheadLog` whose every append consults a fence check
    first (via the base class's `pre_append` hook — the gate fires
    before the record is framed, so a refusal writes ZERO bytes and
    the torn-tail/seq machinery never sees the attempt)."""

    def __init__(
        self,
        path: str | Path,
        fence_check: Callable[[], None],
        fsync: bool = True,
    ) -> None:
        super().__init__(path, fsync=fsync)
        self.fenced_appends = 0
        self._fence_check = fence_check
        self.pre_append = self._gate

    def _gate(self, doc: dict) -> None:
        try:
            self._fence_check()
        except FencingError:
            self.fenced_appends += 1
            raise


# ── the journaled ownership map ──────────────────────────────────────


@dataclasses.dataclass(frozen=True)
class OwnershipTransition:
    """One ownership change, keyed for replay like `LeaseTransition`."""

    seq: int
    kind: str      # "assign" | "fence" | "migrate_{intent,commit,abort}"
    worker: str    # migrate kinds record "source->dest"
    tenants: tuple
    epoch: int
    now: float     # caller's clock

    def replay_key(self) -> str:
        ts = ",".join(str(t) for t in self.tenants)
        return (
            f"{self.seq}|{self.kind}|{self.worker}|[{ts}]"
            f"|e{self.epoch}|{round(self.now, 6)}"
        )

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["tenants"] = list(self.tenants)
        return d


class OwnershipMap:
    """worker -> (tenant set, fencing epoch), journaled + replayable.

    The `FleetRegistry` discipline applied to ownership: every
    `assign`/`fence` takes the CALLER'S `now`, lands in an observation
    journal, and folds into a sha256 digest over replay keys —
    `replay()` re-runs a journal through a fresh map bit-identically,
    which is what lets gate 6m pin the whole reassignment state
    machine's determinism, not just the lease plane's.
    """

    def __init__(
        self,
        seed: int = 0,
        emit: Optional[Callable[[str, dict], None]] = None,
        metrics=None,
    ) -> None:
        self.seed = int(seed)
        self.emit = emit
        self.metrics = metrics
        self._owners: dict[str, dict] = {}
        self._fenced: dict[str, int] = {}
        self._inflight: dict[int, dict] = {}
        self.transitions: list[OwnershipTransition] = []
        self._observations: list[tuple] = []
        self._digest = hashlib.sha256(f"ownership:{self.seed}".encode())
        self._seq = 0

    # ── observations (the replayable journal) ────────────────────────

    def assign(
        self, worker: str, tenants, epoch: int, now: float
    ) -> None:
        """Record that `worker` owns exactly `tenants` at `epoch`
        (replacing its previous set). Epochs never regress: an assign
        below the map's current epoch is the zombie hazard showing up
        in the control plane and refuses loudly."""
        tset = tuple(sorted(int(t) for t in tenants))
        epoch = int(epoch)
        now = round(float(now), 6)
        if epoch < self.epoch:
            raise FencingError(
                f"ownership assign for {worker!r} at stale epoch "
                f"{epoch} (map is at {self.epoch})"
            )
        if epoch < self._fenced.get(worker, 0):
            raise FencingError(
                f"ownership assign for fenced worker {worker!r}: epoch "
                f"{epoch} below its fence floor {self._fenced[worker]}"
            )
        self._observations.append(("assign", worker, tset, epoch, now))
        self._owners[worker] = {"tenants": tset, "epoch": epoch}
        self._record("assign", worker, tset, epoch, now)
        if self.metrics is not None:
            from hypervisor_tpu_torch.observability import metrics as mp

            self.metrics.gauge_set(mp.FAILOVER_EPOCH, self.epoch)

    def fence(self, worker: str, min_epoch: int, now: float) -> None:
        """Journal that `worker` is fenced below `min_epoch` (the
        control-plane twin of the durable FENCE file)."""
        min_epoch = int(min_epoch)
        now = round(float(now), 6)
        self._observations.append(("fence", worker, min_epoch, now))
        self._fenced[worker] = max(
            min_epoch, self._fenced.get(worker, 0)
        )
        self._record("fence", worker, (), min_epoch, now)

    def migrate_intent(
        self, tenant: int, source: str, dest: str, epoch: int,
        now: float,
    ) -> None:
        """Journal PLANNED-migration intent: `tenant` will move
        source -> dest at the bumped `epoch`. Ownership does NOT
        change here — it moves only at the atomic `migrate_commit`
        record, so a crash anywhere between the two resolves with
        exactly-one owner (the source). Validates BEFORE journaling:
        a refused intent leaves no record."""
        t = int(tenant)
        epoch = int(epoch)
        now = round(float(now), 6)
        if t in self._inflight:
            rec = self._inflight[t]
            raise FailoverError(
                f"tenant {t} already has an in-flight migration "
                f"{rec['source']}->{rec['dest']} at epoch "
                f"{rec['epoch']}"
            )
        owner = self.owner_of(t)
        if owner is None or owner[0] != source:
            raise FailoverError(
                f"migrate intent for tenant {t}: source {source!r} is "
                f"not the owner (owner: {owner!r})"
            )
        if dest == source:
            raise FailoverError(
                f"migrate intent for tenant {t}: source and "
                f"destination are both {source!r}"
            )
        if epoch <= self.epoch:
            raise FencingError(
                f"migrate intent for tenant {t} at stale epoch "
                f"{epoch} (map is at {self.epoch}; intents must bump)"
            )
        self._observations.append(
            ("migrate_intent", t, source, dest, epoch, now)
        )
        self._inflight[t] = {
            "tenant": t, "source": source, "dest": dest,
            "epoch": epoch, "since": now,
        }
        self._record(
            "migrate_intent", f"{source}->{dest}", (t,), epoch, now
        )

    def migrate_commit(self, tenant: int, now: float) -> dict:
        """The single journal record at which ownership changes hands:
        the destination adopts the tenant at the intent's bumped
        epoch; the source's remaining tenants are untouched."""
        t = int(tenant)
        now = round(float(now), 6)
        rec = self._inflight.get(t)
        if rec is None:
            raise FailoverError(
                f"migrate commit for tenant {t}: no in-flight intent"
            )
        self._observations.append(("migrate_commit", t, now))
        del self._inflight[t]
        src_rec = self._owners.get(rec["source"])
        if src_rec is not None and t in src_rec["tenants"]:
            src_rec["tenants"] = tuple(
                x for x in src_rec["tenants"] if x != t
            )
        dst_rec = self._owners.setdefault(
            rec["dest"], {"tenants": (), "epoch": rec["epoch"]}
        )
        dst_rec["tenants"] = tuple(
            sorted(set(dst_rec["tenants"]) | {t})
        )
        dst_rec["epoch"] = max(dst_rec["epoch"], rec["epoch"])
        self._record(
            "migrate_commit",
            f"{rec['source']}->{rec['dest']}", (t,), rec["epoch"], now,
        )
        if self.metrics is not None:
            from hypervisor_tpu_torch.observability import metrics as mp

            self.metrics.gauge_set(mp.FAILOVER_EPOCH, self.epoch)
        return dict(rec)

    def migrate_abort(
        self, tenant: int, now: float, reason: str = ""
    ) -> dict:
        """Journal that an in-flight migration was abandoned (crash,
        failover race, operator abort). Ownership never moved, so no
        ownership mutation — the record exists so replay and the
        postmortem see WHY the intent has no commit."""
        t = int(tenant)
        now = round(float(now), 6)
        rec = self._inflight.get(t)
        if rec is None:
            raise FailoverError(
                f"migrate abort for tenant {t}: no in-flight intent"
            )
        self._observations.append(
            ("migrate_abort", t, now, str(reason))
        )
        del self._inflight[t]
        self._record(
            "migrate_abort",
            f"{rec['source']}->{rec['dest']}", (t,), rec["epoch"], now,
        )
        return dict(rec)

    # ── transition log + digest (the FleetRegistry discipline) ───────

    def _record(
        self, kind: str, worker: str, tenants: tuple, epoch: int,
        now: float,
    ) -> None:
        t = OwnershipTransition(
            self._seq, kind, worker, tenants, epoch, now
        )
        self._seq += 1
        self.transitions.append(t)
        self._digest.update(t.replay_key().encode())
        if self.emit is not None:
            self.emit(_EMIT_KIND[kind], {
                "worker": worker, "seq": t.seq, "tenants": list(tenants),
                "epoch": epoch, "now": now,
            })

    def transition_digest(self) -> str:
        return self._digest.hexdigest()

    # ── views ────────────────────────────────────────────────────────

    @property
    def epoch(self) -> int:
        """The map's current fencing epoch (max across live assigns)."""
        return max(
            (rec["epoch"] for rec in self._owners.values()), default=0
        )

    def owner_of(self, tenant: int) -> Optional[tuple[str, int]]:
        """(worker, epoch) currently owning `tenant`, None if orphan."""
        t = int(tenant)
        best = None
        for worker in sorted(self._owners):
            rec = self._owners[worker]
            if t in rec["tenants"]:
                if best is None or rec["epoch"] > best[1]:
                    best = (worker, rec["epoch"])
        return best

    def tenants_of(self, worker: str) -> tuple:
        rec = self._owners.get(worker)
        return () if rec is None else rec["tenants"]

    def is_fenced(self, worker: str, epoch: int) -> bool:
        return int(epoch) < self._fenced.get(worker, 0)

    @property
    def inflight(self) -> dict:
        """tenant -> in-flight migration record (intent journaled,
        commit/abort not yet)."""
        return {t: dict(rec) for t, rec in self._inflight.items()}

    @property
    def observations(self) -> tuple:
        return tuple(self._observations)

    def summary(self, tail: int = 16) -> dict:
        """JSON-able ownership view (what `GET /fleet/ownership`
        serves)."""
        return {
            "seed": self.seed,
            "epoch": self.epoch,
            "owners": {
                w: {
                    "tenants": list(rec["tenants"]),
                    "epoch": rec["epoch"],
                }
                for w, rec in sorted(self._owners.items())
            },
            "fenced": dict(sorted(self._fenced.items())),
            "inflight": {
                t: dict(rec)
                for t, rec in sorted(self._inflight.items())
            },
            "transitions": [
                t.to_dict() for t in self.transitions[-tail:]
            ],
            "transition_count": len(self.transitions),
            "transition_digest": self.transition_digest(),
        }

    # ── replay ───────────────────────────────────────────────────────

    @classmethod
    def replay(cls, observations, seed: int = 0) -> "OwnershipMap":
        """Re-run a recorded journal through a fresh map (no emit, no
        metrics — pure state machine; same seed + same observations =>
        identical transition log and digest)."""
        m = cls(seed=seed)
        for obs in observations:
            if obs[0] == "assign":
                m.assign(obs[1], obs[2], obs[3], obs[4])
            elif obs[0] == "fence":
                m.fence(obs[1], obs[2], obs[3])
            elif obs[0] == "migrate_intent":
                m.migrate_intent(
                    obs[1], obs[2], obs[3], obs[4], obs[5]
                )
            elif obs[0] == "migrate_commit":
                m.migrate_commit(obs[1], obs[2])
            elif obs[0] == "migrate_abort":
                m.migrate_abort(obs[1], obs[2], obs[3])
            else:  # pragma: no cover — unknown journal rows are a bug
                raise ValueError(f"unknown observation {obs!r}")
        return m


_EMIT_KIND = {
    "assign": "fleet_ownership_changed",
    "fence": "fleet_worker_fenced",
    "migrate_intent": "fleet_rebalance_planned",
    "migrate_commit": "fleet_tenant_migrated",
    "migrate_abort": "fleet_migration_aborted",
}


# ── the reassignment state machine ───────────────────────────────────


@dataclasses.dataclass
class ManagedWorker:
    """One worker the controller can reassign to/from: its arena, its
    durability namespace, and the global-tenant -> arena-slot map.
    `spare_slots` are pre-provisioned (warmed) arena slots a splice can
    land in WITHOUT changing the `[T, …]` program shapes — the
    zero-recompile absorb contract."""

    worker_id: str
    arena: object                    # tenancy.arena.TenantArena
    durability: WorkerDurability
    slot_of: dict = dataclasses.field(default_factory=dict)
    spare_slots: list = dataclasses.field(default_factory=list)

    @property
    def owned(self) -> tuple:
        return tuple(sorted(self.slot_of))


class FailoverController:
    """Executes detect-and-reassign's reassign half when the lease
    plane convicts a worker dead.

    Deterministic by construction: `failover()` takes the caller's
    `now`, survivor choice is deficit-aware spread with the worker id
    as tiebreak, per-tenant recovery is the deterministic restore
    sequence, and every control-plane effect lands in the journaled
    `OwnershipMap` — two runs of the same drill produce bit-identical
    ownership digests (gate 6m).
    """

    def __init__(
        self,
        ownership: OwnershipMap,
        config=None,
        emit: Optional[Callable[[str, dict], None]] = None,
        metrics=None,
        observatory=None,
    ) -> None:
        self.ownership = ownership
        self.config = config
        self.emit = emit if emit is not None else ownership.emit
        self.metrics = metrics
        self.observatory = observatory
        self.workers: dict[str, ManagedWorker] = {}
        self.reassignments: list[dict] = []
        # Set by fleet.rebalance.RebalanceController: failover aborts
        # any in-flight planned migration touching the dead worker
        # before reassigning (failover wins the race).
        self.rebalance = None

    def register(self, worker: ManagedWorker, now: float = 0.0) -> None:
        """Track a worker and journal its initial ownership at its
        durability epoch."""
        self.workers[worker.worker_id] = worker
        self.ownership.assign(
            worker.worker_id, worker.owned, worker.durability.epoch, now
        )

    # ── survivor choice: deficit-aware spread ────────────────────────

    def _spread(self, tenants, survivors) -> dict[int, ManagedWorker]:
        """tenant -> survivor, always the survivor with the FEWEST
        owned tenants that still has a spare slot (worker id breaks
        ties deterministically); loads update as assignments land so a
        burst of orphans spreads instead of piling onto one worker."""
        loads = {w.worker_id: len(w.slot_of) for w in survivors}
        spares = {w.worker_id: len(w.spare_slots) for w in survivors}
        out: dict[int, ManagedWorker] = {}
        for tenant in sorted(int(t) for t in tenants):
            # A survivor whose per-tenant fence for THIS tenant burned
            # (it migrated the tenant away earlier) can never write it
            # again within its current epoch — not a landing spot.
            eligible = [
                w for w in survivors
                if spares[w.worker_id] > 0
                and w.durability.fence_floor_for(tenant)
                <= w.durability.epoch
            ]
            if not eligible:
                raise FailoverError(
                    f"no survivor has a spare arena slot for tenant "
                    f"{tenant} (survivors: "
                    f"{[w.worker_id for w in survivors]})"
                )
            target = min(
                eligible,
                key=lambda w: (loads[w.worker_id], w.worker_id),
            )
            out[tenant] = target
            loads[target.worker_id] += 1
            spares[target.worker_id] -= 1
        return out

    # ── the shared splice path ───────────────────────────────────────

    def _absorb(
        self, tenant: int, source_epoch_dir, target: ManagedWorker
    ) -> tuple[int, dict]:
        """Recover one tenant from a durable epoch namespace and
        splice it into `target`'s arena: newest checkpoint +
        committed-WAL suffix, spare slot (the `[T, …]` shapes are
        fixed — zero recompiles), re-journal under the target's own
        durability, checkpoint there immediately. Crash failover and
        planned rebalancing share THIS path, so a migration crash
        degrades into the already-proven recovery, not a new mode."""
        from hypervisor_tpu_torch.resilience.recovery import recover_tenant

        # Recovery config: the target arena's own config unless the
        # controller was built with an explicit one (capacities must
        # match the donor's checkpoint — restore validates). The state
        # is recovered onto the target arena's own torch device.
        cfg = (
            self.config
            if self.config is not None
            else target.arena.config
        )
        state, report = recover_tenant(
            source_epoch_dir, tenant, config=cfg,
            device=target.arena.device,
        )
        slot = target.spare_slots.pop(0)
        target.arena.splice_tenant(slot, state)
        target.slot_of[tenant] = slot
        # Re-journal under the TARGET's durability and checkpoint
        # there immediately: the absorbed tenant is durable on its new
        # owner before the move is declared complete.
        spliced = target.arena.tenants[slot]
        spliced.journal = target.durability.wal(tenant)
        target.durability.checkpoint(spliced, tenant)
        return slot, report

    # ── the state machine ────────────────────────────────────────────

    def failover(self, dead: str, now: float) -> dict:
        """Reassign a convicted-dead worker's tenants to survivors.

        Order matters and is part of the contract:
          1. freeze the incident bundle (round 19's recorder) — the
             postmortem must capture the PRE-reassignment fleet;
          2. durably fence the zombie at the bumped epoch BEFORE any
             recovery read — from this point its appends/publications
             refuse, so recovery reads a frozen truth;
          3. recover + splice each tenant (deficit-aware spread);
          4. journal the new ownership at the bumped epoch.
        """
        dead_mw = self.workers.get(dead)
        if dead_mw is None:
            raise FailoverError(f"unknown dead worker {dead!r}")
        # Failover-vs-rebalance race: failover WINS. Abort (and, when
        # the source's per-tenant fence is already burned, salvage)
        # any in-flight planned migration touching the dead worker
        # FIRST — the abort is journaled, so `new_epoch` below is
        # computed against the post-abort map.
        if self.rebalance is not None:
            self.rebalance.abort_inflight_for(
                dead, now, reason=f"failover:{dead}"
            )
        orphans = self.ownership.tenants_of(dead) or dead_mw.owned
        new_epoch = self.ownership.epoch + 1

        # 1. freeze the postmortem (best-effort: a missing recorder
        # must not block reassignment).
        obs = self.observatory
        if obs is not None:
            try:
                obs._capture_dead_transitions()
            except Exception:  # noqa: BLE001 — hindsight, not control
                pass

        # 2. fence the zombie: durable floor first (the boundary a
        # resumed process actually hits), then the journal.
        WorkerDurability.write_fence(
            dead_mw.durability.root, dead, new_epoch
        )
        self.ownership.fence(dead, new_epoch, now)

        # 3. survivors by deficit-aware spread, then recover + splice.
        survivors = [
            w for wid, w in sorted(self.workers.items()) if wid != dead
        ]
        if not survivors and orphans:
            raise FailoverError(
                f"worker {dead!r} died owning {list(orphans)} with no "
                "survivors registered"
            )
        assignment = self._spread(orphans, survivors)

        replayed = 0
        verified = 0
        per_tenant: dict[int, dict] = {}
        for tenant, target in assignment.items():
            slot, report = self._absorb(
                tenant, dead_mw.durability.epoch_dir, target
            )
            replayed += report["wal_records_replayed"]
            verified += report["audit_sessions_verified"]
            per_tenant[tenant] = {
                "survivor": target.worker_id,
                "slot": slot,
                "replayed_ops": report["wal_records_replayed"],
                "checkpoint": report["checkpoint"],
            }
        dead_mw.slot_of = {}

        # 4. the new ownership, journaled at the bumped epoch.
        touched = sorted({w.worker_id for w in assignment.values()})
        for wid in touched:
            w = self.workers[wid]
            self.ownership.assign(wid, w.owned, new_epoch, now)
        self.ownership.assign(dead, (), new_epoch, now)

        if self.metrics is not None:
            from hypervisor_tpu_torch.observability import metrics as mp

            self.metrics.inc(mp.FAILOVER_REASSIGNMENTS)
            self.metrics.inc(
                mp.FAILOVER_TENANTS_REASSIGNED, len(assignment)
            )
            if replayed:
                self.metrics.inc(mp.FAILOVER_REPLAYED_OPS, replayed)
            self.metrics.gauge_set(mp.FAILOVER_EPOCH, new_epoch)
        report = {
            "dead": dead,
            "epoch": new_epoch,
            "tenants": {int(t): d for t, d in sorted(per_tenant.items())},
            "replayed_ops": replayed,
            "audit_sessions_verified": verified,
            "survivors": touched,
            "now": round(float(now), 6),
            "ownership_digest": self.ownership.transition_digest(),
        }
        self.reassignments.append(report)
        if self.emit is not None:
            self.emit("fleet_tenants_reassigned", {
                "dead": dead,
                "epoch": new_epoch,
                "assignment": {
                    str(t): d["survivor"]
                    for t, d in sorted(per_tenant.items())
                },
                "replayed_ops": replayed,
                "now": round(float(now), 6),
            })
        return report

    def summary(self, tail: int = 8) -> dict:
        """JSON-able controller view (what `GET /fleet/failover`
        serves)."""
        return {
            "workers": {
                wid: {
                    "tenants": list(w.owned),
                    "spare_slots": len(w.spare_slots),
                    "epoch": w.durability.epoch,
                    "fence_floor": w.durability.fence_floor(),
                }
                for wid, w in sorted(self.workers.items())
            },
            "reassignments": self.reassignments[-tail:],
            "reassignment_count": len(self.reassignments),
            "epoch": self.ownership.epoch,
            "ownership_digest": self.ownership.transition_digest(),
        }


__all__ = [
    "FailoverController",
    "FailoverError",
    "FencedWal",
    "FencingError",
    "ManagedWorker",
    "OwnershipMap",
    "OwnershipTransition",
    "WorkerDurability",
]
