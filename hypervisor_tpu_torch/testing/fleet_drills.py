"""The fleet's two seeded drills on a torch device: the failover drill
and the rebalancing soak.

Both are in-process 3-worker fleets on a VIRTUAL clock, each worker a
`TenantArena` with a `TenantFrontDoor` and a `TenantWaveScheduler` over
its own `WorkerDurability` namespace, driven by the seeded
`WaveChaosPlan`'s fleet faults (the reference's `failover` and
`fleet_soak` rows of `benchmarks/bench_suite.py`, same seeds, rounds and
traffic, so the ownership transition digest is the reference's):

* `failover_drill` — lifecycle rounds, a checkpoint, a WAL suffix, then
  `w0` SIGKILLed (silent); the lease registry convicts it, the
  `FailoverController` recovers its two tenants onto the survivors'
  device and splices them in; the zombie's resume append refuses with
  zero bytes; the survivors serve on. Two full runs give one digest.
* `fleet_soak` — 6 tenants on 3 workers, rolling planned rebalances, a
  plain SIGKILL failover, and a second kill mid-migration (source
  drained but unfenced: failover wins the race); exactly-one ownership
  checked from the journal every round.

Every arena lives on `device` (the card unless the caller asks for the
CPU). Walls are host `perf_counter` readings around calls whose results
are read back to the host (the scheduler's lanes), so they cover the
device time. `recompiles_*` are the port's novel abstract signatures
(there is no jit cache).
"""

from __future__ import annotations

import tempfile
import time
from pathlib import Path


#: Full runs of each drill; their ownership digests must agree.
REPLAYS = 2


def _pct(vals, q: float) -> float:
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(q * len(vals)))]


def _build(root, wid, tenants, n_slots, cfg, device):
    from hypervisor_tpu_torch.fleet.failover import ManagedWorker, WorkerDurability
    from hypervisor_tpu_torch.serving import ServingConfig
    from hypervisor_tpu_torch.tenancy import TenantArena, TenantFrontDoor, TenantWaveScheduler

    arena = TenantArena(n_slots, cfg, device=device)
    front = TenantFrontDoor(arena, ServingConfig(buckets=(4, 8)))
    sched = TenantWaveScheduler(front)
    sched.warm(now=0.0)
    dur = WorkerDurability(root, wid, epoch=0, tenants=tenants, fsync=False).adopt()
    slot_of = {}
    for slot, t in enumerate(tenants):
        arena.tenants[slot].journal = dur.wal(t)
        slot_of[t] = slot
    mw = ManagedWorker(wid, arena, dur, slot_of, list(range(len(tenants), n_slots)))
    return mw, front, sched


def _lifecycle_round(mw, front, sched, r, now, tag, seed) -> int:
    for t, slot in sorted(mw.slot_of.items()):
        front.submit_lifecycle(
            slot, f"{mw.worker_id}:r{r}:{t}",
            f"did:{tag}:{seed}:{mw.worker_id}:{r}:{t}", 0.8, now=now,
        )
    sched.lifecycle_round(now)
    return len(mw.slot_of)


def _recompiles() -> int:
    from hypervisor_tpu_torch.observability import health

    return health.compile_summary()["recompiles"]


def zombie_resume(durability, tenant) -> tuple[int, int, int]:
    """(fenced, double-applied records, wal.log bytes added) of one resume
    append on a dead worker's durable copy of `tenant`."""
    from hypervisor_tpu_torch.fleet.failover import FencingError
    from hypervisor_tpu_torch.resilience.wal import scan

    wal = durability.tenant_dir(tenant) / "wal.log"
    before, size = len(scan(wal).committed), wal.stat().st_size
    fenced = 0
    try:
        with durability.wal(tenant).txn("zombie_resume", {}):
            pass
    except FencingError:
        fenced = 1
    return fenced, len(scan(wal).committed) - before, wal.stat().st_size - size


def failover_run(root, seed: int = 20, quick: bool = True, device="cuda") -> dict:
    """One run of the kill-one-worker reassignment drill under `root`."""
    from hypervisor_tpu_torch.fleet import DEAD, FleetRegistry, LeaseConfig
    from hypervisor_tpu_torch.fleet.failover import FailoverController, OwnershipMap
    from hypervisor_tpu_torch.fleet.worker import _small_capacity_config
    from hypervisor_tpu_torch.testing.chaos import (
        InjectedFleetFault,
        WaveChaosInjector,
        WaveChaosPlan,
    )

    cfg = _small_capacity_config()
    lease = LeaseConfig(heartbeat_interval_s=0.25)
    base = 1000.0 + (seed % 997)
    pre_rounds = 2 if quick else 4
    suffix_rounds = 2 if quick else 4
    post_rounds = 4 if quick else 10
    kill_round = pre_rounds + suffix_rounds  # after the WAL suffix
    plan = WaveChaosPlan(seed=seed, fleet_faults=(
        InjectedFleetFault("worker_sigkill", at_round=kill_round, worker="w0"),
    ))

    def lifecycle_round(mw, front, sched, r, now):
        _lifecycle_round(mw, front, sched, r, now, "fo", seed)

    inj = WaveChaosInjector(plan)
    w0, f0, s0 = _build(root, "w0", (0, 1), 2, cfg, device)
    w1, f1, s1 = _build(root, "w1", (2,), 3, cfg, device)
    w2, f2, s2 = _build(root, "w2", (3,), 3, cfg, device)
    fleet = {"w0": (w0, f0, s0), "w1": (w1, f1, s1), "w2": (w2, f2, s2)}
    reg = FleetRegistry(lease, seed=seed)
    om = OwnershipMap(seed=seed)
    ctl = FailoverController(om, config=cfg)
    now = base
    for wid in sorted(fleet):
        reg.register(wid, now)
        ctl.register(fleet[wid][0], now=now)

    dead_set: set[str] = set()
    detection = {"killed_round": None, "dead": None}
    round_no = 0
    checkpointed = False
    while detection["dead"] is None:
        round_no += 1
        for fault in inj.take_fleet_faults(round_no):
            if fault.kind == "worker_sigkill":
                dead_set.add(fault.worker)
                detection["killed_round"] = round_no
        for wid, (mw, front, sched) in sorted(fleet.items()):
            if wid in dead_set:
                continue  # a SIGKILLed worker is SILENT
            if mw.slot_of:
                lifecycle_round(mw, front, sched, round_no, now)
            reg.heartbeat(wid, now)
        # Evaluate at the SAME instant as the beats (a live worker is 0
        # windows stale); the clock then advances one window, so a
        # silent worker ages exactly 1 window per round.
        for worker, new in reg.evaluate(now).items():
            if new == DEAD and worker in dead_set:
                detection["dead"] = round_no
        now += lease.heartbeat_interval_s
        if round_no == pre_rounds:
            w0.arena.sync()
            for t, slot in sorted(w0.slot_of.items()):
                w0.durability.checkpoint(w0.arena.tenants[slot], t, step=1)
            checkpointed = True
        if round_no > 200:  # pragma: no cover — runaway guard
            raise RuntimeError("lease plane never convicted w0")
    assert checkpointed
    w0.arena.sync()
    for slot in w0.slot_of.values():
        w0.arena.tenants[slot].journal.flush()

    # ── the reassignment ──
    recomp_absorb = _recompiles()
    t0 = time.perf_counter()
    report = ctl.failover("w0", now=round(now, 6))
    absorb_wall_s = time.perf_counter() - t0
    absorb_recompiles = _recompiles() - recomp_absorb

    # ── the zombie: resume the dead worker's WAL, refuse with zero bytes.
    fenced, double_applied, bytes_added = zombie_resume(w0.durability, 0)

    # ── post-splice serving on the survivors ──
    recomp_before = _recompiles()
    walls = []
    for _ in range(post_rounds):
        round_no += 1
        for wid in ("w1", "w2"):
            mw, front, sched = fleet[wid]
            t0 = time.perf_counter()
            lifecycle_round(mw, front, sched, round_no, now)
            walls.append((time.perf_counter() - t0) * 1e3)
        now += lease.heartbeat_interval_s
    return {
        "detect_windows": detection["dead"] - detection["killed_round"],
        "absorb_wall_s": absorb_wall_s,
        "absorb_recompiles": absorb_recompiles,
        "replayed_ops": report["replayed_ops"],
        "tenants_reassigned": len(report["tenants"]),
        "survivors": report["survivors"],
        "ownership_digest": report["ownership_digest"],
        "fenced": fenced,
        "double_applied_ops": double_applied,
        "zombie_bytes_written": bytes_added,
        "post_splice_walls_ms": walls,
        "recompiles_after_splice": _recompiles() - recomp_before,
        "report": report,
    }


def failover_drill(seed: int = 20, quick: bool = True, device="cuda") -> dict:
    """The reference's `failover` row, its keys and values, from
    `REPLAYS` full runs; `post_splice_walls_ms` and `absorb_wall_s`
    unrounded beside it."""
    runs = []
    with tempfile.TemporaryDirectory() as td:
        for i in range(REPLAYS):
            runs.append(failover_run(Path(td) / f"run{i}", seed, quick, device))
    a = runs[0]
    walls = sorted(a["post_splice_walls_ms"])
    slo_p99_ms = 750.0
    heartbeat_s = 0.25
    return {
        "seed": seed,
        "quick": quick,
        "workers": 3,
        "killed": "w0",
        "detection_windows": a["detect_windows"],
        "budget_windows": 2,
        "absorb_wall_s": round(a["absorb_wall_s"], 4),
        "absorb_windows": round(a["absorb_wall_s"] / heartbeat_s, 2),
        "replayed_ops": a["replayed_ops"],
        "tenants_reassigned": a["tenants_reassigned"],
        "survivors": a["survivors"],
        "zombie_fenced": bool(a["fenced"]),
        "double_applied_ops": a["double_applied_ops"],
        "post_splice_rounds": len(walls),
        "post_splice_wall_ms": {"p50": round(_pct(walls, 0.50), 2),
                                "p99": round(_pct(walls, 0.99), 2)},
        "slo_p99_ms": slo_p99_ms,
        "slo_ok": _pct(walls, 0.99) <= slo_p99_ms,
        "recompiles_after_splice": a["recompiles_after_splice"],
        "replays": REPLAYS,
        "digest_match": float(all(r["ownership_digest"] == a["ownership_digest"] for r in runs)
                              and bool(a["ownership_digest"])),
        "ownership_digest": a["ownership_digest"],
        # The port's own readings beside the row.
        "absorb_wall_s_unrounded": [r["absorb_wall_s"] for r in runs],
        "absorb_recompiles": [r["absorb_recompiles"] for r in runs],
        "post_splice_walls_ms": a["post_splice_walls_ms"],
        "zombie_bytes_written": a["zombie_bytes_written"],
        "digests": [r["ownership_digest"] for r in runs],
    }


def soak_run(root, seed: int = 21, quick: bool = True, device="cuda") -> dict:
    """One run of the rebalancing soak under `root`."""
    from hypervisor_tpu_torch.config import DEFAULT_CONFIG, TableCapacity
    from hypervisor_tpu_torch.fleet import DEAD, FleetRegistry, LeaseConfig
    from hypervisor_tpu_torch.fleet.failover import FailoverController, OwnershipMap
    from hypervisor_tpu_torch.fleet.rebalance import RebalanceController
    from hypervisor_tpu_torch.testing.chaos import (
        InjectedFleetFault,
        WaveChaosInjector,
        WaveChaosPlan,
    )

    lease = LeaseConfig(heartbeat_interval_s=0.25)
    base = 2000.0 + (seed % 997)
    rounds = 135 if quick else 220
    # The small-table config, with the session table sized to the soak:
    # one lifecycle session lands per tenant per round and parked
    # sessions accrue, so a worker that ends up owning every tenant
    # needs ~`rounds` rows per tenant slot.
    cfg = DEFAULT_CONFIG.replace(capacity=TableCapacity(
        max_agents=64, max_sessions=rounds + 64, max_vouch_edges=64,
        max_sagas=16, max_steps_per_saga=4, max_elevations=16,
        delta_log_capacity=1024, event_log_capacity=64,
        trace_log_capacity=64,
    ))
    rebalance_every = 9
    checkpoint_every = 20
    kill1_round = rounds // 3        # plain SIGKILL (w0)
    kill2_round = (2 * rounds) // 3  # SIGKILL mid-migration (w1)
    plan = WaveChaosPlan(seed=seed, fleet_faults=(
        InjectedFleetFault("worker_sigkill", at_round=kill1_round, worker="w0"),
        InjectedFleetFault("migration_kill_source", at_round=kill2_round, worker="w1"),
    ))

    def flush_worker(mw):
        mw.arena.sync()
        for slot in mw.slot_of.values():
            journal = mw.arena.tenants[slot].journal
            if journal is not None:
                journal.flush()

    inj = WaveChaosInjector(plan)
    fleet = {
        "w0": _build(root, "w0", (0, 1, 2), 5, cfg, device),
        "w1": _build(root, "w1", (3, 4), 5, cfg, device),
        "w2": _build(root, "w2", (5,), 8, cfg, device),
    }
    all_tenants = tuple(range(6))
    reg = FleetRegistry(lease, seed=seed)
    om = OwnershipMap(seed=seed)
    ctl = FailoverController(om, config=cfg)
    reb = RebalanceController(om, ctl)
    now = base
    for wid in sorted(fleet):
        mw, front, sched = fleet[wid]
        reg.register(wid, now)
        ctl.register(mw, now=now)
        reb.attach_serving(wid, front, sched)
        # Every tenant durable from round 0: a kill at ANY round must
        # recover from a checkpoint + committed-WAL suffix.
        mw.arena.sync()
        for t, slot in sorted(mw.slot_of.items()):
            mw.durability.checkpoint(mw.arena.tenants[slot], t, step=0)

    dead_set: set[str] = set()
    failed_over: dict[str, dict] = {}
    dead_tenants: dict[str, list[int]] = {}
    walls: dict[str, list[float]] = {w: [] for w in fleet}
    failover_walls: list[float] = []
    rebalance_walls: list[float] = []
    out = {"sessions": 0, "rebalance_runs": 0, "migration_replayed_ops": 0,
           "failover_replayed_ops": 0, "zombies_fenced": 0, "double_applied_ops": 0,
           "zombie_bytes_written": 0, "ownership_violations": 0,
           "migrations_interrupted": 0, "failover_replay_compiles": 0}
    recomp_base = None

    def least_loaded_dest(src):
        cands = [
            (len(mw.slot_of), wid)
            for wid, (mw, _f, _s) in fleet.items()
            if wid != src
            and wid not in dead_set
            and mw.spare_slots
            and not reb._fenced_for(wid, min(fleet[src][0].slot_of))
        ]
        return min(cands)[1] if cands else None

    for r in range(1, rounds + 1):
        for fault in inj.take_fleet_faults(r):
            if fault.kind == "worker_sigkill":
                dead_tenants[fault.worker] = sorted(fleet[fault.worker][0].slot_of)
                dead_set.add(fault.worker)
            elif fault.kind == "migration_kill_source":
                src = fault.worker
                src_mw = fleet[src][0]
                if src_mw.slot_of:
                    t = min(src_mw.slot_of)
                    dst = least_loaded_dest(src)
                    if dst is not None:
                        # Source dies drained-but-unfenced: the worst
                        # planned/crash interleaving.
                        reb.migrate(t, dst, now, stop_after="drain_source")
                        out["migrations_interrupted"] += 1
                dead_tenants[src] = sorted(src_mw.slot_of)
                dead_set.add(src)
        for wid in sorted(fleet):
            mw, front, sched = fleet[wid]
            if wid in dead_set:
                continue  # a SIGKILLed worker is SILENT
            if mw.slot_of:
                t0 = time.perf_counter()
                out["sessions"] += _lifecycle_round(mw, front, sched, r, now, "soak", seed)
                walls[wid].append((time.perf_counter() - t0) * 1e3)
            reg.heartbeat(wid, now)
        for worker, new in reg.evaluate(now).items():
            if new == DEAD and worker in dead_set and worker not in failed_over:
                flush_worker(fleet[worker][0])
                # A first replay may meet novel signatures; they are
                # counted apart as `failover_replay_compiles`.
                rc0 = _recompiles()
                t0 = time.perf_counter()
                report = ctl.failover(worker, now=round(now, 6))
                failover_walls.append((time.perf_counter() - t0) * 1e3)
                out["failover_replay_compiles"] += _recompiles() - rc0
                failed_over[worker] = report
                out["failover_replayed_ops"] += report["replayed_ops"]
                # The zombie: the dead worker's fenced WAL must refuse
                # its resume append with ZERO bytes.
                fenced, doubled, added = zombie_resume(
                    fleet[worker][0].durability, dead_tenants[worker][0])
                out["zombies_fenced"] += fenced
                out["double_applied_ops"] += doubled
                out["zombie_bytes_written"] += added
        now += lease.heartbeat_interval_s
        if r % rebalance_every == 0 and not (dead_set - set(failed_over)):
            out["rebalance_runs"] += 1
            t0 = time.perf_counter()
            res = reb.execute(now)
            rebalance_walls.append((time.perf_counter() - t0) * 1e3)
            for m in res["results"]:
                if m.get("status") == "committed":
                    out["migration_replayed_ops"] += m["replayed_ops"]
        if r % checkpoint_every == 0:
            for wid in sorted(fleet):
                if wid in dead_set:
                    continue
                mw = fleet[wid][0]
                mw.arena.sync()
                for t, slot in sorted(mw.slot_of.items()):
                    mw.durability.checkpoint(mw.arena.tenants[slot], t, step=r)
        # Exactly-one ownership from the journal, EVERY round.
        owners = om.summary(tail=1)["owners"]
        for t in all_tenants:
            holders = [w for w, rec in owners.items() if t in rec["tenants"]]
            if len(holders) != 1:
                out["ownership_violations"] += 1
        if r == 2:
            recomp_base = _recompiles()

    reb_sum = reb.summary(tail=1)
    out.update({
        "recompiles_after_warmup": (_recompiles() - (recomp_base or 0)
                                    - out["failover_replay_compiles"]),
        "migrations_committed": reb_sum["migration_count"],
        "migrations_aborted": reb_sum["aborted_count"],
        "failovers": len(failed_over),
        "walls_ms": walls,
        "failover_walls_ms": failover_walls,
        "rebalance_walls_ms": rebalance_walls,
        "ownership_digest": om.transition_digest(),
    })
    return out


def fleet_soak(seed: int = 21, quick: bool = True, device="cuda") -> dict:
    """The reference's `fleet_soak` row, its keys and values, from
    `REPLAYS` full soaks; the port's walls beside it."""
    runs = []
    with tempfile.TemporaryDirectory() as td:
        for i in range(REPLAYS):
            runs.append(soak_run(Path(td) / f"run{i}", seed, quick, device))
    a = runs[0]
    merged = [w for ws in a["walls_ms"].values() for w in ws]
    slo_p99_ms = 750.0
    return {
        "seed": seed,
        "quick": quick,
        "workers": 3,
        "tenants": 6,
        "rounds": 135 if quick else 220,
        "sessions": a["sessions"],
        "kills": ["w0", "w1"],
        "failovers": a["failovers"],
        "rebalance_runs": a["rebalance_runs"],
        "migrations": {
            "planned": a["migrations_committed"] + a["migrations_aborted"],
            "committed": a["migrations_committed"],
            "aborted": a["migrations_aborted"],
            "interrupted_by_kill": a["migrations_interrupted"],
        },
        "migration_replayed_ops": a["migration_replayed_ops"],
        "failover_replayed_ops": a["failover_replayed_ops"],
        "zombies_fenced": a["zombies_fenced"],
        "double_applied_ops": a["double_applied_ops"],
        "ownership_violations": a["ownership_violations"],
        "recompiles_after_splice": a["recompiles_after_warmup"],
        "failover_replay_compiles": a["failover_replay_compiles"],
        "round_wall_ms": {"p50": round(_pct(merged, 0.50), 2),
                          "p99": round(_pct(merged, 0.99), 2)},
        "per_worker_round_wall_ms": {
            wid: {"p50": round(_pct(ws, 0.50), 2), "p99": round(_pct(ws, 0.99), 2)}
            for wid, ws in sorted(a["walls_ms"].items()) if ws
        },
        "slo_p99_ms": slo_p99_ms,
        "slo_ok": _pct(merged, 0.99) <= slo_p99_ms,
        "replays": REPLAYS,
        "digest_match": float(all(r["ownership_digest"] == a["ownership_digest"] for r in runs)
                              and bool(a["ownership_digest"])),
        "ownership_digest": a["ownership_digest"],
        # The port's own readings beside the row.
        "round_walls_ms": merged,
        "failover_walls_ms": a["failover_walls_ms"],
        "rebalance_walls_ms": a["rebalance_walls_ms"],
        "zombie_bytes_written": a["zombie_bytes_written"],
        "digests": [r["ownership_digest"] for r in runs],
    }


__all__ = ["failover_drill", "failover_run", "fleet_soak", "soak_run", "zombie_resume"]
