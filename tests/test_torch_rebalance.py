"""The port's planned tenant rebalancing against the reference's, on the
CPU.

Counterparts of the twenty-two tests of `tests/unit/test_rebalance.py`
on `hypervisor_tpu_torch.fleet.rebalance` (a copy of the reference's
module, held as text by `tests/test_torch_host_engines.py`) with every
arena on `device="cpu"`: the per-tenant fence and its stat-keyed cache,
the migration journal on the `OwnershipMap`, the clean seven-step
migration, kill-at-every-protocol-step (7 steps x source or destination)
resolved by the failover controller to exactly one owner, the salvage,
the failover-vs-rebalance race, the deterministic deficit plan, and the
`/fleet/rebalance` routes.

Where the sequence is host code or journals device state, both packages
run it (`tests.test_torch_tenancy.both`) and the results are held equal,
tolerance 0: fence doc and `wal.log` bytes, transition logs and
digests, the plan and its digest on the same skewed fleet, one
migration's whole report and transitions, and the routes' statuses and
bodies.
"""

from __future__ import annotations

import json

import pytest

import hypervisor_tpu_torch as PORT
from hypervisor_tpu_torch.fleet.failover import FencingError, OwnershipMap, WorkerDurability
from hypervisor_tpu_torch.fleet.rebalance import PROTOCOL_STEPS, MigrationError
from tests.test_torch_facade_api import assert_same
from tests.test_torch_failover import (
    PP,
    answer,
    controller,
    drive_tenant,
    drive_tenant_suffix,
    durability,
    fo,
    managed,
    nothing,
    refusal,
    relative,
    service,
)
from tests.test_torch_resilience import assert_same as assert_fp_same
from tests.test_torch_resilience import fingerprint
from tests.test_torch_serving import Pkg
from tests.test_torch_tenancy import both


def rb(P: Pkg = PP):
    return P.mod("fleet.rebalance")


def fleet(P: Pkg, root, seed=11):
    """3 workers / 4 tenants with spare slots; tenant 0 fully driven
    (pre-checkpoint workload + mid-workload checkpoint + WAL suffix)."""
    w0 = managed(P, root, "w0", (0, 1), 3)
    w1 = managed(P, root, "w1", (2,), 3)
    w2 = managed(P, root, "w2", (3,), 3)
    for w in (w0, w1, w2):
        # every tenant recoverable from round 0
        for t, slot in w.slot_of.items():
            w.durability.checkpoint(w.arena.tenants[slot], t, step=0)
    st = w0.arena.tenants[w0.slot_of[0]]
    slot = drive_tenant(P, st, "mig", nothing)
    w0.arena.sync()
    w0.durability.checkpoint(st, 0, step=1)
    drive_tenant_suffix(st, "mig", slot, nothing)
    w0.arena.sync()
    st.journal.flush()
    om = fo(P).OwnershipMap(seed=seed)
    ctl = controller(P, om)
    for w in (w0, w1, w2):
        ctl.register(w, now=0.0)
    reb = rb(P).RebalanceController(om, ctl)
    return w0, w1, w2, om, ctl, reb


def live_copy(workers, tenant):
    holders = [w for w in workers if tenant in w.slot_of]
    assert len(holders) == 1, f"tenant {tenant} held by {[w.worker_id for w in holders]}"
    w = holders[0]
    return w, w.arena.tenants[w.slot_of[tenant]]


def transitions(om) -> list:
    return [t.to_dict() for t in om.transitions]


# ── the per-tenant fence + the stat-keyed floor cache ────────────────


class TestPerTenantFence:
    def test_tenant_fence_spares_siblings(self, tmp_path):
        def drive(P):
            root = tmp_path / ("ref" if P.is_ref else "port")
            d = durability(P, root, "w0", tenants=(0, 1)).adopt()
            for t in (0, 1):
                with d.wal(t).txn("op", {}):
                    pass
            fo(P).WorkerDurability.write_fence(root, "w0", 1, tenant=0)
            # tenant 0: appends AND checkpoints refuse...
            texts = [refusal(lambda: d.wal(0).txn("fenced", {}).__enter__()),
                     refusal(lambda: d.checkpoint(object(), 0))]
            assert all(t.startswith("FencingError") for t in texts)
            # ...while tenant 1 and the worker floor are untouched.
            with d.wal(1).txn("sibling", {}):
                pass
            assert d.fence_floor() == 0
            assert d.fence_floor_for(0) == 1 and d.fence_floor_for(1) == 0
            doc = d.summary()
            assert doc["tenant_fences"] == {0: 1}
            json.dumps(doc)
            return {"texts": texts, "fence": (root / "w0" / "FENCE").read_bytes(),
                    "summary": relative(doc, root),
                    "wals": [(d.tenant_dir(t) / "wal.log").read_bytes() for t in (0, 1)]}

        ref, port = both(drive)
        assert_same("tenant fence", port, ref)

    def test_legacy_fence_doc_still_parses(self, tmp_path):
        (tmp_path / "w0").mkdir()
        (tmp_path / "w0" / "FENCE").write_text('{"min_epoch": 3}')
        doc = WorkerDurability.read_fence_doc(tmp_path, "w0")
        assert doc == {"min_epoch": 3, "tenants": {}}
        assert WorkerDurability.read_fence(tmp_path, "w0") == 3

    def test_append_path_pays_one_stat_not_one_parse(self, tmp_path, monkeypatch):
        """The fence doc parses ONCE per fence change, not once per append:
        the cache is keyed on the FENCE file's stat identity."""
        d = durability(PP, tmp_path, "w0").adopt()
        WorkerDurability.write_fence(tmp_path, "w0", 0)  # doc exists
        parses = {"n": 0}
        real = WorkerDurability.read_fence_doc

        def counting(root, worker_id):
            parses["n"] += 1
            return real(root, worker_id)

        monkeypatch.setattr(WorkerDurability, "read_fence_doc", staticmethod(counting))
        wal = d.wal(0)
        for i in range(16):
            with wal.txn("op", {"i": i}):
                pass
        assert parses["n"] == 1  # one parse, sixteen appends

    def test_fence_bump_honored_before_the_next_framed_record(self, tmp_path):
        """`write_fence` replaces the file atomically (a new stat
        identity), so the very NEXT append after a bump refuses with zero
        new bytes; the log so far is the reference's, byte for byte."""

        def drive(P):
            root = tmp_path / ("ref" if P.is_ref else "port")
            d = durability(P, root, "w0").adopt()
            wal = d.wal(0)
            for i in range(4):  # warm the cache on the append path
                with wal.txn("op", {"i": i}):
                    pass
            path = d.tenant_dir(0) / "wal.log"
            committed = len(P.mod("resilience.wal").scan(path).committed)
            size = path.stat().st_size
            fo(P).WorkerDurability.write_fence(root, "w0", 1, tenant=0)
            text = refusal(lambda: wal.txn("late", {}).__enter__())
            assert text.startswith("FencingError") and wal.fenced_appends == 1
            assert path.stat().st_size == size  # zero bytes reached disk
            assert len(P.mod("resilience.wal").scan(path).committed) == committed
            return {"wal": path.read_bytes(), "fence": (root / "w0" / "FENCE").read_bytes(),
                    "text": text}

        ref, port = both(drive)
        assert port == ref

    def test_torn_fence_doc_still_fails_closed(self, tmp_path):
        d = durability(PP, tmp_path, "w0", epoch=5).adopt()
        with d.wal(0).txn("op", {}):
            pass
        (tmp_path / "w0" / "FENCE").write_text('{"min_ep')  # torn
        assert d.fence_floor() == 1 << 62
        with pytest.raises(FencingError):
            d.check_fence()
        with pytest.raises(FencingError):
            with d.wal(0).txn("torn", {}):
                pass


# ── the migration journal ops on the ownership map ───────────────────


class TestOwnershipMapMigration:
    def test_intent_commit_moves_exactly_once(self):
        def drive(P):
            events = []
            om = fo(P).OwnershipMap(seed=1, emit=lambda k, p: events.append((k, p)))
            om.assign("w0", (0, 1), 0, 1.0)
            om.assign("w1", (2,), 0, 1.0)
            om.migrate_intent(0, "w0", "w1", 1, 2.0)
            # intent is NOT a move: the source still owns the tenant.
            assert om.owner_of(0) == ("w0", 0) and 0 in om.inflight
            om.migrate_commit(0, 3.0)
            assert om.owner_of(0) == ("w1", 1) and om.tenants_of("w0") == (1,)
            assert om.epoch == 1 and om.inflight == {}
            assert [k for k, _ in events[-2:]] == [
                "fleet_rebalance_planned", "fleet_tenant_migrated"]
            return {"events": events, "digest": om.transition_digest()}

        ref, port = both(drive)
        assert_same("intent/commit", port, ref)

    def test_abort_leaves_ownership_untouched(self):
        om = OwnershipMap(seed=1)
        om.assign("w0", (0,), 0, 1.0)
        om.assign("w1", (), 0, 1.0)
        om.migrate_intent(0, "w0", "w1", 1, 2.0)
        rec = om.migrate_abort(0, 2.5, reason="failover:w1")
        assert rec["dest"] == "w1"
        assert om.owner_of(0) == ("w0", 0)
        assert om.inflight == {} and om.epoch == 0
        assert om.transitions[-1].kind == "migrate_abort"

    def test_invalid_intents_refuse_before_journaling(self):
        def drive(P):
            om = fo(P).OwnershipMap(seed=0)
            om.assign("w0", (0,), 0, 1.0)
            om.assign("w1", (), 0, 1.0)
            n = len(om.observations)
            texts = [
                refusal(lambda: om.migrate_intent(0, "w1", "w0", 1, 2.0)),  # wrong source
                refusal(lambda: om.migrate_intent(0, "w0", "w0", 1, 2.0)),  # self-move
                refusal(lambda: om.migrate_intent(0, "w0", "w1", 0, 2.0)),  # stale epoch
                refusal(lambda: om.migrate_commit(7, 2.0)),                 # no intent
                refusal(lambda: om.migrate_abort(7, 2.0)),                  # no intent
            ]
            om.migrate_intent(0, "w0", "w1", 1, 3.0)
            texts.append(refusal(lambda: om.migrate_intent(0, "w0", "w1", 2, 3.5)))
            assert len(om.observations) == n + 1
            assert [t.split(":")[0] for t in texts] == [
                "FailoverError", "FailoverError", "FencingError", "FailoverError",
                "FailoverError", "FailoverError"]
            return texts

        ref, port = both(drive)
        assert port == ref

    def test_replay_covers_migration_kinds(self):
        def drive(P):
            om = fo(P).OwnershipMap(seed=21)
            om.assign("w0", (0, 1), 0, 1.0)
            om.assign("w1", (), 0, 1.0)
            om.migrate_intent(0, "w0", "w1", 1, 2.0)
            om.migrate_commit(0, 3.0)
            om.migrate_intent(1, "w0", "w1", 2, 4.0)
            om.migrate_abort(1, 4.5, reason="drill")
            again = fo(P).OwnershipMap.replay(om.observations, seed=21)
            assert again.transition_digest() == om.transition_digest()
            assert again.owner_of(0) == ("w1", 1) and again.owner_of(1) == ("w0", 0)
            doc = json.loads(json.dumps(om.summary()))
            assert doc["inflight"] == {}
            return doc

        ref, port = both(drive)
        assert_same("replay", port, ref)


# ── the clean planned migration ──────────────────────────────────────


class TestCleanMigration:
    def test_zero_loss_handoff_and_idempotent_resubmit(self, tmp_path):
        def drive(P):
            root = tmp_path / ("ref" if P.is_ref else "port") / "a"
            w0, w1, w2, om, ctl, reb = fleet(P, root)
            oracle = fingerprint(w0.arena.tenants[w0.slot_of[0]])
            report = reb.migrate(0, "w2", now=5.0)
            assert report["status"] == "committed"
            assert report["steps"] == list(PROTOCOL_STEPS)
            # drained + checkpointed at the WAL tip: adoption replays ZERO
            assert report["replayed_ops"] == 0
            assert om.owner_of(0) == ("w2", 1)
            holder, st = live_copy((w0, w1, w2), 0)
            assert holder is w2
            assert_fp_same(fingerprint(st), oracle, "after clean migration")
            tdir = w2.durability.tenant_dir(0)
            assert (tdir / "latest" / ".done").exists()
            # the source shed its copy: slot back in the spare pool,
            # per-tenant fence burned, a zombie resume refuses loudly
            assert 0 not in w0.slot_of and w0.slot_of[1] is not None
            assert w0.durability.fence_floor_for(0) == 1 and w0.durability.fence_floor() == 0
            zombie = refusal(lambda: w0.durability.wal(0))
            # idempotent re-submit of a completed migration: a no-op
            again = reb.migrate(0, "w2", now=6.0)
            assert again["status"] == "noop"
            assert om.transition_digest() == report["ownership_digest"]
            json.dumps(reb.summary())
            return {"report": relative(report, root), "transitions": transitions(om),
                    "again": again, "zombie": zombie, "wal": (tdir / "wal.log").read_bytes(),
                    "fence": (root / "w0" / "FENCE").read_bytes(),
                    "summary": relative(json.loads(json.dumps(reb.summary())), root)}

        ref, port = both(drive)
        assert_same("clean migration", port, ref)
        # ... and the port's run replays bit-identically
        _, _, _, om_b, _, reb_b = fleet(PP, tmp_path / "b")
        assert reb_b.migrate(0, "w2", now=5.0)["ownership_digest"] == (
            port["report"]["ownership_digest"])
        assert OwnershipMap.replay(om_b.observations, seed=11).transition_digest() == (
            om_b.transition_digest())

    def test_migration_refusals_move_nothing(self, tmp_path):
        w0, w1, w2, om, ctl, reb = fleet(PP, tmp_path)
        with pytest.raises(MigrationError):
            reb.migrate(0, "nope", now=1.0)  # unknown destination
        with pytest.raises(MigrationError):
            reb.migrate(9, "w1", now=1.0)  # unowned tenant
        w1.spare_slots.clear()
        with pytest.raises(MigrationError):
            reb.migrate(0, "w1", now=1.0)  # no spare slot
        with pytest.raises(MigrationError):
            reb.migrate(0, "w2", now=1.0, stop_after="bogus")
        assert om.owner_of(0) == ("w0", 0)
        assert om.inflight == {}

    def test_fenced_destination_refuses_the_round_trip(self, tmp_path):
        w0, w1, w2, om, ctl, reb = fleet(PP, tmp_path)
        reb.migrate(0, "w2", now=5.0)
        # w0 fenced tenant 0 away in this epoch: it can't take it back
        with pytest.raises(MigrationError, match="fenced"):
            reb.migrate(0, "w0", now=6.0)
        assert om.owner_of(0) == ("w2", 1)


# ── kill at EVERY protocol step ──────────────────────────────────────


class TestKillAtEveryProtocolStep:
    @pytest.mark.parametrize("step", PROTOCOL_STEPS)
    @pytest.mark.parametrize("victim", ["source", "dest"])
    def test_crash_boundary_resolves_to_exactly_one_owner(self, tmp_path, step, victim):
        """Stop the migration right after `step`, convict the victim, run
        the failover, and pin: exactly-one owner, the live copy
        bit-identical to the oracle, zero double-applies, no orphaned
        destination dirs, and a bit-identical journal replay."""
        w0, w1, w2, om, ctl, reb = fleet(PP, tmp_path)
        oracle = fingerprint(w0.arena.tenants[w0.slot_of[0]])
        report = reb.migrate(0, "w1", now=5.0, stop_after=step)
        committed = report["status"] == "committed"
        assert committed == (step == "journal_commit")
        dead = "w0" if victim == "source" else "w1"
        fo_report = ctl.failover(dead, now=6.0)
        assert fo_report["epoch"] == om.epoch
        # exactly-one ownership, in the journal AND in the arenas
        owner = om.owner_of(0)
        assert owner is not None
        holder, st = live_copy((w0, w1, w2), 0)
        assert holder.worker_id == owner[0] != dead
        assert_fp_same(fingerprint(st), oracle, f"after kill({victim}) at {step}")
        kinds = [t.kind for t in om.transitions]
        if committed:
            assert "migrate_commit" in kinds
        else:
            assert "migrate_abort" in kinds and "migrate_commit" not in kinds
        assert om.inflight == {}
        if victim == "source" and not committed:
            assert w1.durability.tenant_dir(0).exists() == (0 in w1.slot_of)
        # zero double-applies: the dead worker's durable copy refuses the
        # very next append
        dead_mw = {"w0": w0, "w1": w1}[dead]
        with pytest.raises(FencingError):
            with dead_mw.durability.wal(0).txn("zombie", {}):
                pass
        assert OwnershipMap.replay(om.observations, seed=11).transition_digest() == (
            om.transition_digest())
        json.dumps(reb.summary()) and json.dumps(ctl.summary())

    def test_dest_death_after_fence_salvages_the_tenant(self, tmp_path):
        """The destination dies AFTER the source's per-tenant fence burned:
        the abort salvages the drained state onto a live worker through
        the same splice path, replaying zero records."""
        w0, w1, w2, om, ctl, reb = fleet(PP, tmp_path)
        oracle = fingerprint(w0.arena.tenants[w0.slot_of[0]])
        reb.migrate(0, "w1", now=5.0, stop_after="fence_source_tenant")
        assert w0.durability.fence_floor_for(0) == 1
        ctl.failover("w1", now=6.0)
        assert len(reb.aborted) == 1
        assert reb.aborted[0]["salvaged"] is True and reb.aborted[0]["salvage"] == "w2"
        assert om.owner_of(0)[0] == "w2"
        holder, st = live_copy((w0, w1, w2), 0)
        assert holder is w2
        assert_fp_same(fingerprint(st), oracle, "after salvage")
        assert reb.aborted[0]["replayed_ops"] == 0


# ── the failover-vs-rebalance race ───────────────────────────────────


class TestFailoverVsRebalanceRace:
    def test_chaos_plan_schedules_migration_window_faults(self):
        def drive(P):
            chaos = P.mod("testing.chaos")
            plan = chaos.WaveChaosPlan(seed=7, fleet_faults=tuple(
                chaos.InjectedFleetFault(kind=k, at_round=r, worker=w) for k, r, w in (
                    ("migration_kill_source", 2, "w0"), ("migration_kill_dest", 3, "w1"),
                    ("torn_ownership_record", 4, "w0"), ("zombie_source_resume", 5, "w0"))))
            inj = chaos.WaveChaosInjector(plan)
            assert list(inj.take_fleet_faults(1)) == []
            assert [f.kind for f in inj.take_fleet_faults(2)] == ["migration_kill_source"]
            assert list(inj.take_fleet_faults(2)) == []  # once only
            assert [f.kind for f in inj.take_fleet_faults(3)] == ["migration_kill_dest"]
            return inj.report()

        ref, port = both(drive)
        assert_same("chaos", port, ref)

    def test_conviction_mid_migration_aborts_and_failover_wins(self, tmp_path):
        """The SAME tenant is mid-migration when its source is convicted:
        the migration aborts (journaled BEFORE the fence: failover wins),
        no orphaned epoch directories, a re-submit is a no-op."""
        from hypervisor_tpu_torch.testing.chaos import (
            InjectedFleetFault,
            WaveChaosInjector,
            WaveChaosPlan,
        )

        w0, w1, w2, om, ctl, reb = fleet(PP, tmp_path)
        oracle = fingerprint(w0.arena.tenants[w0.slot_of[0]])
        inj = WaveChaosInjector(WaveChaosPlan(seed=7, fleet_faults=(
            InjectedFleetFault(kind="migration_kill_source", at_round=1, worker="w0"),)))
        (fault,) = inj.take_fleet_faults(1)
        assert fault.worker == "w0"
        reb.migrate(0, "w1", now=5.0, stop_after="drain_source")
        fo_report = ctl.failover(fault.worker, now=6.0)
        kinds = [t.kind for t in om.transitions]
        assert kinds.index("migrate_abort") < kinds.index("fence")
        assert len(reb.aborted) == 1 and reb.aborted[0]["reason"] == "failover:w0"
        assert om.tenants_of("w0") == ()
        assert set(fo_report["tenants"]) == {0, 1}
        holder, st = live_copy((w1, w2), 0)
        assert_fp_same(fingerprint(st), oracle, "after race")
        assert w1.durability.tenant_dir(0).exists() == (0 in w1.slot_of)
        assert reb.migrate(0, holder.worker_id, now=7.0)["status"] == "noop"

    def test_torn_ownership_record_fails_the_worker_closed(self, tmp_path):
        """The source's FENCE doc tears mid-handoff: EVERY write on that
        worker fails closed and failover recovers all its tenants."""
        w0, w1, w2, om, ctl, reb = fleet(PP, tmp_path)
        oracle = fingerprint(w0.arena.tenants[w0.slot_of[0]])
        reb.migrate(0, "w1", now=5.0, stop_after="seal_source")
        (tmp_path / "w0" / "FENCE").write_text("\x00garbage")
        with pytest.raises(FencingError):
            with w0.arena.tenants[w0.slot_of[1]].journal.txn("op", {}):
                pass
        ctl.failover("w0", now=6.0)
        assert om.tenants_of("w0") == ()
        holder, st = live_copy((w1, w2), 0)
        assert_fp_same(fingerprint(st), oracle, "after torn fence")


# ── the deterministic deficit plan ───────────────────────────────────


def skewed(P: Pkg, root):
    """Two full donors + one empty receiver, every arena T = 3."""
    w0 = managed(P, root, "w0", (0, 1, 2), 3)
    w1 = managed(P, root, "w1", (3, 4, 5), 3)
    w2 = managed(P, root, "w2", (), 3)
    om = fo(P).OwnershipMap(seed=5)
    ctl = controller(P, om)
    for w in (w0, w1, w2):
        ctl.register(w, now=0.0)
    return w0, w1, w2, om, ctl, rb(P).RebalanceController(om, ctl)


class TestPlacementPolicy:
    def test_plan_is_deterministic_and_levels_the_fleet(self, tmp_path):
        def drive(P):
            root = tmp_path / ("ref" if P.is_ref else "port")
            w0, w1, w2, om, ctl, reb = skewed(P, root)
            plan = reb.plan(now=1.0)
            assert plan == reb.plan(now=1.0)
            # donors most-loaded (the w0/w1 tie to the HIGHER id),
            # receivers least-loaded, no move across a deficit under 2
            assert [(p["tenant"], p["source"], p["dest"]) for p in plan["proposals"]] == [
                (3, "w1", "w2"), (0, "w0", "w2")]
            out = reb.execute(now=2.0)
            assert [r["status"] for r in out["results"]] == ["committed", "committed"]
            assert om.owner_of(3)[0] == "w2" and om.owner_of(0)[0] == "w2"
            assert reb.plan(now=3.0)["proposals"] == []
            return {"plan": plan, "results": relative(out["results"], root),
                    "transitions": transitions(om)}

        ref, port = both(drive)
        assert_same("plan", port, ref)

    def test_plan_skips_fenced_receivers(self, tmp_path):
        def drive(P):
            root = tmp_path / ("ref" if P.is_ref else "port")
            w0, w1, w2, om, ctl, reb = skewed(P, root)
            # the sole receiver (w2) is fenced for exactly the two tenants
            # the unfenced plan would send it: the plan routes AROUND them
            fo(P).WorkerDurability.write_fence(root, "w2", 1, tenant=3)
            fo(P).WorkerDurability.write_fence(root, "w2", 1, tenant=0)
            plan = reb.plan(now=1.0)
            assert [(p["tenant"], p["dest"]) for p in plan["proposals"]] == [(4, "w2")]
            return plan

        ref, port = both(drive)
        assert_same("fenced plan", port, ref)


# ── the transport surface ────────────────────────────────────────────


class TestRebalanceApi:
    def test_routes_registered_on_the_shared_table(self):
        from hypervisor_tpu_torch.api.server import ROUTES

        routes = {(m, p) for m, p, _, _ in ROUTES}
        assert ("GET", "/fleet/rebalance") in routes and ("POST", "/fleet/rebalance") in routes

    def test_503_without_fleet_then_without_plane(self):
        def drive(P):
            svc = service(P)
            out = [answer(P, svc.fleet_rebalance())]
            svc.fleet = P.mod("fleet").FleetObservatory({})
            out.append(answer(P, svc.fleet_rebalance()))
            out.append(answer(P, svc.fleet_rebalance_post(
                P.mod("api.models").FleetRebalanceRequest(now=1.0))))
            assert [s for s, _ in out] == [503] * 3 and "rebalance" in out[1][1]
            return out

        ref, port = both(drive)
        assert port == ref

    def test_get_post_dry_run_and_execute(self, tmp_path):
        """Dry run, a half-specified migration (400), an execution, a
        refused one (409): each status and body the reference's."""

        def drive(P):
            root = tmp_path / ("ref" if P.is_ref else "port")
            M = P.mod("api.models")
            w0, w1, w2, om, ctl, reb = fleet(P, root)
            svc = service(P)
            svc.fleet = P.mod("fleet").FleetObservatory({})
            svc.fleet.ownership, svc.fleet.failover, svc.fleet.rebalance = om, ctl, reb
            out = {"get": answer(P, svc.fleet_rebalance())}
            assert out["get"][1]["migration_count"] == 0
            assert out["get"][1]["protocol_steps"] == list(PROTOCOL_STEPS)
            out["dry"] = answer(P, svc.fleet_rebalance_post(M.FleetRebalanceRequest(now=1.0)))
            assert out["dry"][1]["executed"] is False and om.owner_of(0) == ("w0", 0)
            out["half"] = answer(P, svc.fleet_rebalance_post(
                M.FleetRebalanceRequest(tenant=0, execute=True)))
            assert out["half"][0] == 400
            out["execute"] = answer(P, svc.fleet_rebalance_post(M.FleetRebalanceRequest(
                tenant=0, destination="w2", execute=True, now=2.0)))
            assert out["execute"][1]["executed"] is True
            assert out["execute"][1]["result"]["status"] == "committed"
            assert om.owner_of(0) == ("w2", 1)
            out["refused"] = answer(P, svc.fleet_rebalance_post(M.FleetRebalanceRequest(
                tenant=0, destination="w0", execute=True, now=3.0)))
            assert out["refused"][0] == 409
            out["after"] = answer(P, svc.fleet_ownership())
            return relative(out, root)

        ref, port = both(drive)
        assert_same("rebalance routes", port, ref)


def test_port_module_is_importable_through_the_package():
    """`fleet.RebalanceController` is the port's class, not a refusal."""
    assert PORT.fleet.RebalanceController is rb().RebalanceController
    assert PORT.fleet.PROTOCOL_STEPS == PROTOCOL_STEPS
