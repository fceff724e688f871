"""The port's fleet failover plane against the reference's, on the CPU.

Counterparts of the twenty tests of `tests/unit/test_failover.py` on
`hypervisor_tpu_torch.fleet.failover` with every arena and recovery on
`device="cpu"`: durable ownership namespaces, the durable fence, the
journaled `OwnershipMap`, the kill-at-every-WAL-boundary splice
property, the `FailoverController` drill, the fleet chaos schedule, the
`/fleet/{ownership,failover}` routes, and the durable worker's SIGTERM
drain in a real subprocess.

Where a case is pure host code or journals device state, it runs the
same call sequence on both packages (`tests.test_torch_tenancy.both`:
deterministic ids and clocks, unarmed) and holds the results equal,
tolerance 0: the ownership observations, transition logs and digests,
the `FENCE` doc bytes, each tenant's `wal.log` bytes, refusal texts, and
the drill's whole report (the checkpoint paths taken relative to each
run's root). `fleet/failover.py` itself is the reference's text with
named edits (`tests/test_torch_host_engines.py`'s `EDITED_COPIES`): the
one edit that is not a comment recovers an absorbed tenant onto the
target arena's own device.
"""

from __future__ import annotations

import asyncio
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

import hypervisor_tpu_torch as PORT
from tests.test_torch_facade_api import assert_same
from tests.test_torch_resilience import assert_same as assert_fp_same
from tests.test_torch_resilience import fingerprint
from tests.test_torch_serving import Pkg
from tests.test_torch_tenancy import both

REPO = Path(__file__).resolve().parent.parent

#: The reference test's tables (`tests/unit/test_failover.py`'s SMALL).
CAP = dict(max_agents=64, max_sessions=32, max_vouch_edges=64, max_sagas=16,
           max_steps_per_saga=8, max_elevations=16, delta_log_capacity=128,
           event_log_capacity=128, trace_log_capacity=128)

PP = Pkg(PORT)


def small(P: Pkg = PP):
    cfg = P.mod("config")
    return cfg.HypervisorConfig(capacity=cfg.TableCapacity(**CAP))


def fo(P: Pkg = PP):
    return P.mod("fleet.failover")


def arena(P: Pkg, n: int, config=None):
    tenancy = P.mod("tenancy")
    config = small(P) if config is None else config
    if P.is_ref:
        return tenancy.TenantArena(n, config)
    return tenancy.TenantArena(n, config, device="cpu")


def state(P: Pkg, config=None):
    config = small(P) if config is None else config
    if P.is_ref:
        return P.mod("state").HypervisorState(config)
    return P.mod("state").HypervisorState(config, device="cpu")


def recover_tenant(P: Pkg, bundle, tenant: int, config=None):
    recovery = P.mod("resilience.recovery")
    config = small(P) if config is None else config
    if P.is_ref:
        return recovery.recover_tenant(bundle, tenant, config=config)
    return recovery.recover_tenant(bundle, tenant, config=config, device="cpu")


def durability(P: Pkg, root, wid: str, epoch: int = 0, tenants=(0,)):
    return fo(P).WorkerDurability(root, wid, epoch=epoch, tenants=tenants, fsync=False)


def refusal(fn) -> str:
    """The text of the exception `fn()` raises."""
    with pytest.raises(Exception) as err:
        fn()
    return f"{type(err.value).__name__}: {err.value}"


def relative(obj, root: Path):
    """`obj` with every string naming a path under `root` made relative."""
    if isinstance(obj, dict):
        return {k: relative(v, root) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(relative(v, root) for v in obj)
    if isinstance(obj, str):
        return obj.replace(str(root), "<root>")
    return obj


def drive_tenant(P: Pkg, st, tag: str, snap) -> int:
    """The reference test's pre-checkpoint workload for one arena tenant;
    `snap()` records after every journaled op."""
    slot = st.create_session(f"s:{tag}", P.mod("models").SessionConfig(min_sigma_eff=0.0),
                             now=1.0)
    snap()
    st.enqueue_join(slot, f"did:{tag}:a", 0.8)
    snap()
    st.enqueue_join(slot, f"did:{tag}:b", 0.7)
    snap()
    st.flush_joins(now=2.0)
    snap()
    return slot


def drive_tenant_suffix(st, tag: str, slot: int, snap) -> None:
    """The WAL suffix past the checkpoint."""
    a = st.agent_row(f"did:{tag}:a")["slot"]
    st.stage_delta(slot, a, ts=3.0, change_words=np.arange(4, dtype=np.uint32))
    snap()
    st.flush_deltas()
    snap()
    st.terminate_sessions([slot], now=5.0)
    snap()


def nothing() -> None:
    return None


def managed(P: Pkg, root, wid, tenants, n_slots, config=None, epoch=0):
    ar = arena(P, n_slots, config)
    dur = durability(P, root, wid, epoch, tenants).adopt()
    slot_of = {}
    for slot, t in enumerate(tenants):
        ar.tenants[slot].journal = dur.wal(t)
        slot_of[t] = slot
    return fo(P).ManagedWorker(wid, ar, dur, slot_of, list(range(len(tenants), n_slots)))


def controller(P: Pkg, om, config=None):
    return fo(P).FailoverController(om, config=small(P) if config is None else config)


# ── the journaled ownership map ──────────────────────────────────────


class TestOwnershipMap:
    def test_assign_fence_and_views(self):
        def drive(P):
            events = []
            om = fo(P).OwnershipMap(seed=3, emit=lambda k, p: events.append((k, p)))
            om.assign("w0", (0, 1), 0, 1.0)
            om.assign("w1", (2,), 0, 1.0)
            assert om.owner_of(1) == ("w0", 0)
            assert om.owner_of(9) is None
            assert om.tenants_of("w1") == (2,)
            assert om.epoch == 0
            om.fence("w0", 1, 2.0)
            assert om.is_fenced("w0", 0) and not om.is_fenced("w0", 1)
            assert [k for k, _ in events] == [
                "fleet_ownership_changed", "fleet_ownership_changed", "fleet_worker_fenced"]
            doc = om.summary()
            assert doc["transition_count"] == 3
            return {"events": events, "summary": json.loads(json.dumps(doc))}

        ref, port = both(drive)
        assert_same("ownership map", port, ref)

    def test_stale_epoch_assign_refuses_before_journaling(self):
        def drive(P):
            om = fo(P).OwnershipMap(seed=0)
            om.assign("w0", (0,), 2, 1.0)
            n_obs = len(om.observations)
            texts = [refusal(lambda: om.assign("w1", (1,), 1, 1.5))]  # below the map's epoch
            om.fence("w2", 5, 2.0)
            texts.append(refusal(lambda: om.assign("w2", (3,), 3, 2.5)))  # below w2's floor
            # refused ops never journaled: replay can't diverge on them
            assert len(om.observations) == n_obs + 1
            assert all(t.startswith("FencingError") for t in texts)
            return {"texts": texts, "observations": om.observations,
                    "digest": om.transition_digest()}

        ref, port = both(drive)
        assert_same("refusals", port, ref)

    def test_replay_is_bit_identical(self):
        def drive(P):
            om = fo(P).OwnershipMap(seed=42)
            om.assign("w0", (0, 1), 0, 1.0)
            om.assign("w1", (2, 3), 0, 1.25)
            om.fence("w0", 1, 2.0)
            om.assign("w1", (0, 1, 2, 3), 1, 2.5)
            om.assign("w0", (), 1, 2.5)
            again = fo(P).OwnershipMap.replay(om.observations, seed=42)
            assert again.transition_digest() == om.transition_digest()
            assert ([t.replay_key() for t in again.transitions]
                    == [t.replay_key() for t in om.transitions])
            other = fo(P).OwnershipMap.replay(om.observations, seed=43)
            assert other.transition_digest() != om.transition_digest()
            return {"keys": [t.replay_key() for t in om.transitions],
                    "digests": (om.transition_digest(), other.transition_digest())}

        ref, port = both(drive)
        assert_same("replay", port, ref)


# ── the durability namespace + the fence ─────────────────────────────


class TestWorkerDurability:
    def test_shared_root_never_collides(self, tmp_path):
        """Two specs on ONE durability root get disjoint (worker id,
        epoch, tenant) namespaces; each log's bytes are the reference's."""

        def drive(P):
            root = tmp_path / ("ref" if P.is_ref else "port")
            d0 = durability(P, root, "w0").adopt()
            d1 = durability(P, root, "w1").adopt()
            with d0.wal(0).txn("op", {"who": "w0"}):
                pass
            with d1.wal(0).txn("op", {"who": "w1"}):
                pass
            p0 = root / "w0" / "epoch_0" / "tenant_0" / "wal.log"
            p1 = root / "w1" / "epoch_0" / "tenant_0" / "wal.log"
            assert p0 != p1 and p0.exists() and p1.exists()
            (r0,) = P.mod("resilience.wal").scan(p0).committed
            (r1,) = P.mod("resilience.wal").scan(p1).committed
            assert r0.args == {"who": "w0"} and r1.args == {"who": "w1"}
            return {"wal": (p0.read_bytes(), p1.read_bytes()),
                    "manifest": (root / "w0" / "epoch_0" / "manifest.json").read_bytes()}

        ref, port = both(drive)
        assert port == ref

    def test_adopt_refuses_newer_epoch_loudly(self, tmp_path):
        def drive(P):
            root = tmp_path / ("ref" if P.is_ref else "port")
            durability(P, root, "w0", epoch=4).adopt()
            text = refusal(lambda: durability(P, root, "w0", epoch=3).adopt())
            assert text.startswith("FencingError") and "epoch 4" in text
            # equal or newer adopters proceed (restart, then failover bump)
            durability(P, root, "w0", epoch=4).adopt()
            durability(P, root, "w0", epoch=5).adopt()
            return {"text": text.replace(str(root), "<root>"),
                    "epochs": sorted(p.name for p in (root / "w0").iterdir())}

        ref, port = both(drive)
        assert port == ref

    def test_adopt_refuses_below_fence_floor(self, tmp_path):
        def drive(P):
            root = tmp_path / ("ref" if P.is_ref else "port")
            fo(P).WorkerDurability.write_fence(root, "w0", 2)
            text = refusal(lambda: durability(P, root, "w0", epoch=1).adopt())
            assert "fence floor 2" in text
            return {"text": text, "fence": (root / "w0" / "FENCE").read_bytes()}

        ref, port = both(drive)
        assert port == ref

    def test_fenced_append_writes_zero_bytes(self, tmp_path):
        def drive(P):
            root = tmp_path / ("ref" if P.is_ref else "port")
            d = durability(P, root, "w0").adopt()
            w = d.wal(0)
            with w.txn("before", {}):
                pass
            before = w.path.read_bytes()
            fo(P).WorkerDurability.write_fence(root, "w0", 1)
            text = refusal(lambda: w.txn("zombie", {}).__enter__())
            assert text.startswith("FencingError")
            assert w.path.read_bytes() == before  # ZERO bytes reached disk
            assert w.fenced_appends == 1
            assert [r.op for r in P.mod("resilience.wal").scan(w.path).committed] == ["before"]
            return {"wal": before, "fence": (root / "w0" / "FENCE").read_bytes(), "text": text}

        ref, port = both(drive)
        assert port == ref

    def test_fenced_checkpoint_never_publishes(self, tmp_path):
        def drive(P):
            root = tmp_path / ("ref" if P.is_ref else "port")
            d = durability(P, root, "w0").adopt()
            st = state(P)
            d.checkpoint(st, 0, step=1)
            fo(P).WorkerDurability.write_fence(root, "w0", 1)
            text = refusal(lambda: d.checkpoint(st, 0, step=2))
            steps = sorted(p.name for p in d.tenant_dir(0).iterdir() if p.name.startswith("step_"))
            assert steps == ["step_1"]  # the fenced save left nothing
            return {"text": text, "steps": steps}

        ref, port = both(drive)
        assert port == ref

    def test_fence_floors_only_rise_and_torn_fence_fails_closed(self, tmp_path):
        def drive(P):
            root = tmp_path / ("ref" if P.is_ref else "port")
            wd = fo(P).WorkerDurability
            wd.write_fence(root, "w0", 3)
            wd.write_fence(root, "w0", 1)  # ignored
            wd.write_fence(root, "w0", 2, tenant=5)
            assert wd.read_fence(root, "w0") == 3
            doc = (root / "w0" / "FENCE").read_bytes()
            (root / "w0" / "FENCE").write_text("{torn garbag")
            assert wd.read_fence(root, "w0") >= 1 << 62
            return {"fence": doc, "torn": wd.read_fence_doc(root, "w0")}

        ref, port = both(drive)
        assert port == ref


# ── the reassignment property ────────────────────────────────────────


def doomed_worker(P: Pkg, root, record=None):
    """A 2-tenant arena journaling into its durable namespace: the
    pre-checkpoint workload, a checkpoint at step 1, the WAL suffix.
    `record(st)` runs on tenant 0 after every journaled op of it."""
    ar = arena(P, 2)

    def snap0():
        if record is not None:
            record(ar.tenants[0])

    dur = durability(P, root, "w-dead", tenants=(0, 1)).adopt()
    for t in (0, 1):
        ar.tenants[t].journal = dur.wal(t)
    slots = {}
    for t, tag in ((0, "t0"), (1, "t1")):
        slots[t] = drive_tenant(P, ar.tenants[t], tag, snap0 if t == 0 else nothing)
    ar.sync()
    watermark = ar.tenants[0].journal.last_seq
    for t in (0, 1):
        dur.checkpoint(ar.tenants[t], t, step=1)
    for t, tag in ((0, "t0"), (1, "t1")):
        drive_tenant_suffix(ar.tenants[t], tag, slots[t], snap0 if t == 0 else nothing)
    ar.sync()
    snap0()
    for t in (0, 1):
        ar.tenants[t].journal.flush()
    return ar, dur, watermark


class TestReassignmentBitIdentity:
    def test_kill_at_every_wal_boundary_then_splice_elsewhere(self, tmp_path):
        # The doomed worker's per-tenant logs are the reference's, byte
        # for byte.
        def drive(P):
            _, dur, _ = doomed_worker(P, tmp_path / ("ref" if P.is_ref else "port"))
            return [(dur.tenant_dir(t) / "wal.log").read_bytes() for t in (0, 1)]

        ref_wals, port_wals = both(drive)
        assert port_wals == ref_wals

        snapshots: dict[int, dict] = {}

        def record(st):
            snapshots[st.journal.last_seq] = fingerprint(st)

        P = PP
        ar, dur, watermark = doomed_worker(P, tmp_path / "root", record)
        tip1 = fingerprint(ar.tenants[1])

        # ── a DIFFERENT worker to splice into ──
        survivor = arena(P, 2)
        raw = dur.tenant_dir(0).joinpath("wal.log").read_bytes()
        bundle = tmp_path / "bundle"
        shutil.copytree(dur.epoch_dir, bundle)
        torn_wal = bundle / "tenant_0" / "wal.log"
        boundaries = [0]
        for line in raw.splitlines(keepends=True):
            boundaries.append(boundaries[-1] + len(line))
        offsets = sorted(set(boundaries) | {b - 3 for b in boundaries[1:]})
        scan = P.mod("resilience.wal").scan
        for off in offsets:
            torn_wal.write_bytes(raw[:off])
            committed = scan(torn_wal).committed
            expected_seq = max(max((r.seq for r in committed), default=0), watermark)
            back, report = recover_tenant(P, bundle, 0)
            assert report["tenant"] == 0
            assert report["wal_records_replayed"] == len(
                [r for r in committed if r.seq > watermark])
            # the comparison reads the SURVIVOR's view: the splice is
            # under test too
            survivor.splice_tenant(1, back)
            assert_fp_same(snapshots[expected_seq], fingerprint(survivor.tenants[1]),
                           ctx=f"(crash at byte {off}, seq {expected_seq})")
        # the OTHER tenant recovers to tip independently
        back1, _ = recover_tenant(P, bundle, 1)
        survivor.splice_tenant(0, back1)
        assert_fp_same(tip1, fingerprint(survivor.tenants[0]), ctx="(tenant 1 tip)")
        with pytest.raises(Exception):
            recover_tenant(P, bundle, 7)  # no such namespace

    def test_spliced_tenant_keeps_serving(self, tmp_path):
        """After a splice the survivor slot is a LIVE tenant: host ops and
        waves keep running on the adopted state."""
        P = PP
        donor = arena(P, 1)
        dur = durability(P, tmp_path, "w-d").adopt()
        donor.tenants[0].journal = dur.wal(0)
        st = donor.tenants[0]
        drive_tenant(P, st, "live", nothing)
        donor.sync()
        dur.checkpoint(st, 0, step=1)
        back, _ = recover_tenant(P, dur.epoch_dir, 0)
        survivor = arena(P, 2)
        survivor.splice_tenant(1, back)
        adopted = survivor.tenants[1]
        assert adopted.agent_row("did:live:a")["slot"] >= 0
        s2 = adopted.create_session("s:post-splice",
                                    P.mod("models").SessionConfig(min_sigma_eff=0.0), now=6.0)
        adopted.enqueue_join(s2, "did:post", 0.9)
        assert (adopted.flush_joins(now=6.5) == 0).all()
        survivor.sync()
        assert adopted.agent_row("did:post")["slot"] >= 0
        assert_fp_same(fingerprint(adopted), fingerprint(survivor.tenants[1]))

    def test_splice_refuses_capacity_mismatch(self):
        from hypervisor_tpu_torch.fleet.worker import _small_capacity_config

        ar = arena(PP, 1)
        with pytest.raises(ValueError, match="capacity"):
            ar.splice_tenant(0, state(PP, _small_capacity_config()))
        with pytest.raises(ValueError, match="slot"):
            ar.splice_tenant(5, state(PP))


# ── the failover controller drill ────────────────────────────────────


def run_drill(P: Pkg, root, seed=11):
    w0 = managed(P, root, "w0", (0, 1), 2)
    w1 = managed(P, root, "w1", (2,), 3)
    w2 = managed(P, root, "w2", (3,), 3)
    slots = {}
    for t, slot in w0.slot_of.items():
        slots[t] = drive_tenant(P, w0.arena.tenants[slot], f"d{t}", nothing)
    w0.arena.sync()
    for t, slot in w0.slot_of.items():
        w0.durability.checkpoint(w0.arena.tenants[slot], t, step=1)
    for t, slot in w0.slot_of.items():
        drive_tenant_suffix(w0.arena.tenants[slot], f"d{t}", slots[t], nothing)
    w0.arena.sync()
    for slot in w0.slot_of.values():
        w0.arena.tenants[slot].journal.flush()
    om = fo(P).OwnershipMap(seed=seed)
    ctl = controller(P, om)
    for w in (w0, w1, w2):
        ctl.register(w, now=0.0)
    report = ctl.failover("w0", now=10.0)
    return w0, w1, w2, om, ctl, report


class TestFailoverController:
    def test_drill_reassigns_fences_and_is_deterministic(self, tmp_path):
        def drive(P):
            root = tmp_path / ("ref" if P.is_ref else "port") / "a"
            w0, w1, w2, om, ctl, report = run_drill(P, root)
            # deficit-aware spread: the tie breaks to w1 by id, then the
            # second orphan spreads to w2
            assert report["tenants"][0]["survivor"] == "w1"
            assert report["tenants"][1]["survivor"] == "w2"
            assert report["replayed_ops"] > 0
            assert om.tenants_of("w0") == ()
            assert om.owner_of(0) == ("w1", 1) and om.owner_of(1) == ("w2", 1)
            assert om.epoch == 1
            files = {}
            for t, d in report["tenants"].items():
                mw = {"w1": w1, "w2": w2}[d["survivor"]]
                tdir = mw.durability.tenant_dir(t)
                assert (tdir / "latest" / ".done").exists()
                files[t] = (tdir / "wal.log").read_bytes()
            # the zombie is fenced at the durable boundary
            text = refusal(lambda: w0.durability.wal(0).txn("zombie", {}).__enter__())
            assert text.startswith("FencingError")
            assert fo(P).OwnershipMap.replay(
                om.observations, seed=11).transition_digest() == om.transition_digest()
            return {"report": relative(report, root), "text": text, "wals": files,
                    "fence": (root / "w0" / "FENCE").read_bytes(),
                    "summary": relative(json.loads(json.dumps(ctl.summary())), root)}

        ref, port = both(drive)
        assert_same("drill", port, ref)
        # ... and the port's drill replays bit-identically
        *_, again = run_drill(PP, tmp_path / "again")
        assert again["ownership_digest"] == port["report"]["ownership_digest"]

    def test_no_spare_capacity_refuses(self, tmp_path):
        P = PP
        w0 = managed(P, tmp_path, "w0", (0,), 1)
        w1 = managed(P, tmp_path, "w1", (1,), 1)  # zero spare slots
        st = w0.arena.tenants[0]
        drive_tenant(P, st, "full", nothing)
        w0.arena.sync()
        w0.durability.checkpoint(st, 0, step=1)
        ctl = controller(P, fo(P).OwnershipMap(seed=0))
        ctl.register(w0, now=0.0)
        ctl.register(w1, now=0.0)
        with pytest.raises(fo(P).FailoverError, match="spare"):
            ctl.failover("w0", now=1.0)

    def test_unknown_worker_refuses(self):
        ctl = fo().FailoverController(fo().OwnershipMap(seed=0))
        with pytest.raises(fo().FailoverError, match="unknown"):
            ctl.failover("ghost", now=1.0)

    def test_absorb_recovers_on_the_target_arenas_device(self, tmp_path, monkeypatch):
        """`_absorb` passes the target arena's device to `recover_tenant`
        (whose default is the card): a CPU fleet never needs a card, and
        a card fleet never recovers on the CPU."""
        recovery = PORT.resilience.recovery
        seen = []
        real = recovery.recover_tenant

        def spy(*args, **kwargs):
            seen.append(kwargs.get("device"))
            return real(*args, **kwargs)

        monkeypatch.setattr(recovery, "recover_tenant", spy)
        *_, report = run_drill(PP, tmp_path)
        assert len(report["tenants"]) == 2
        assert [str(d) for d in seen] == ["cpu", "cpu"]


# ── fleet-layer chaos scheduling ─────────────────────────────────────


class TestFleetChaos:
    def test_take_fleet_faults_is_seeded_and_once_only(self):
        def drive(P):
            chaos = P.mod("testing.chaos")
            plan = chaos.WaveChaosPlan(seed=5, fleet_faults=(
                chaos.InjectedFleetFault("worker_sigkill", at_round=2, worker="w0"),
                chaos.InjectedFleetFault("torn_checkpoint", at_round=4, worker="w1"),
                chaos.InjectedFleetFault("worker_sigstop", at_round=2, worker="w2"),
            ))
            inj = chaos.WaveChaosInjector(plan)
            assert inj.has_pending_fleet_faults
            assert inj.take_fleet_faults(1) == []
            due = inj.take_fleet_faults(2)
            assert sorted(f.kind for f in due) == ["worker_sigkill", "worker_sigstop"]
            assert inj.take_fleet_faults(2) == []  # handed out exactly once
            (late,) = inj.take_fleet_faults(9)     # overdue faults still fire
            assert late.kind == "torn_checkpoint"
            assert not inj.has_pending_fleet_faults
            doc = inj.report()

            # adding fleet faults never perturbs the wave-layer schedule
            def sched(i):
                out = []
                for _ in range(32):
                    try:
                        i.on_dispatch("governance_wave")
                        out.append(0)
                    except Exception:
                        out.append(1)
                return out

            bare = sched(chaos.WaveChaosInjector(chaos.WaveChaosPlan(seed=5, fail_rate=0.3)))
            with_faults = sched(chaos.WaveChaosInjector(chaos.WaveChaosPlan(
                seed=5, fail_rate=0.3, fleet_faults=(chaos.InjectedFleetFault(),))))
            assert bare == with_faults
            return {"report": doc, "schedule": bare}

        ref, port = both(drive)
        assert_same("fleet chaos", port, ref)


# ── API surface ──────────────────────────────────────────────────────


def service(P: Pkg):
    svc_mod = P.mod("api.service")
    if P.is_ref:
        return svc_mod.HypervisorService()
    return svc_mod.HypervisorService(hypervisor=PORT.Hypervisor(device="cpu"))


def answer(P: Pkg, coro) -> tuple:
    """(status, JSON body) of one service call, as the transport maps it."""
    ApiError = P.mod("api.service").ApiError
    try:
        return 200, json.loads(json.dumps(asyncio.run(coro)))
    except ApiError as err:
        return err.status, str(err)


class TestFailoverApi:
    def test_routes_registered_on_the_shared_table(self):
        from hypervisor_tpu_torch.api.server import ROUTES

        paths = {r[1] for r in ROUTES}
        assert "/fleet/ownership" in paths and "/fleet/failover" in paths

    def test_503_without_fleet_then_without_plane(self):
        def drive(P):
            svc = service(P)
            out = [answer(P, svc.fleet_ownership()), answer(P, svc.fleet_failover())]
            svc.fleet = P.mod("fleet").FleetObservatory({})
            out += [answer(P, svc.fleet_ownership()), answer(P, svc.fleet_failover())]
            assert [s for s, _ in out] == [503] * 4
            assert "ownership" in out[2][1] and "failover" in out[3][1]
            return out

        ref, port = both(drive)
        assert port == ref

    def test_attached_planes_serve_their_summaries(self):
        def drive(P):
            svc = service(P)
            svc.fleet = P.mod("fleet").FleetObservatory({})
            om = fo(P).OwnershipMap(seed=9)
            om.assign("w0", (0,), 0, 1.0)
            svc.fleet.ownership = om
            svc.fleet.failover = fo(P).FailoverController(om)
            doc = answer(P, svc.fleet_ownership())
            doc2 = answer(P, svc.fleet_failover())
            assert doc[1]["owners"]["w0"]["tenants"] == [0]
            assert doc[1]["transition_digest"] == om.transition_digest()
            assert doc2[1]["epoch"] == 0 and doc2[1]["reassignments"] == []
            return doc, doc2

        ref, port = both(drive)
        assert port == ref


# ── the durable worker's graceful drain ──────────────────────────────


class TestGracefulDrain:
    def test_sigterm_drain_hands_off_with_zero_replay(self, tmp_path):
        """SIGTERM → the worker (a subprocess on the CPU) flushes its WALs,
        publishes final per-tenant checkpoints + `.done`, prints the
        DRAINED marker, and exits 0; the adopter's recovery replays ZERO
        WAL records and its watermark is the marker's `wal_seq`."""
        from hypervisor_tpu_torch.fleet import FleetSupervisor, WorkerSpec
        from hypervisor_tpu_torch.fleet.worker import _small_capacity_config

        spec = WorkerSpec(worker_id="w0", tenants=(0, 1), durability_root=str(tmp_path),
                          epoch=0, device="cpu")
        sup = FleetSupervisor([spec], log_dir=str(tmp_path / "logs"))
        sup.start()
        try:
            marker = sup.drain("w0")
        finally:
            sup.stop()
        assert marker is not None
        assert marker["worker_id"] == "w0" and set(marker["tenants"]) == {"0", "1"}
        cfg = _small_capacity_config()
        for t in (0, 1):
            wal_seq = marker["tenants"][str(t)]["wal_seq"]
            assert wal_seq > 0  # warm rounds DID journal
            _, report = recover_tenant(PP, tmp_path / "w0" / "epoch_0", t, config=cfg)
            assert report["wal_records_replayed"] == 0
            assert report["wal_watermark_seq"] == wal_seq


# ── the reference's failover row ─────────────────────────────────────


def test_failover_drill_equals_the_reference_row():
    """`testing.fleet_drills.failover_drill` (seed 20, quick) on the CPU:
    the ownership digest, the counts and the survivors of the reference's
    `failover` row in `BENCH_r20.json` and `BENCH_r21.json`, one digest
    over two runs, no novel signature after the splice, zero bytes from
    the zombie."""
    from hypervisor_tpu_torch.testing.fleet_drills import failover_drill

    row = failover_drill(20, quick=True, device="cpu")
    keys = ("seed", "quick", "workers", "killed", "detection_windows", "budget_windows",
            "replayed_ops", "tenants_reassigned", "survivors", "zombie_fenced",
            "double_applied_ops", "post_splice_rounds", "recompiles_after_splice", "replays",
            "digest_match", "ownership_digest")
    for name in ("BENCH_r20.json", "BENCH_r21.json"):
        want = json.loads((REPO / name).read_text())["failover"]
        assert {k: row[k] for k in keys} == {k: want[k] for k in keys}, name
    assert row["zombie_bytes_written"] == 0
    assert row["ownership_digest"] == (
        "3cef592df82ea124c3a41d7aed44a64db98be774e08606dfe4e8f7e647fce196")
