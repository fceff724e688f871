"""The port's serving front door against the reference's, on the CPU.

Counterparts of `tests/unit/test_serving.py` on
`hypervisor_tpu_torch.serving` over `HypervisorState(device="cpu")`:
`FrontDoor` submits, sheds and typed refusals per class, the bucketed
waves, `WaveScheduler.tick`'s cadence with its deadline and margin rules,
the closed-bucket warm contract (0 novel signatures after `warm`), the
load generator, and `run_soak` with the reference's soak spec. Each case
runs one seeded sequence on both packages and holds every recorded value
equal (tolerance 0).

The wave wall is measured (`time.perf_counter` in the scheduler), and the
flight recorder's brackets are wall clock too, so `both` points the
scheduler's and the tracer's clocks of both packages at one
deterministic counter (each read advances it by 1 ms), besides the ids
and `time.time` (`test_torch_facade_api.install_determinism`). Under
that clock the whole soak report is held equal except `warm_s` and
`wall_s`, the soak's own wall times. Both packages run unarmed
(`HV_WAVE_PALLAS=0`) with the roofline observatory off (`HV_ROOFLINE=0`),
as every facade parity run does.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import pytest

import hypervisor_tpu as REF
import hypervisor_tpu_torch as PORT
from tests.test_torch_facade_api import ManualTime, assert_same, install_determinism

#: The reference's serving-test tables (`tests/unit/test_serving.py`).
SMALL = dict(max_agents=512, max_sessions=2048, max_vouch_edges=1024, max_sagas=256,
             delta_log_capacity=4096, event_log_capacity=1024, trace_log_capacity=1024)
#: Report keys that are the soak's own wall times.
WALL_KEYS = ("warm_s", "wall_s")


class FakeClock:
    """A `time` stand-in for the scheduler and the tracer: each
    `perf_counter()` read advances 1 ms; `time()` is constant."""

    def __init__(self) -> None:
        self.n = 0

    def perf_counter(self) -> float:
        self.n += 1
        return self.n * 1e-3

    def perf_counter_ns(self) -> int:
        return int(self.perf_counter() * 1e9)

    def time(self) -> float:
        return 1_000.0


class Pkg:
    """One package's modules for a sequence."""

    def __init__(self, pkg) -> None:
        self.pkg = pkg

    @property
    def is_ref(self) -> bool:
        return self.pkg is REF

    def mod(self, name: str):
        return importlib.import_module(f"{self.pkg.__name__}.{name}")

    @property
    def serving(self):
        return self.mod("serving")

    @property
    def mp(self):
        return self.mod("observability.metrics")

    def config(self, **caps):
        cfg = self.mod("config")
        defaults = dict(SMALL)
        defaults.update(caps)
        return dataclasses.replace(
            cfg.DEFAULT_CONFIG,
            capacity=dataclasses.replace(cfg.DEFAULT_CONFIG.capacity, **defaults))

    def state(self, default_tables: bool = False, **caps):
        state_mod = self.mod("state")
        cfg = self.mod("config").DEFAULT_CONFIG if default_tables else self.config(**caps)
        if self.is_ref:
            return state_mod.HypervisorState(cfg)
        return state_mod.HypervisorState(cfg, device="cpu")

    def session_config(self, **kw):
        return self.mod("models").SessionConfig(**kw)


def deterministic(mp: pytest.MonkeyPatch, pkg) -> None:
    """Ids, `time.time`, and the scheduler's and tracer's clocks."""
    install_determinism(mp, ManualTime())
    mp.setattr(importlib.import_module(f"{pkg.__name__}.serving.scheduler"), "time", FakeClock())
    mp.setattr(importlib.import_module(f"{pkg.__name__}.observability.tracing"), "time",
               FakeClock())


def both(drive):
    """`drive(Pkg)` on the reference, then on the port, each under the
    same deterministic ids and clocks; returns (reference, port)."""
    outs = []
    with pytest.MonkeyPatch.context() as env:
        env.setenv("HV_WAVE_PALLAS", "0")
        env.setenv("HV_SHA256_PALLAS", "0")
        env.setenv("HV_ROOFLINE", "0")
        for name in ("HV_TRACE", "HV_TRACE_SAMPLE", "HV_INTEGRITY_EVERY", "HV_SCRUB_EVERY",
                     "HV_SERVE_BUCKETS", "HV_SERVE_JOIN_DEADLINE_S",
                     "HV_SERVE_ACTION_DEADLINE_S", "HV_SERVE_LIFECYCLE_DEADLINE_S",
                     "HV_SERVE_TERMINATE_DEADLINE_S", "HV_SERVE_SAGA_DEADLINE_S",
                     "HV_SERVE_RETRY_AFTER_S"):
            env.delenv(name, raising=False)
        for pkg in (REF, PORT):
            with pytest.MonkeyPatch.context() as mp:
                deterministic(mp, pkg)
                outs.append(drive(Pkg(pkg)))
    return outs[0], outs[1]


def same(drive):
    """Run `drive` on both packages and hold the records equal."""
    ref, port = both(drive)
    assert_same("record", port, ref)
    return port


def ticket_record(t) -> dict:
    """A ticket or a refusal as plain values."""
    if t.refused:
        return {"refused": True, **t.to_dict()}
    out = dict(t.to_dict())
    out.update(
        refused=False, submitted_at=t.submitted_at, deadline_s=t.deadline_s,
        served_at=t.served_at, latency_s=t.latency_s, queue_wait_s=t.queue_wait_s,
        pad_wait_s=t.pad_wait_s, wave_wall_s=t.wave_wall_s, wave_seq=t.wave_seq,
        result=t.result,
    )
    return out


def front_record(front) -> dict:
    return {
        "summary": front.summary(),
        "slo": front.slo.summary(),
        "attribution": front.attribution.summary(),
        "exemplars": front.attribution.exemplars(),
        "recent": front.attribution.recent_paths(64),
        "depths": front.queue_depths(),
    }


def served(P: Pkg, buckets=(4, 8)):
    state = P.state()
    front = P.serving.FrontDoor(state, P.serving.ServingConfig(buckets=buckets))
    return state, front, P.serving.WaveScheduler(front)


# ── the front door's queues and refusals ─────────────────────────────


def test_submit_join_returns_ticket_and_wave_resolves_it():
    def drive(P):
        state, front, sched = served(P)
        slot = state.create_session("s", P.session_config(min_sigma_eff=0.0), now=0.0)
        out = front.submit_join(slot, "did:a", 0.8, now=0.0)
        rec = {"first": ticket_record(out), "depths": front.queue_depths()}
        rec["tick0"] = sched.tick(now=0.0)
        rec["done0"] = out.done
        rec["tick1"] = sched.tick(now=0.0 + front.config.join_deadline_s + 0.001)
        rec["ticket"] = ticket_record(out)
        rec["member"] = state.is_member(slot, "did:a")
        rec["last_wave"] = front.last_wave["join"]
        return rec

    rec = same(drive)
    assert rec["tick0"]["join"] == 0 and rec["tick1"]["join"] == 1
    assert rec["ticket"]["ok"] and rec["ticket"]["status"] == 0 and rec["member"]
    assert rec["last_wave"] == {"lanes": 1, "bucket": 4, "fill_pct": 25.0}


def test_bucket_fill_dispatches_without_deadline():
    def drive(P):
        state, front, sched = served(P)
        slot = state.create_session(
            "s", P.session_config(min_sigma_eff=0.0, max_participants=64), now=0.0)
        tickets = [front.submit_join(slot, f"did:fill{i}", 0.8, now=0.0)
                   for i in range(front.config.max_bucket)]
        report = sched.tick(now=0.0)
        return {"report": report, "last": front.last_wave["join"],
                "tickets": [ticket_record(t) for t in tickets]}

    rec = same(drive)
    assert rec["report"]["join"] == 1 and rec["last"]["fill_pct"] == 100.0


def test_join_queue_full_is_typed_backpressure():
    def drive(P):
        state, front, sched = served(P)
        slot = state.create_session(
            "s", P.session_config(min_sigma_eff=0.0, max_participants=64), now=0.0)
        accepted = [front.submit_join(slot, f"did:q{i}", 0.8, now=0.0).refused
                    for i in range(front.config.join_queue_depth)]
        out = front.submit_join(slot, "did:overflow", 0.8, now=0.0)
        return {"accepted": accepted, "overflow": ticket_record(out),
                "retry_after_s": out.retry_after_s, "shed": dict(front.shed)}

    rec = same(drive)
    assert not any(rec["accepted"])
    assert rec["overflow"]["kind"] == "queue_full" and rec["retry_after_s"] > 0
    assert rec["shed"]["queue_full"] == 1


def test_degraded_policy_sheds_admissions_but_not_terminations_or_sagas():
    def drive(P):
        state, front, sched = served(P)
        policy = P.mod("resilience.policy")
        slot = state.create_session("s", P.session_config(min_sigma_eff=0.0), now=0.0)
        state.degraded_policy = policy.DegradedPolicy(reason="drill")
        rec = {
            "join": ticket_record(front.submit_join(slot, "did:shed", 0.8, now=0.0)),
            "lifecycle": ticket_record(front.submit_lifecycle("lc", "did:lc", 0.8, now=0.0)),
            "terminate": ticket_record(front.submit_terminate(slot, now=0.0)),
            "saga": ticket_record(front.submit_saga_step(0, True, now=0.0)),
        }
        state.degraded_policy = None
        rec["shed"] = dict(front.shed)
        rec["slo"] = front.slo.summary()
        return rec

    rec = same(drive)
    assert rec["join"]["kind"] == rec["lifecycle"]["kind"] == "degraded"
    assert not rec["terminate"]["refused"] and not rec["saga"]["refused"]
    assert rec["shed"]["degraded"] == 2


def test_sybil_floor_sheds_low_sigma_only():
    def drive(P):
        state, front, sched = served(P)
        policy = P.mod("resilience.policy")
        slot = state.create_session(
            "s", P.session_config(min_sigma_eff=0.0, max_participants=64), now=0.0)
        state.degraded_policy = policy.DegradedPolicy(
            shed_admissions=False, pause_saga_fanout=False, admission_sigma_floor=0.5,
            reason="damper drill")
        rec = {
            "low": ticket_record(front.submit_lifecycle("lc2", "did:low", 0.2, now=0.0)),
            "low_join": ticket_record(front.submit_join(slot, "did:lowj", 0.1, now=0.0)),
            "high": ticket_record(front.submit_join(slot, "did:high", 0.9, now=0.0)),
        }
        state.degraded_policy = None
        rec["shed"] = dict(front.shed)
        return rec

    rec = same(drive)
    assert rec["low"]["kind"] == rec["low_join"]["kind"] == "sybil_damped"
    assert not rec["high"]["refused"]


def test_duplicate_join_refused_before_staging():
    def drive(P):
        state, front, sched = served(P)
        slot = state.create_session("s", P.session_config(min_sigma_eff=0.0), now=0.0)
        first = front.submit_join(slot, "did:dup", 0.8, now=0.0)
        again = front.submit_join(slot, "did:dup", 0.8, now=0.0)
        sched.drain(now=1.0)
        member_again = front.submit_join(slot, "did:dup", 0.8, now=2.0)
        return {"first": ticket_record(first), "again": ticket_record(again),
                "member_again": ticket_record(member_again), "front": front_record(front)}

    rec = same(drive)
    assert rec["again"]["kind"] == rec["member_again"]["kind"] == "duplicate"


def test_sealed_door_refuses_every_class_and_still_drains():
    def drive(P):
        state, front, sched = served(P)
        slot = state.create_session("s", P.session_config(min_sigma_eff=0.0), now=0.0)
        queued = front.submit_join(slot, "did:before", 0.8, now=0.0)
        front.seal("migration")
        refusals = [ticket_record(x) for x in (
            front.submit_join(slot, "did:after", 0.8, now=0.0),
            front.submit_action(0, now=0.0),
            front.submit_lifecycle("lc", "did:lc", 0.8, now=0.0),
            front.submit_terminate(slot, now=0.0),
            front.submit_saga_step(0, True, now=0.0),
        )]
        waves = sched.drain(now=1.0)
        front.unseal()
        return {"refusals": refusals, "sealed": front.sealed, "waves": waves,
                "queued": ticket_record(queued), "front": front_record(front)}

    rec = same(drive)
    assert all(r["kind"] == "queue_full" for r in rec["refusals"])
    assert rec["queued"]["done"] and rec["waves"] == 1


def test_serving_metrics_reach_the_plane():
    def drive(P):
        state, front, sched = served(P)
        slot = state.create_session("s", P.session_config(min_sigma_eff=0.0), now=0.0)
        front.submit_join(slot, "did:m", 0.8, now=0.0)
        sched.drain(now=1.0)
        text = state.metrics_prometheus()
        serving_lines = [line for line in text.splitlines()
                         if line.startswith(("hv_serving_", "# EXEMPLAR"))
                         and not line.startswith("hv_serving_attr_latency_us_sum")]
        health = state.health_summary()
        return {"lines": serving_lines, "summary": state.serving_summary(),
                "health_serving": health["serving"], "health_slo": health["slo"],
                "slo": state.slo_summary()}

    rec = same(drive)
    assert 'hv_serving_enqueued_total{queue="join"} 1' in rec["lines"]
    assert 'hv_serving_served_total{queue="join"} 1' in rec["lines"]
    assert any(line.startswith("# EXEMPLAR hv_serving_latency_us_bucket") for line in rec["lines"])
    assert rec["summary"]["enabled"] and rec["summary"]["queues"]["join"]["served"] == 1
    assert rec["health_serving"]["enabled"] and rec["health_slo"]["enabled"]


def test_bare_state_panels_are_disabled():
    def drive(P):
        state = P.state()
        health = state.health_summary()
        return {"serving": state.serving_summary(), "slo": state.slo_summary(),
                "health": (health["serving"], health["slo"])}

    rec = same(drive)
    assert rec["serving"] == rec["slo"] == {"enabled": False}


# ── the bucketed waves ───────────────────────────────────────────────


def test_padded_flush_matches_unpadded_and_metrics_stay_honest():
    def drive(P):
        def run(pad_to):
            st = P.state()
            slot = st.create_session(
                "s", P.session_config(min_sigma_eff=0.0, max_participants=16), now=0.0)
            for i in range(3):
                st.enqueue_join(slot, f"did:p{i}", 0.8, now=0.0)
            status = np.asarray(st.flush_joins(now=0.0, pad_to=pad_to))
            snap = st.metrics_snapshot()
            return {"status": status.tolist(), "admitted": snap.counter(P.mp.ADMITTED),
                    "refused": snap.counter(P.mp.REFUSED), "members": sorted(st._members)}

        return {"plain": run(None), "padded": run(8)}

    rec = same(drive)
    assert rec["plain"] == rec["padded"]


def test_padded_governance_wave_bit_identical_to_unpadded():
    def drive(P):
        def run(pad_to):
            st = P.state()
            slots = st.create_sessions_batch(["a", "b", "c"], P.session_config(min_sigma_eff=0.0))
            rng = np.random.RandomState(3)
            bodies = rng.randint(0, 2**32, (2, 3, 16), dtype=np.uint64).astype(np.uint32)
            r = st.run_governance_wave(slots, ["did:0", "did:1", "did:2"], slots.copy(),
                                       np.full(3, 0.8, np.float32), bodies, now=0.0,
                                       pad_to=pad_to)
            snap = st.metrics_snapshot()
            status = r.status.cpu().numpy() if hasattr(r.status, "cpu") else np.asarray(r.status)
            return {
                "status": status.tolist(),
                "chain": {int(s): np.asarray(v).astype(np.uint32).tolist()
                          for s, v in st._chain_seed.items()},
                "cursor": int(np.asarray(st.delta_log.cursor.cpu() if hasattr(st.delta_log.cursor, "cpu") else st.delta_log.cursor)),
                "admitted": snap.counter(P.mp.ADMITTED),
                "refused": snap.counter(P.mp.REFUSED),
                "archived": snap.counter(P.mp.SESSIONS_ARCHIVED),
                "saga_committed": snap.counter(P.mp.SAGA_STEPS_COMMITTED),
                "saga_failed": snap.counter(P.mp.SAGA_STEPS_FAILED),
            }

        return {"plain": run(None), "padded": run((8, 8))}

    rec = same(drive)
    assert rec["plain"] == rec["padded"]


def test_padded_terminate_trims_and_park_is_idempotent():
    def drive(P):
        st = P.state()
        front = P.serving.FrontDoor(st, P.serving.ServingConfig(buckets=(4,)))
        slot = st.create_session("s", P.session_config(min_sigma_eff=0.0), now=0.0)
        st.enqueue_join(slot, "did:t", 0.8, now=0.0)
        st.flush_joins(now=0.0)
        park = front.park_slot(0.0)
        roots = np.asarray(st.terminate_sessions([slot], now=1.0, pad_to=4, pad_slot=park))
        slot2 = st.create_session("s2", P.session_config(min_sigma_eff=0.0), now=2.0)
        roots2 = np.asarray(st.terminate_sessions([slot2], now=3.0, pad_to=4, pad_slot=park))
        return {"roots": roots.astype(np.uint32).tolist(), "shape": roots.shape,
                "roots2": roots2.astype(np.uint32).tolist(), "park": park,
                "same_park": front.park_slot(5.0) == park}

    rec = same(drive)
    assert rec["shape"] == (1, 8) and rec["same_park"]


def test_pad_below_wave_size_refused():
    def drive(P):
        st = P.state()
        slot = st.create_session("s", P.session_config(min_sigma_eff=0.0), now=0.0)
        for i in range(5):
            st.enqueue_join(slot, f"did:b{i}", 0.8, now=0.0)
        out = {}
        for label, call in (
            ("flush", lambda: st.flush_joins(now=0.0, pad_to=4)),
            ("terminate", lambda: st.terminate_sessions([slot, slot], now=0.0, pad_to=1,
                                                        pad_slot=0)),
            ("no_park", lambda: st.terminate_sessions([slot], now=0.0, pad_to=4)),
        ):
            try:
                call()
                out[label] = None
            except ValueError as e:
                out[label] = str(e)
        return out

    rec = same(drive)
    assert "below the staged" in rec["flush"] and "below the wave size" in rec["terminate"]
    assert "requires pad_slot" in rec["no_park"]


@pytest.mark.parametrize("n", [1, 4, 5, 16, 17])
def test_scheduler_bucket_for(n):
    def drive(P):
        front = P.serving.FrontDoor(P.state(), P.serving.ServingConfig(buckets=(4, 16)))
        try:
            return P.serving.WaveScheduler(front).bucket_for(n)
        except ValueError as e:
            return str(e)

    same(drive)


# ── the scheduler's cadence ──────────────────────────────────────────


def cadence_sequence(P, margin: float):
    """Every class submitted at staggered times, ticked on a 5 ms grid:
    which class dispatches at which tick follows the fill, deadline and
    margin rules."""
    cfg = P.serving.ServingConfig(
        buckets=(2, 4), join_deadline_s=0.03, action_deadline_s=0.02,
        lifecycle_deadline_s=0.04, terminate_deadline_s=0.05, saga_deadline_s=0.025,
        dispatch_margin_s=margin)
    state = P.state()
    front = P.serving.FrontDoor(state, cfg)
    sched = P.serving.WaveScheduler(front)
    standing = state.create_session("std", P.session_config(min_sigma_eff=0.0), now=0.0)
    state.enqueue_join(standing, "did:std", 0.8, now=0.0)
    state.flush_joins(now=0.0)
    row = state.agent_row("did:std", standing)["slot"]
    sessions = [state.create_session(f"c{i}", P.session_config(min_sigma_eff=0.0), now=0.0)
                for i in range(3)]
    saga = state.create_saga("cad:saga", standing, [{"has_undo": False}])
    tickets, reports = [], []
    for step in range(24):
        now = step * 0.005
        if step == 1:
            tickets.append(front.submit_join(sessions[0], "did:j0", 0.8, now=now))
        if step == 2:
            tickets += [front.submit_action(row, required_ring=2, now=now) for _ in range(3)]
        if step == 3:
            tickets += [front.submit_lifecycle(f"lc{i}", f"did:lc{i}", 0.8, now=now)
                        for i in range(5)]
        if step == 4:
            tickets.append(front.submit_terminate(sessions[1], now=now))
            tickets.append(front.submit_saga_step(saga, True, now=now))
        if step == 6:
            tickets += [front.submit_join(sessions[2], f"did:jj{i}", 0.8, now=now)
                        for i in range(4)]
        reports.append(sched.tick(now=now))
    return {"reports": reports, "ticks": sched.ticks,
            "tickets": [ticket_record(t) for t in tickets], "front": front_record(front)}


@pytest.mark.parametrize("margin", [0.0, 0.01])
def test_tick_cadence_follows_fill_deadline_and_margin(margin):
    rec = same(lambda P: cadence_sequence(P, margin))
    first = {}
    for i, report in enumerate(rec["reports"]):
        for q, n in report.items():
            if n and q not in first:
                first[q] = i
    # The lone join of step 1 is due at its deadline (step 7), less the
    # margin (step 5); without the margin the bucket fills first, at the
    # joins of step 6, and dispatches at once.
    assert first["join"] == (6 if margin == 0.0 else 5)
    assert first["lifecycle"] == 3  # 5 lifecycles: one full bucket of 4 now
    assert all(t["done"] for t in rec["tickets"] if not t["refused"])


# ── the closed-bucket warm contract ──────────────────────────────────


def test_warm_creates_the_reference_sessions_and_counts():
    def drive(P):
        state = P.state()
        P.mod("integrity").IntegrityPlane(state, every=8)
        front = P.serving.FrontDoor(state, P.serving.ServingConfig(buckets=(2, 4)))
        sched = P.serving.WaveScheduler(front)
        sched.warm(now=0.0)
        return {"sessions": list(state.session_ids._to_string),
                "next_session": state._next_session_slot, "park": front._park_slot,
                "members": sorted(state._members)}

    rec = same(drive)
    assert {f"serving:warm:b{b}:s{s}" for b in (2, 4) for s in (0, 1)} <= set(rec["sessions"])


def test_warmed_scheduler_holds_zero_novel_signatures():
    """The reference's 1k-wave pin at 400 waves: after `warm`, no dispatch
    of a seeded mix of every class shows the port's compile watch a novel
    signature."""
    health = PORT.observability.health
    P = Pkg(PORT)
    state = P.state()
    P.mod("integrity").IntegrityPlane(state, every=8)
    front = P.serving.FrontDoor(state, P.serving.ServingConfig(buckets=(4,)))
    sched = P.serving.WaveScheduler(front)
    baseline = sched.warm(now=0.0)
    rng = np.random.RandomState(11)
    live: list[int] = []
    waves = i = 0
    while waves < 400:
        now = float(i) * 0.01
        kind = rng.randint(0, 5)
        if kind == 0 or not live:
            front.submit_lifecycle(f"zr:{i}", f"did:zr:{i}", 0.8, now=now)
        elif kind == 1:
            slot = state.create_session(f"zrs:{i}", P.session_config(min_sigma_eff=0.0), now=now)
            live.append(slot)
            front.submit_join(slot, f"did:zrj:{i}", 0.8, now=now)
        elif kind == 2:
            rows = [r for s in live for r in state.agent_rows(f"did:zrj:{s}")]
            if rows:
                front.submit_action(rows[0]["slot"], required_ring=2, now=now)
        elif kind == 3:
            front.submit_terminate(live.pop(), now=now)
        else:
            saga = state.create_saga(f"zrg:{i}", live[0], [{"has_undo": False}])
            front.submit_saga_step(saga, True, now=now)
        waves += sum(sched.tick(now=now + 1.0).values())
        i += 1
    state.metrics_snapshot()
    summary = health.compile_summary(last=0)
    assert summary["compiles"] == baseline["compiles"], "a novel signature after warm-up"
    assert summary["recompiles"] == baseline["recompiles"]


# ── the load generator and the soak ──────────────────────────────────


def test_trace_generation_matches_reference_and_is_seed_deterministic():
    def drive(P):
        spec = P.serving.WorkloadSpec(seed=5, rate_hz=300.0, duration_s=1.0)
        trace = P.serving.generate_trace(spec)
        other = P.serving.generate_trace(P.serving.WorkloadSpec(seed=6, rate_hz=300.0,
                                                                duration_s=1.0))
        return {"trace": trace, "again": trace == P.serving.generate_trace(spec),
                "differs": trace != other, "kinds": sorted({e["kind"] for e in trace})}

    rec = same(drive)
    assert rec["again"] and rec["differs"]
    assert set(rec["kinds"]) >= {"lifecycle", "create", "join", "action", "terminate", "saga"}


def test_trace_file_round_trip_reads_the_other_package(tmp_path):
    spec_ref = REF.serving.WorkloadSpec(seed=5, rate_hz=100.0, duration_s=0.3)
    trace = REF.serving.generate_trace(spec_ref)
    path = REF.serving.save_trace(tmp_path / "ref.jsonl", spec_ref, trace)
    spec_port, trace_port = PORT.serving.load_trace(path)
    assert spec_port.to_dict() == spec_ref.to_dict() and trace_port == trace
    back = PORT.serving.save_trace(tmp_path / "port.jsonl", spec_port, trace_port)
    assert back.read_bytes() == path.read_bytes()


def soak_report(P, spec_kw: dict, default_tables: bool, **kw) -> dict:
    report = P.serving.run_soak(
        P.serving.WorkloadSpec(**spec_kw), state=P.state(default_tables=default_tables), **kw)
    return {k: v for k, v in report.items() if k not in WALL_KEYS}


def test_soak_report_matches_reference_on_the_default_tables():
    """The reference's `soak` row spec (seed 11, 150 Hz; BENCH_r11-r21) at
    a CPU-sized 0.2 s, on the default tables, with the integrity plane
    attached every 8th dispatch: the whole report equal, wall times
    aside."""
    rec = same(lambda P: soak_report(P, dict(seed=11, rate_hz=150.0, duration_s=0.2),
                                     default_tables=True))
    assert rec["compiles_after_warmup"] == 0 and rec["recompiles_after_warmup"] == 0
    assert rec["invariant_violations"] == 0 and rec["served"] > 0
    assert rec["offered"]["total"] == rec["served"] + sum(rec["shed"].values()) + rec["orphaned"]


def test_soak_replay_determinism_and_invariants():
    spec_kw = dict(seed=9, rate_hz=80.0, duration_s=0.4)

    def drive(P):
        cfg = P.serving.ServingConfig(
            buckets=(4,), join_deadline_s=0.2, action_deadline_s=0.2,
            lifecycle_deadline_s=0.3, terminate_deadline_s=0.4, saga_deadline_s=0.2)
        return soak_report(P, spec_kw, False, serving_config=cfg, tick_s=0.02,
                           slo_p99_ms=10_000.0)

    rec = same(drive)
    again = soak_report(Pkg(PORT), spec_kw, False, serving_config=PORT.serving.ServingConfig(
        buckets=(4,), join_deadline_s=0.2, action_deadline_s=0.2, lifecycle_deadline_s=0.3,
        terminate_deadline_s=0.4, saga_deadline_s=0.2), tick_s=0.02, slo_p99_ms=10_000.0)
    for key in ("decisions_digest", "chain_heads_digest", "served", "shed", "offered",
                "orphaned", "waves", "padded_lanes"):
        assert again[key] == rec[key], key
    assert rec["compiles_after_warmup"] == 0 and rec["invariant_violations"] == 0
    assert rec["served"] > 0 and rec["latency_ms"]["p99"] > 0


def test_soak_refuses_the_autopilot_naming_a_later_slice():
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        PORT.serving.run_soak(PORT.serving.WorkloadSpec(duration_s=0.01),
                              state=Pkg(PORT).state(), autopilot=True)


# ── the facade's front door ──────────────────────────────────────────


def test_attach_front_door_serves_through_the_facade():
    def drive(P):
        hv = P.pkg.Hypervisor(state=P.state())
        fd = hv.attach_front_door(P.serving.ServingConfig(buckets=(2, 4)))
        sched = hv.serving_scheduler
        rec = {"types": (type(fd).__name__, type(sched).__name__),
               "same": hv.attach_front_door() is fd and hv.state.serving is fd}
        slot = hv.state.create_session("fd", P.session_config(min_sigma_eff=0.0), now=0.0)
        tickets = [fd.submit_join(slot, f"did:fd{i}", 0.8, now=0.0) for i in range(3)]
        tickets.append(fd.submit_lifecycle("fd:lc", "did:fd:lc", 0.7, now=0.0))
        rec["waves"] = sched.drain(now=0.5)
        rec["tickets"] = [ticket_record(t) for t in tickets]
        rec["serving"] = hv.state.serving_summary()
        rec["slo"] = hv.state.slo_summary()
        return rec

    rec = same(drive)
    assert rec["types"] == ("FrontDoor", "WaveScheduler") and rec["same"]
    assert all(t["ok"] for t in rec["tickets"])
