"""The port's latency observatory against the reference's, on the CPU.

`observability/slo.py` and `observability/attribution.py` are copies of
the reference's modules (held as text by
`test_torch_host_engines.test_copied_modules_equal_the_reference`); these
are the counterparts of `tests/unit/test_slo.py`, each run on both
packages with every recorded value held equal (tolerance 0): the
burn-rate engine, the critical-path aggregator, the decomposition on
real serving waves of `HypervisorState(device="cpu")`, the live
Retry-After hint, and the supervisor acting on a critical burn. The
waves run under `test_torch_serving.both`'s deterministic clocks.
"""

from __future__ import annotations

import dataclasses
import json

import pytest

import hypervisor_tpu_torch as PORT
from tests.test_torch_serving import Pkg, front_record, same, ticket_record


def objectives(P, target=0.99, deadline=0.1):
    slo = P.mod("observability.slo")
    return {q: slo.SLOObjective(queue=q, target=target, deadline_s=deadline)
            for q in ("join", "lifecycle")}


def engine(P, **kw):
    return P.mod("observability.slo").SLOEngine(objectives(P, target=0.9), **kw)


def alerts(found) -> list:
    return [dataclasses.asdict(a) for a in found]


# ── the burn-rate engine ─────────────────────────────────────────────


def test_burn_rate_is_bad_fraction_over_budget():
    def drive(P):
        eng = engine(P, min_events=1)
        for i in range(10):
            eng.note("join", t=float(i), good=i >= 5)
        return eng.burn_rates("join", now=10.0)

    rec = same(drive)
    assert rec == pytest.approx((5.0, 5.0, 5.0))


def test_windows_evict_old_events():
    def drive(P):
        eng = engine(P, fast_window_s=10.0, slow_window_s=100.0, long_window_s=1000.0,
                     min_events=1)
        for i in range(10):
            eng.note("join", t=float(i), good=False)
        for i in range(10):
            eng.note("join", t=500.0 + i, good=True)
        return eng.burn_rates("join", now=510.0)

    fast, slow, long_ = same(drive)
    assert fast == slow == 0.0 and long_ == pytest.approx(5.0)


def test_transitions_warning_critical_recovered():
    def drive(P):
        fired = []
        eng = engine(P, fast_window_s=10.0, slow_window_s=20.0, long_window_s=40.0,
                     critical_burn=8.0, warning_burn=4.0, min_events=4,
                     emit=lambda kind, payload: fired.append((kind, payload)))
        for i in range(8):
            eng.note("join", t=float(i) * 0.1, good=i % 2 == 0)
        rec = {"warn": alerts(eng.evaluate(now=1.0)), "state1": eng.state_of("join")}
        for i in range(30):
            eng.note("join", t=1.0 + i * 0.1, good=False)
        rec["crit"] = alerts(eng.evaluate(now=4.0))
        rec["hold"] = alerts(eng.evaluate(now=4.5))
        for i in range(20):
            eng.note("join", t=100.0 + i * 0.1, good=True)
        rec["recovered"] = alerts(eng.evaluate(now=103.0))
        rec.update(state=eng.state_of("join"), fired=fired, counts=dict(eng.alert_counts),
                   summary=eng.summary())
        return rec

    rec = same(drive)
    assert [k for k, _ in rec["fired"]] == ["slo_burn_warning", "slo_burn_critical",
                                            "slo_recovered"]
    assert rec["hold"] == [] and rec["counts"] == {"warning": 1, "critical": 1, "recovered": 1}


def test_min_events_guard_keeps_cold_classes_quiet():
    def drive(P):
        eng = P.mod("observability.slo").SLOEngine(objectives(P, target=0.99), min_events=24)
        for i in range(10):
            eng.note("join", t=float(i), good=False)
        return alerts(eng.evaluate(now=10.0)), eng.state_of("join")

    found, state = same(drive)
    assert found == [] and state == "ok"


def test_alert_log_replays_deterministically():
    def drive(P):
        def run():
            eng = engine(P, fast_window_s=10.0, slow_window_s=20.0, long_window_s=40.0,
                         critical_burn=8.0, warning_burn=4.0, min_events=4)
            for i in range(40):
                eng.note("join", t=i * 0.25, good=i % 3 == 0)
                if i % 5 == 0:
                    eng.evaluate(now=i * 0.25)
            eng.evaluate(now=10.0)
            return eng.alert_digest(), eng.recent_alerts()

        return run(), run()

    (d1, a1), (d2, a2) = same(drive)
    assert d1 == d2 and a1 == a2 and a1


def test_backoff_multiplier_follows_state():
    def drive(P):
        slo = P.mod("observability.slo")
        eng = P.mod("observability.slo").SLOEngine(objectives(P), min_events=1)
        out = [eng.backoff_multiplier("join")]
        for state in (slo.WARNING, slo.CRITICAL):
            eng._classes["join"].state = state
            out.append(eng.backoff_multiplier("join"))
        return out

    assert same(drive) == [1.0, 2.0, 4.0]


def test_objectives_from_the_serving_config_defaults():
    def drive(P):
        slo = P.mod("observability.slo")
        objs = slo.objectives_from_serving_config(P.serving.ServingConfig())
        return {q: dataclasses.asdict(o) for q, o in objs.items()}

    rec = same(drive)
    assert {q: o["deadline_s"] for q, o in rec.items()} == {
        "join": 0.05, "action": 0.05, "lifecycle": 0.1, "terminate": 0.2, "saga": 0.1}


# ── the critical-path aggregator ─────────────────────────────────────


def path(P, kind="join", q=0.1, p=0.02, w=0.05, trace_id="t/s"):
    return P.mod("observability.attribution").TicketPath(
        kind=kind, trace_id=trace_id, wave_seq=7, wave_trace_id="w/s", submitted_at=0.0,
        resolved_at=q + p, queue_wait_s=q, pad_wait_s=p, wave_wall_s=w, latency_s=q + p + w,
        deadline_s=0.25, deadline_missed=False, ok=True)


def aggregator(P):
    metrics = P.mod("observability.metrics")
    m = metrics.Metrics() if P.is_ref else metrics.Metrics(device="cpu")
    return P.mod("observability.attribution").CriticalPathAggregator(m)


def test_observe_feeds_histograms_and_exemplars():
    def drive(P):
        agg = aggregator(P)
        agg.observe(path(P))
        agg.observe(path(P, q=0.2, trace_id="t2/s2"))
        agg.observe(path(P, kind="lifecycle", w=2.0, trace_id="t3/s3"))
        return {"summary": agg.summary(), "lines": agg.exemplar_lines(),
                "exemplars": agg.exemplars(), "recent": agg.recent_paths(),
                "coverage": agg.exemplar_coverage()}

    rec = same(drive)
    assert rec["summary"]["tickets"] == 3 and rec["summary"]["max_sum_error_ms"] == 0.0
    assert any('trace_id="t2/s2"' in line for line in rec["lines"])


def test_sum_error_is_tracked():
    def drive(P):
        agg = aggregator(P)
        agg.observe(dataclasses.replace(path(P), latency_s=1.0))
        return agg.summary()

    assert same(drive)["max_sum_error_ms"] > 100.0


def test_wave_phase_shares_fold_the_residual():
    class Span:
        def __init__(self, stage, start, end, children=()):
            self.stage, self.start_us, self.end_us, self.children = stage, start, end, children

    spans = [Span("governance_wave", 0.0, 100.0, [Span("admission_wave", 0.0, 10.0),
                                                  Span("session_fsm", 10.0, 13.0),
                                                  Span("delta_chain", 13.0, 40.0)]),
             Span("gateway_wave", 0.0, 30.0, [Span("gateway_wave", 0.0, 29.0)]),
             Span("flush", 5.0, 5.0)]

    class Tracer:
        def drain(self):
            return spans

    def drive(P):
        attribution = P.mod("observability.attribution")
        return attribution.wave_phase_shares(Tracer()), attribution.wave_phase_shares(
            type("Empty", (), {"drain": lambda self: []})())

    shares, empty = same(drive)
    assert empty is None and sum(shares.values()) == pytest.approx(1.0, abs=1e-12)


# ── decomposition on real serving waves ──────────────────────────────


def observatory(P):
    state = P.state()
    front = P.serving.FrontDoor(state, P.serving.ServingConfig(buckets=(2, 4), slo_min_events=4))
    return state, front, P.serving.WaveScheduler(front)


def test_decomposition_partitions_measured_latency():
    def drive(P):
        state, front, sched = observatory(P)
        tickets = [front.submit_lifecycle(f"slo:lc{i}", f"did:slo:lc{i}", 0.8, now=0.01 * i)
                   for i in range(4)]
        sched.drain(now=1.0)
        return {"tickets": [ticket_record(t) for t in tickets], "front": front_record(front)}

    rec = same(drive)
    for t in rec["tickets"]:
        assert t["done"] and t["trace_id"] and t["wave_trace_id"]
        assert t["queue_wait_s"] + t["pad_wait_s"] + t["wave_wall_s"] == pytest.approx(
            t["latency_s"], abs=1e-9)
    assert rec["front"]["attribution"]["max_sum_error_ms"] < 1e-6


def test_ticket_joins_the_wave_trace():
    def drive(P):
        state, front, sched = observatory(P)
        out = front.submit_lifecycle("slo:join", "did:slo:join", 0.8, now=0.0)
        sched.drain(now=0.5)
        record = state.tracer._waves.get(out.wave_seq)
        return {"seq": out.wave_seq, "trace": record.trace.full_id, "stage": record.stage,
                "ticket": out.wave_trace_id}

    rec = same(drive)
    assert rec["trace"] == rec["ticket"] and rec["stage"] == "governance_wave"


def test_phase_shares_partition_the_wall():
    def drive(P):
        state, front, sched = observatory(P)
        for i in range(3):
            front.submit_lifecycle(f"slo:ph{i}", f"did:slo:ph{i}", 0.8, now=0.0)
        sched.drain(now=0.5)
        shares = front.attribution.phase_shares(state.tracer)
        last = front.attribution._recent[-1]
        return {"shares": shares,
                "phases": front.attribution.phase_decomposition(last, shares)}

    rec = same(drive)
    assert set(rec["shares"]) == set(PORT.observability.attribution.HV_PHASES)
    assert sum(rec["shares"].values()) == pytest.approx(1.0, abs=1e-9)


def test_exemplars_ride_the_prometheus_exposition():
    def drive(P):
        state, front, sched = observatory(P)
        front.submit_lifecycle("slo:ex", "did:slo:ex", 0.8, now=0.0)
        sched.drain(now=0.5)
        text = state.metrics_prometheus()
        return [line for line in text.splitlines()
                if line.startswith("# EXEMPLAR")
                or (line.startswith("hv_serving_attr_latency_us") and "_sum" not in line)]

    lines = same(drive)
    assert any(line.startswith("# EXEMPLAR hv_serving_latency_us_bucket") for line in lines)


def test_slo_summary_and_debug_payload_shape():
    def drive(P):
        state, front, sched = observatory(P)
        bare = P.state().slo_summary()
        front.submit_lifecycle("slo:sum", "did:slo:sum", 0.8, now=0.0)
        sched.drain(now=0.5)
        return {"bare": bare, "summary": state.slo_summary(),
                "health": state.health_summary()["slo"]}

    rec = same(drive)
    assert rec["bare"] == {"enabled": False} and rec["summary"]["enabled"]
    assert set(rec["summary"]["retry_after_live_s"]) == set(
        PORT.observability.metrics.SERVING_QUEUES)


def test_debug_payload_is_host_plane_clean():
    def drive(P):
        state, front, sched = observatory(P)
        for i in range(3):
            front.submit_lifecycle(f"slo:js{i}", f"did:slo:js{i}", 0.8, now=0.0)
        sched.drain(now=0.5)
        payload = {**state.slo_summary(),
                   "phase_shares": front.attribution.phase_shares(state.tracer),
                   "recent_paths": front.attribution.recent_paths(16),
                   "exemplar_rows": front.attribution.exemplars()}
        return json.dumps(payload, sort_keys=True)

    text = same(drive)
    assert all(type(p["ok"]) is bool for p in json.loads(text)["recent_paths"])


# ── the live Retry-After hint ────────────────────────────────────────


def test_draining_queue_beats_the_static_constant():
    def drive(P):
        state = P.state()
        front = P.serving.FrontDoor(state, P.serving.ServingConfig(buckets=(2, 4)))
        unwarmed = front.retry_after_for("join")
        object.__setattr__(front.config, "retry_after_s", 4.0)
        for i in range(1, 6):
            front._note_drain("join", lanes=4, now=float(i) * 0.1)
        shallow = front.retry_after_for("join")
        for _ in range(2):
            front.joins.append(P.mod("serving.front_door").Ticket(
                kind="join", submitted_at=0.0, deadline_s=1.0, payload={}))
        deeper = front.retry_after_for("join")
        front.slo._classes["join"].state = P.mod("observability.slo").CRITICAL
        return {"unwarmed": unwarmed, "shallow": shallow, "deeper": deeper,
                "burning": front.retry_after_for("join"), "waves": front._drain_waves["join"]}

    rec = same(drive)
    assert rec["shallow"] < 4.0 and rec["deeper"] > rec["shallow"]
    # A critical burn scales the hint 4x; each hint is rounded to 1 ms.
    assert rec["burning"] == pytest.approx(rec["deeper"] * 4.0, abs=4e-3)


def test_refusals_carry_the_live_hint():
    def drive(P):
        state = P.state()
        front = P.serving.FrontDoor(state, P.serving.ServingConfig(buckets=(2,)))
        sid = state.create_session("slo:rq", P.session_config(min_sigma_eff=0.0), now=0.0)
        accepted = [front.submit_join(sid, f"did:rq{i}", 0.8, now=0.0).refused
                    for i in range(2)]
        refusal = front.submit_join(sid, "did:rq-full", 0.8, now=0.0)
        dup = front.submit_join(sid, "did:rq0", 0.8, now=0.0)
        return {"accepted": accepted, "refusal": ticket_record(refusal),
                "retry": refusal.retry_after_s, "dup": ticket_record(dup),
                "bad": front.slo._classes["join"].bad_total}

    rec = same(drive)
    # The full queue refuses the duplicate too (depth is checked first),
    # and both overload sheds burn the class's budget.
    assert rec["refusal"]["kind"] == rec["dup"]["kind"] == "queue_full" and rec["bad"] == 2


# ── the supervisor acts on the burn signal ───────────────────────────


def griefed(P, state, min_events=4):
    return P.serving.FrontDoor(state, P.serving.ServingConfig(
        buckets=(2,), join_deadline_s=1e-6, action_deadline_s=1e-6, lifecycle_deadline_s=1e-6,
        terminate_deadline_s=1e-6, saga_deadline_s=1e-6, slo_min_events=min_events))


@pytest.mark.parametrize("act", [True, False])
def test_critical_burn_degrades_only_when_the_supervisor_acts(act):
    def drive(P):
        state = P.state()
        sup = P.mod("resilience.supervisor").Supervisor(state, degrade_on_slo_critical=act)
        front = griefed(P, state)
        sched = P.serving.WaveScheduler(front)
        outs = []
        for tick in range(8):
            out = front.submit_lifecycle(f"slo:g{tick}", f"did:g{tick}", 0.8, now=float(tick))
            outs.append(ticket_record(out))
            if out.refused:
                break
            sched.tick(now=float(tick) + 0.5)
        after = front.submit_lifecycle("slo:after", "did:after", 0.8, now=99.0)
        return {"outs": outs, "degraded": state.degraded_policy is not None,
                "alerts": sup.slo_critical_alerts, "entries": sup.slo_degraded_entries,
                "after": ticket_record(after), "shed": dict(front.shed)}

    rec = same(drive)
    assert rec["degraded"] is act and rec["alerts"] >= 1
    assert rec["shed"]["queue_full"] == 0
    assert (rec["after"]["refused"] and rec["after"]["kind"] == "degraded") is act


def test_alerts_bridge_to_the_event_bus():
    def drive(P):
        hv = P.pkg.Hypervisor(state=P.state(), event_bus=P.mod("observability").HypervisorEventBus())
        for kind in ("slo_burn_warning", "slo_burn_critical", "slo_recovered"):
            hv.state.health.emit_event(kind, {"queue": "join"})
        et = P.mod("observability").EventType
        return [[e.payload for e in hv.event_bus.query_by_type(t)]
                for t in (et.SLO_BURN_RATE_WARNING, et.SLO_BURN_RATE_CRITICAL, et.SLO_RECOVERED)]

    rec = same(drive)
    assert all(len(rows) == 1 and rows[0]["queue"] == "join" for rows in rec)


def test_warmed_scheduler_holds_zero_novel_signatures_with_attribution():
    P = Pkg(PORT)
    health = P.mod("observability.health")
    state, front, sched = observatory(P)
    sched.warm(now=0.0)
    baseline = health.compile_summary(last=0)
    for i in range(24):
        front.submit_lifecycle(f"slo:z{i}", f"did:z{i}", 0.8, now=float(i))
        sched.tick(now=float(i) + 0.5)
    sched.drain(now=99.0)
    after = health.compile_summary(last=0)
    assert after["compiles"] == baseline["compiles"]
    assert after["recompiles"] == baseline["recompiles"]
    assert front.attribution.summary()["tickets"] >= 24
