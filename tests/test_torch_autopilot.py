"""The port's autopilot against the reference's, on the CPU.

Counterparts of `tests/unit/test_autopilot.py` on
`hypervisor_tpu_torch.autopilot`: the signal snapshots' digests (rule
inputs covered, advisory fields excluded, the floor distance quantized),
the rule engine's proposal stream and the ledger's digest over one
synthetic stream, the plane on a real serving stack (the grow rule
pre-warms before it widens the closed bucket set, its decisions drain
into the metrics and the health events, outcomes are attributed one
window later, the kill switch), `IntegrityPlane.retune`, the state's
`autopilot_summary`, the incident bundles' `ledger` block,
`GET /debug/autopilot`, the DRR quantum rule through a tenant scheduler,
and `run_soak(autopilot=True)` on a shifting-mix trace. Each case runs
on both packages under one deterministic clock (`test_torch_tenancy.both`)
and holds every recorded value equal (tolerance 0), but for the pre-warm
compile counts: the port counts novel signatures (ROADMAP C.2), held by
`test_prewarm_counts_the_ports_novel_signatures`.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json

import pytest
import torch

import hypervisor_tpu_torch as PORT
from tests.test_torch_serving import Pkg, cut_phase_shares
from tests.test_torch_tenancy import both, same

ATTACHED = dict(max_agents=512, max_sessions=2048, max_vouch_edges=1024, max_sagas=256,
                delta_log_capacity=4096, event_log_capacity=1024, trace_log_capacity=1024)


def ap(P: Pkg):
    return P.mod("autopilot")


def snap(P: Pkg, seq: int, now: float, **kw):
    return ap(P).SignalSnapshot(seq=seq, now=now, **kw)


def stack(P: Pkg, **cfg_kw):
    """The reference test's serving stack: a warmed scheduler at bucket 4
    and a shallow lifecycle queue, with an autopilot attached."""
    state = P.state(**ATTACHED)
    front = P.serving.FrontDoor(state, P.serving.ServingConfig(buckets=(4,),
                                                               lifecycle_queue_depth=8))
    sched = P.serving.WaveScheduler(front)
    sched.warm(now=0.0)
    defaults = dict(decide_every_s=0.1, grow_shed_threshold=1, max_bucket_cap=8)
    defaults.update(cfg_kw)
    pilot = ap(P).Autopilot(state, sched, config=ap(P).AutopilotConfig(**defaults))
    return state, front, sched, pilot


def summary_without_prewarm(pilot) -> dict:
    """The plane's summary with the pre-warm compile counts set apart
    (ROADMAP C.2); the planned compiles each decision records likewise."""
    out = pilot.summary(last=16)
    out["prewarm"] = {"events": out["prewarm"]["events"]}
    for d in out["last"]:
        d["detail"] = {k: v for k, v in d["detail"].items() if not k.startswith("prewarm_")}
    return out


# ── 1. the snapshot digest ───────────────────────────────────────────


def test_signal_digests_match_reference():
    def drive(P):
        base = dict(shed=(("queue_full", 3),), buckets=(4, 8))
        variants = [
            {}, {"shed": (("queue_full", 4),)}, {"buckets": (4, 8, 16)}, {"wal_backlog": 100},
            {"integrity_violations": 2}, {"tenant_burn": ((0, "critical"),)},
            {"burn_states": (("lifecycle", "critical"),), "deadline_misses": 7},
            {"floor_distance": 5.91}, {"floor_distance": 5.94}, {"floor_distance": 6.3},
        ]
        return [snap(P, 0, 1.0, **{**base, **v}).digest() for v in variants]

    d = same(drive)
    assert len(set(d[:6])) == 6 and d[6] == d[0] and d[7] == d[8] != d[9]


def test_drain_signals_reads_the_same_planes():
    def drive(P):
        state, front, sched, pilot = stack(P)
        for i in range(front.config.lifecycle_queue_depth + 3):
            front.submit_lifecycle(f"s:{i}", f"did:s:{i}", 0.8, now=1.0)
        s = ap(P).drain_signals(seq=3, now=1.25, front=front, integrity=state.integrity,
                                journal=state.journal)
        return {"fields": dataclasses.asdict(s), "digest": s.digest()}

    same(drive)


# ── 2. the rule engine and the ledger ────────────────────────────────


def synthetic_stream(P: Pkg, n: int = 60) -> list:
    """The reference test's synthetic stream: sheds rise then quiet,
    violations spike then clean, one tenant burns then recovers, the WAL
    backlog climbs past its budget."""
    out, shed, viol, buckets = [], 0, 0, (4, 8)
    for i in range(n):
        if 5 <= i < 8:
            shed += 4
        if i == 8:
            buckets = (4, 8, 16)
        if i == 20:
            viol += 3
        burn = "critical" if 10 <= i < 14 else "ok"
        out.append(snap(
            P, i, round(0.1 * i, 6), queue_depths=(("lifecycle", 2 if i < 30 else 0),),
            shed=(("queue_full", shed),), buckets=buckets,
            tenant_burn=((0, burn), (1, "ok")), tenant_quanta=((0, 2.0), (1, 2.0)),
            base_quantum=2, integrity_violations=viol, sanitize_every=8,
            wal_backlog=200 * i))
    return out


def test_rule_engine_stream_and_ledger_match_reference():
    def drive(P):
        cfg = ap(P).AutopilotConfig(decide_every_s=0.1, shrink_after_windows=10,
                                    relax_after_windows=4)
        engine, ledger = ap(P).RuleEngine(cfg), ap(P).DecisionLedger()
        proposals = []
        for s in synthetic_stream(P):
            for p in engine.step(s):
                proposals.append(dataclasses.asdict(p))
                ledger.record(now=s.now, rule=p.rule, knob=p.knob, before=p.before,
                              after=p.after, predicted=p.predicted, signal_digest=s.digest(),
                              detail=p.detail)
        first = ledger.decisions[0]
        ledger.attribute(first, ok=True, observed={"queue_full_shed_delta": 0})
        ledger.attribute(first, ok=False, observed={})
        return {"proposals": proposals, "summary": ledger.summary(last=64)}

    rec = same(drive)
    fired = {p["rule"] for p in rec["proposals"]}
    assert fired >= {"bucket.grow", "drr.quantum", "integrity.cadence", "checkpoint.wal"}
    assert rec["summary"]["outcomes"]["confirmed"] == 1


@pytest.mark.parametrize("case", ["grow_cap", "shrink", "base_never_shrinks", "quantum",
                                  "cadence", "headroom", "checkpoint"])
def test_rule_family_cases_match_reference(case):
    def drive(P):
        cfg = {"grow_cap": dict(grow_shed_threshold=1, max_bucket_cap=8),
               "shrink": dict(shrink_after_windows=3), "base_never_shrinks":
               dict(shrink_after_windows=1), "quantum": dict(burn_quantum_boost=2.0),
               "cadence": dict(relax_after_windows=2, sanitize_every_max=32),
               "headroom": dict(relax_after_windows=1, headroom_floor=8.0),
               "checkpoint": dict(wal_replay_budget_s=0.5, wal_cost_per_record_s=1e-3)}[case]
        e = ap(P).RuleEngine(ap(P).AutopilotConfig(**cfg))
        q = dict(buckets=(4,), base_quantum=2, tenant_quanta=((0, 2.0), (1, 2.0)))
        seqs = {
            "grow_cap": [dict(shed=(("queue_full", 0),), buckets=(4, 8)),
                         dict(shed=(("queue_full", 5),), buckets=(4, 8))],
            "shrink": [dict(buckets=(4, 8))] + [dict(buckets=(4, 8, 16),
                                                     queue_depths=(("lifecycle", 0),),
                                                     shed=(("queue_full", 0),))] * 3,
            "base_never_shrinks": [dict(buckets=(4, 8))] * 6,
            "quantum": [dict(tenant_burn=((0, b), (1, "ok")), **q)
                        for b in ("ok", "critical", "warning", "ok")],
            "cadence": [dict(buckets=(4,), sanitize_every=8, integrity_violations=v)
                        for v in (0, 2)] + [dict(buckets=(4,), sanitize_every=4,
                                                 integrity_violations=2)] * 2,
            "headroom": [dict(buckets=(4,), sanitize_every=8, integrity_violations=0,
                              floor_distance=f) for f in (20.0, 20.0, 3.0)],
            "checkpoint": [dict(buckets=(4,), wal_backlog=b) for b in (100, 400, 900)],
        }[case]
        return [[dataclasses.asdict(p) for p in e.step(snap(P, i, 0.1 * i, **kw))]
                for i, kw in enumerate(seqs)]

    rec = same(drive)
    assert rec[0] == []


# ── 3. the plane on a serving stack ──────────────────────────────────


def test_grow_prewarms_first_and_the_hot_path_meets_no_novel_signature():
    def drive(P):
        from importlib import import_module

        health = import_module(f"{P.pkg.__name__}.observability.health")
        state, front, sched, pilot = stack(P)
        base = health.compile_summary(last=0)
        log = [decisions_of(pilot.step(1.0))]
        for i in range(front.config.lifecycle_queue_depth + 3):
            front.submit_lifecycle(f"ap:{i}", f"did:ap:{i}", 0.8, now=1.05)
        log.append(dict(front.shed))
        log.append(decisions_of(pilot.step(1.2)))
        after = health.compile_summary(last=0)
        planned = (after["compiles"] - base["compiles"] == pilot.prewarm["compiles"],
                   after["recompiles"] - base["recompiles"] == pilot.prewarm["recompiles"])
        mark = health.compile_summary(last=0)
        sched.tick(now=1.2 + front.config.lifecycle_deadline_s + 0.01)
        sched.drain(now=2.0)
        post = health.compile_summary(last=0)
        hot = (post["compiles"] - mark["compiles"], post["recompiles"] - mark["recompiles"])
        log.append(decisions_of(pilot.step(1.4)))
        return {"log": log, "config": (list(front.config.buckets),
                                       front.config.lifecycle_queue_depth,
                                       front.config.join_queue_depth),
                "planned": planned, "hot": hot, "summary": summary_without_prewarm(pilot),
                "prom": [line for line in state.metrics_prometheus().splitlines()
                         if line.startswith("hv_autopilot_") and "prewarm" not in line]}

    rec = same(drive)
    assert rec["config"] == ([4, 8], 16, 8)
    assert rec["planned"] == (True, True) and rec["hot"] == (0, 0)
    assert rec["summary"]["outcomes"]["confirmed"] == 1
    assert "hv_autopilot_decisions_total 1" in rec["prom"]
    assert "hv_autopilot_max_bucket 8" in rec["prom"]


def decisions_of(ds) -> list:
    out = []
    for d in ds:
        row = d.to_dict()
        row["detail"] = {k: v for k, v in row["detail"].items() if not k.startswith("prewarm_")}
        out.append(row)
    return out


def test_prewarm_counts_the_ports_novel_signatures():
    """ROADMAP C.2: the port has no jit cache, so the grow rule's planned
    compiles are the novel signatures its pre-warm dispatches (the new
    bucket's waves not seen before in the process); the reference counts
    its XLA compiles. On each package the decision records exactly its own
    compile watch's delta across the pre-warm, and the plane's `prewarm`
    totals add them up."""

    def drive(P):
        from importlib import import_module

        health = import_module(f"{P.pkg.__name__}.observability.health")
        state, front, sched, pilot = stack(P)
        pilot.step(1.0)
        for i in range(front.config.lifecycle_queue_depth + 3):
            front.submit_lifecycle(f"pw:{i}", f"did:pw:{i}", 0.8, now=1.05)
        before = health.compile_summary(last=0)
        (d,) = pilot.step(1.2)
        after = health.compile_summary(last=0)
        return {"delta": (after["compiles"] - before["compiles"],
                          after["recompiles"] - before["recompiles"]),
                "detail": (d.detail["prewarm_compiles"], d.detail["prewarm_recompiles"]),
                "prewarm": dict(pilot.prewarm)}

    ref, port = both(drive)
    for rec in (ref, port):
        assert rec["detail"] == rec["delta"]
        assert rec["prewarm"] == {"events": 1, "compiles": rec["delta"][0],
                                  "recompiles": rec["delta"][1]}


def test_kill_switch_stops_control_without_rollback():
    def drive(P):
        state, front, sched, pilot = stack(P)
        pilot.step(1.0)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("HV_AUTOPILOT", "0")
            enabled = ap(P).autopilot_enabled()
            for i in range(front.config.lifecycle_queue_depth + 3):
                front.submit_lifecycle(f"k:{i}", f"did:k:{i}", 0.8, now=1.05)
            off = pilot.step(1.2)
            buckets = list(front.config.buckets)
            summary_enabled = pilot.summary()["enabled"]
        return {"enabled": enabled, "off": off, "buckets": buckets,
                "summary_enabled": summary_enabled, "rearmed": decisions_of(pilot.step(1.2))}

    rec = same(drive)
    assert rec["enabled"] is False and rec["off"] == [] and rec["buckets"] == [4]
    assert rec["rearmed"]


def test_summary_state_fallback_and_dropped_proposals():
    def drive(P):
        state, front, sched, pilot = stack(P)
        attached = summary_without_prewarm(pilot)
        bare = P.state(**ATTACHED).autopilot_summary()
        s = ap(P).drain_signals(seq=0, now=1.0, front=front)
        rules = P.mod("autopilot.rules")
        dropped = [pilot._apply(rules.Proposal(rule=r, knob="k", before="2.0", after="4.0",
                                               predicted="p", detail={"tenant": 0}), s, 1.0)
                   for r in (rules.RULE_DRR_QUANTUM, rules.RULE_CHECKPOINT_WAL)]
        return {"attached": attached, "bare": bare, "dropped": dropped}

    rec = same(drive)
    assert rec["attached"]["enabled"] and rec["attached"]["knobs"]["static"]["buckets"] == [4]
    assert rec["bare"] == {"enabled": False} and rec["dropped"] == [None, None]


def test_drr_quantum_rule_retunes_the_tenant_scheduler():
    def drive(P):
        from tests.test_torch_tenancy import arena_of

        arena = arena_of(P, 2)
        tenancy = P.mod("tenancy")
        tfront = tenancy.TenantFrontDoor(arena, P.serving.ServingConfig(buckets=(4,)))
        tsched = tenancy.TenantWaveScheduler(tfront)
        pilot = ap(P).Autopilot(arena.tenants[0], None, tenant_scheduler=tsched)
        s = ap(P).drain_signals(seq=0, now=1.0, tenant_sched=tsched)
        rules = P.mod("autopilot.rules")
        d = pilot._apply(rules.Proposal(rule=rules.RULE_DRR_QUANTUM, knob="quantum[1]",
                                        before="4.0", after="8.0", predicted="recovers",
                                        detail={"tenant": 1, "burn_state": "critical"}), s, 1.0)
        return {"signals": dataclasses.asdict(s), "decision": d.to_dict(),
                "quanta": dict(tsched.quanta), "knobs": pilot.summary()["knobs"]}

    rec = same(drive)
    assert rec["quanta"] == {1: 8.0}


# ── 4. the integrity knob, the bundles and the API ───────────────────


def test_integrity_retune_matches_reference():
    def drive(P):
        state = P.state(**ATTACHED)
        plane = P.mod("integrity").IntegrityPlane(state, every=8, scrub_every=0)
        return [plane.retune(every=4), plane.retune(scrub_every=16), plane.retune(every=-3),
                (plane.every, plane.scrub_every)]

    rec = same(drive)
    assert rec[0]["before"]["every"] == 8 and rec[0]["after"]["every"] == 4
    assert rec[-1] == (0, 16)


def test_incident_bundle_carries_the_ledger_block():
    def drive(P):
        state, front, sched, pilot = stack(P)
        pilot.step(1.0)
        for i in range(front.config.lifecycle_queue_depth + 3):
            front.submit_lifecycle(f"b:{i}", f"did:b:{i}", 0.8, now=1.05)
        pilot.step(1.2)
        iid = state.incidents.observe("integrity_violation", {"total": 1, "unrepairable": 0})
        ledger = state.incident_bundle(iid)["context"]["ledger"]
        ledger["prewarm"] = {"events": ledger["prewarm"]["events"]}
        for d in ledger["last"]:
            d["detail"] = {k: v for k, v in d["detail"].items() if not k.startswith("prewarm_")}
        return {"id": iid, "ledger": ledger}

    rec = same(drive)
    assert rec["ledger"]["enabled"] and rec["ledger"]["decisions"] == 1


def test_debug_autopilot_serves_the_plane_over_both_transports():
    def drive(P):
        api = P.mod("api")
        hv = P.mod("core").Hypervisor() if P.is_ref else P.mod("core").Hypervisor(device="cpu")
        svc = api.HypervisorService(hypervisor=hv)
        bare = asyncio.run(svc.debug_autopilot())
        state = svc.hv.state
        front = P.serving.FrontDoor(state, P.serving.ServingConfig(buckets=(4,)))
        ap(P).Autopilot(state, P.serving.WaveScheduler(front))
        out = asyncio.run(svc.debug_autopilot())
        json.dumps(out)
        return {"bare": bare, "attached": out}

    rec = same(drive)
    assert rec["bare"] == {"enabled": False}
    assert rec["attached"]["enabled"] is True and rec["attached"]["decisions"] == 0


# ── 5. the soak ──────────────────────────────────────────────────────


def test_shifting_mix_soak_with_the_autopilot_matches_reference():
    """`run_soak(autopilot=True)` over the head of the reference's quick
    shifting trace (the calm phase and the burst's first 0.1 s): the
    report and its `autopilot` block equal the reference's, the pre-warm
    counts and the raw compile counts aside (C.2), and the wave-phase
    shares held to their phases (`cut_phase_shares`: the port's are
    measured)."""

    def drive(P):
        soak = P.mod("autopilot.soak")
        trace, _ = soak.shifting_trace(17, quick=True)
        trace = [e for e in trace if e["t"] < 0.5]
        report = P.serving.run_soak(
            spec=P.serving.WorkloadSpec(seed=17), trace=trace, state=P.state(**ATTACHED),
            serving_config=soak.static_config(quick=True), tick_s=0.02, slo_p99_ms=1500.0,
            autopilot=True)
        for key in ("warm_s", "wall_s", "compiles_after_warmup_raw",
                    "recompiles_after_warmup_raw"):
            report.pop(key, None)
        attribution = report["latency_attribution"]
        attribution["phase_shares"] = cut_phase_shares(attribution["phase_shares"])
        pilot = report["autopilot"]
        pilot["prewarm"] = {"events": pilot["prewarm"]["events"]}
        for d in pilot["last"]:
            d["detail"] = {k: v for k, v in d["detail"].items() if not k.startswith("prewarm_")}
        return report

    rec = same(drive)
    assert rec["autopilot"]["decisions"] >= 1 and rec["shed"]["queue_full"] > 0
    assert rec["compiles_after_warmup"] == 0 and rec["recompiles_after_warmup"] == 0


def test_autopilot_soak_defaults_to_cuda():
    from hypervisor_tpu_torch.autopilot.soak import run_autopilot_soak

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the soak would run, not refuse")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_autopilot_soak(replays=1, include_static=False, quick=True)
