"""The five adversary classes: seeded drivers against a LIVE state.

Every function here has the same shape::

    report = sybil_flood(seed, hardened=True, quick=True, device="cuda")

builds a fresh deployment on `device` (the card unless the caller asks
for the CPU), drives one seeded attack against it, and
returns a `ContainmentReport` whose components answer the containment
questions for that adversary class (module docstring of
`adversarial.scoring`). `hardened` toggles the defense mechanism the
scenario exists to prove (admission damper, collusion detector,
cascade dedupe, compensation backpressure) so the before/after
containment delta is measurable; `quick` shrinks batch sizes for CI.

Determinism contract: all randomness flows from `random.Random(seed)`,
all device time is synthetic (explicit `now=`), and trace events carry
only symbolic labels — never uuids or wall-clock — so one (seed,
hardened) pair produces ONE trace digest, forever. The property tests
pin this, and a scenario's result is the same on the card and on the
CPU.
"""

from __future__ import annotations

import asyncio
import random
from types import SimpleNamespace

from hypervisor_tpu_torch.adversarial.scoring import ContainmentReport, fraction
from hypervisor_tpu_torch.core import _host

_OMEGA = 0.5  # risk weight for host sigma_eff queries in the scenarios


def _sanitize_total(state) -> int:
    """Run one synchronous invariant sweep over a scenario's final
    tables (σ ranges, escrow conservation, FSM codes, turn chains —
    `integrity.invariants`); returns total violating rows."""
    from hypervisor_tpu_torch.integrity import IntegrityPlane

    plane = getattr(state, "integrity", None)
    if plane is None:
        plane = IntegrityPlane(state, every=0, scrub_every=0)
    return int(plane.sanitize()["total"])


# ── 1. sybil flood ───────────────────────────────────────────────────


def sybil_flood(
    seed: int, *, hardened: bool = True, quick: bool = True,
    device="cuda",
) -> ContainmentReport:
    """Mass low-sigma joins at open-workload rates.

    The admission wave sandboxes low-sigma agents (ring 3) rather than
    refusing them — the paper's design — so a flood of cheap identities
    ADMITS, each one burning a staging slot, an agent-table row, a rate
    bucket, and a seat against `max_participants` until honest joins
    refuse on capacity. The admission-rate damper
    (`resilience.policy.AdmissionDamper`, `hardened=True`) trips a
    targeted shed that refuses the flood at the gate, pre-queue, while
    honest joins keep flowing.
    """
    from hypervisor_tpu_torch.models import SessionConfig
    from hypervisor_tpu_torch.resilience.policy import (
        AdmissionDamper,
        DegradedModeRefusal,
    )
    from hypervisor_tpu_torch.state import HypervisorState

    rng = random.Random(seed)
    report = ContainmentReport("sybil_flood", seed, hardened)
    n_sybils = 96 if quick else 384
    capacity = 48 if quick else 192
    flush_every = 8
    dt = 0.01  # 100 join attempts/s — open-workload arrival rate

    st = HypervisorState(device=device)
    if hardened:
        st.admission_damper = AdmissionDamper(
            rate_threshold=10.0,
            low_sigma_fraction=0.5,
            sigma_floor=0.5,
            window_seconds=1.0,
        )
    slot = st.create_session(
        "scn:sybil",
        SessionConfig(min_sigma_eff=0.6, max_participants=capacity),
        now=0.0,
    )

    # One honest join rides along with every `flush_every` sybils.
    schedule: list[tuple[str, str, float]] = []
    h = 0
    for i in range(n_sybils):
        if i % flush_every == 0:
            schedule.append(("honest", f"did:honest:{h}", 0.85))
            h += 1
        schedule.append(
            ("sybil", f"did:sybil:{i}", round(0.05 + 0.1 * rng.random(), 3))
        )
    n_honest = h

    counts = {
        "sybil_queued": 0, "sybil_damped": 0,
        "honest_queued": 0, "honest_refused": 0, "pending": 0,
    }
    admitted = {"sybil": 0, "honest": 0}
    queued_kind: dict[str, str] = {}

    def flush(t: float) -> None:
        if not counts["pending"]:
            return
        status = st.flush_joins(now=t)
        counts["pending"] = 0
        report.record("flush", int(len(status)),
                      [int(s) for s in _host(status)])

    for i, (kind, did, sigma) in enumerate(schedule):
        t = i * dt
        try:
            q = st.enqueue_join(slot, did, sigma, now=t)
        except DegradedModeRefusal:
            counts["sybil_damped" if kind == "sybil" else "honest_refused"] += 1
            report.attack("join", kind, did, "damped")
            continue
        if q < 0:
            if kind == "honest":
                counts["honest_refused"] += 1
            report.attack("join", kind, did, "queue_full")
            continue
        counts[f"{kind}_queued"] += 1
        counts["pending"] += 1
        queued_kind[did] = kind
        report.attack("join", kind, did, "queued")
        if counts["pending"] >= flush_every:
            flush(t)
    flush(len(schedule) * dt)

    for did, kind in queued_kind.items():
        if st.is_member(slot, did):
            admitted[kind] += 1

    # Honest agents must ALL get their seats — the flood's goal is to
    # exhaust the session before they arrive.
    report.set("honest_admission",
               fraction(admitted["honest"], n_honest, empty=0.0))
    report.set("honest_flow",
               1.0 - fraction(counts["honest_refused"], n_honest, empty=0.0))
    # Capacity held: the fraction of the session NOT occupied by
    # sandboxed sybil identities.
    report.set("capacity_preserved",
               1.0 - fraction(admitted["sybil"], capacity, empty=0.0))
    # The damper's axis: how much of the flood was refused BEFORE it
    # could burn a staging slot + wave lane.
    report.set("flood_work_damped",
               fraction(counts["sybil_damped"], n_sybils, empty=0.0))
    report.set("invariants_clean", 1.0 if _sanitize_total(st) == 0 else 0.0)
    report.details = {
        **counts,
        "admitted": dict(admitted),
        "damper": (
            st.admission_damper.summary()
            if st.admission_damper is not None else None
        ),
    }
    return report


# ── 2. vouch-collusion ring ──────────────────────────────────────────


class _DriftStub:
    """Deterministic CMVK stand-in: the defection step always reads as
    critical behavioral drift (should_slash), so `verify_behavior`
    walks the full production slash path."""

    def check_behavioral_drift(self, **_kw):
        return SimpleNamespace(
            should_demote=False,
            should_slash=True,
            drift_score=0.91,
            severity=SimpleNamespace(value="critical"),
        )


def collusion_ring(
    seed: int, *, hardened: bool = True, quick: bool = True,
    device="cuda",
) -> ContainmentReport:
    """A clique pumps sigma_eff through mutual bonds, then defects.

    Escrow conservation (PR 5's per-voucher Σ bonds invariant) is the
    invariant under test; the collusion detector
    (`liability.collusion`, `hardened=True`) must neutralize the clique
    — read-only quarantine on both planes — BEFORE the defection, with
    zero honest false positives.
    """
    from hypervisor_tpu_torch.core import Hypervisor
    from hypervisor_tpu_torch.models import SessionConfig
    from hypervisor_tpu_torch.observability import HypervisorEventBus

    rng = random.Random(seed)
    report = ContainmentReport("collusion_ring", seed, hardened)
    n_honest, n_clique = 6, 4
    honest = [f"did:honest:{i}" for i in range(n_honest)]
    clique = [f"did:clique:{i}" for i in range(n_clique)]
    # Layered DAG — cycle rejection does not stop a pump ring.
    pump_edges = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    rng.shuffle(pump_edges)

    async def run() -> Hypervisor:
        hv = Hypervisor(event_bus=HypervisorEventBus(), cmvk=_DriftStub(),
                        device=device)
        managed = await hv.create_session(
            SessionConfig(min_sigma_eff=0.5, max_participants=32), "did:op"
        )
        sid = managed.sso.session_id
        for i, did in enumerate(honest):
            await hv.join_session(sid, did, sigma_raw=0.72 + 0.02 * i)
        # Honest sponsorship: reputable agents fan out to newcomers —
        # dense-ish but single-role, the shape the detector must NOT flag.
        hv.vouching.vouch(honest[0], honest[3], sid, voucher_sigma=0.72)
        hv.vouching.vouch(honest[0], honest[4], sid, voucher_sigma=0.72)
        hv.vouching.vouch(honest[1], honest[5], sid, voucher_sigma=0.74)
        for did in clique:
            await hv.join_session(sid, did, sigma_raw=0.55)
            report.attack("clique_join", did)
        for a, b in pump_edges:
            hv.vouching.vouch(
                clique[a], clique[b], sid, voucher_sigma=0.55
            )
            report.attack("pump_vouch", clique[a], clique[b])

        pumped = {
            did: hv.vouching.compute_sigma_eff(did, sid, 0.55, _OMEGA)
            for did in clique
        }
        report.record(
            "pumped_sigma",
            {d: round(v, 4) for d, v in sorted(pumped.items())},
        )

        findings = hv.detect_collusion(sid) if hardened else []
        report.record(
            "findings",
            [sorted(f.members) for f in findings],
        )

        sigma_before = {
            p.agent_did: p.sigma_eff for p in managed.sso.participants
        }
        # Defection: the most-pumped member goes rogue.
        defector = max(sorted(pumped), key=lambda d: pumped[d])
        report.attack("defect", defector)
        await hv.verify_behavior(sid, defector, [0.0], [1.0])

        sigma_after = {
            p.agent_did: p.sigma_eff for p in managed.sso.participants
        }
        damaged = sorted(
            d for d, v in sigma_after.items()
            if v < sigma_before[d] - 1e-6
        )
        report.record("damaged", damaged)

        quarantined = [
            did for did in clique
            if hv.quarantine.get_active_quarantine(did, sid) is not None
        ]
        honest_flagged = [
            did for did in honest
            if hv.quarantine.get_active_quarantine(did, sid) is not None
        ]
        exposure_ok = all(
            hv.vouching.get_total_exposure(did, sid)
            <= 0.80 * 1.0 + 1e-6
            for did in honest + clique
        )

        report.set(
            "pump_neutralized",
            fraction(
                len(quarantined) if hardened else 0, n_clique, empty=0.0
            ),
        )
        report.set(
            "detector_precision",
            1.0 - fraction(len(honest_flagged), n_honest, empty=0.0),
        )
        report.set(
            "honest_sigma_preserved",
            1.0 if all(d not in honest for d in damaged) else 0.0,
        )
        report.set("blast_confined",
                   1.0 if set(damaged) <= set(clique) else 0.0)
        report.set(
            "escrow_conservation",
            1.0 if exposure_ok and _sanitize_total(hv.state) == 0 else 0.0,
        )
        report.details = {
            "pumped_sigma_max": round(max(pumped.values()), 4),
            "quarantined": quarantined,
            "honest_flagged": honest_flagged,
            "damaged": damaged,
            "findings": [f.to_dict() for f in findings],
        }
        return hv

    asyncio.run(run())
    return report


# ── 3. slash cascade storm ───────────────────────────────────────────


def slash_cascade(
    seed: int, *, hardened: bool = True, quick: bool = True,
    device="cuda",
) -> ContainmentReport:
    """Deep chains + diamonds across the liability graph.

    Probes the cascade bound (agents beyond `max_cascade_depth` must
    keep their sigma), per-agent settlement uniqueness (a diamond used
    to clip the shared voucher once per path — double ledger charge),
    and settlement determinism (two edge-insertion orders of the SAME
    graph must settle in ONE canonical sequence). Host engines only —
    the scalar exception-faithful path the facade's device cascade
    mirrors — so `device` is accepted for signature uniformity and
    builds nothing.
    """
    from hypervisor_tpu_torch.liability.slashing import SlashingEngine
    from hypervisor_tpu_torch.liability.vouching import VouchingEngine

    rng = random.Random(seed)
    report = ContainmentReport("slash_cascade", seed, hardened)
    S = "scn:cascade"
    depth = 6

    # voucher -> vouchee edges: a chain c1->c0, c2->c1, ... plus a
    # diamond (m1,m2 -> c0 backed by the shared voucher w) and honest
    # bystanders off to the side.
    edges = [(f"did:c:{i + 1}", f"did:c:{i}") for i in range(depth)]
    edges += [("did:m:1", "did:c:0"), ("did:m:2", "did:c:0"),
              ("did:w:0", "did:m:1"), ("did:w:0", "did:m:2")]
    honest_edges = [("did:h:0", "did:h:1"), ("did:h:2", "did:h:3")]
    dids = sorted({d for e in edges for d in e}
                  | {d for e in honest_edges for d in e})

    def build_and_slash(order: list) -> tuple[list, dict]:
        vouching = VouchingEngine()
        slashing = SlashingEngine(vouching, dedupe_cascade=hardened)
        for voucher, vouchee in order:
            vouching.vouch(voucher, vouchee, S, voucher_sigma=0.8)
        scores = {d: 0.8 for d in dids}
        slashing.slash(
            "did:c:0", S, 0.8, 0.99, "scenario defection", scores
        )
        settlement = []
        for event in slashing.history:
            settlement.append(["slash", event.vouchee_did,
                               event.cascade_depth])
            settlement.extend(
                ["clip", c.voucher_did] for c in event.voucher_clips
            )
        return settlement, {
            "scores": scores,
            "dedupes": slashing.cascade_dedupes,
            "max_depth": max(
                (e.cascade_depth for e in slashing.history), default=0
            ),
        }

    order_a = edges + honest_edges
    rng.shuffle(order_a)
    order_b = list(reversed(order_a))
    for voucher, vouchee in order_a:
        report.attack("edge", voucher, vouchee)
    report.attack("slash", "did:c:0")

    settle_a, out_a = build_and_slash(order_a)
    settle_b, out_b = build_and_slash(order_b)
    report.record("settlement", settle_a)
    report.record("dedupes", out_a["dedupes"])

    scores = out_a["scores"]
    settled_dids = [e[1] for e in settle_a]
    # Duplicates count WITHIN each settlement kind: a clip that wipes
    # and then cascades into a slash is the design; the same agent
    # clipped (or slashed) twice in one root event is the breach.
    dup = sum(
        len(ds) - len(set(ds))
        for kind in ("slash", "clip")
        if (ds := [e[1] for e in settle_a if e[0] == kind])
    )
    beyond_horizon = [f"did:c:{i}" for i in range(4, depth + 1)]
    bystanders = ["did:h:0", "did:h:1", "did:h:2", "did:h:3"]

    report.set(
        "depth_bounded",
        1.0
        if out_a["max_depth"] <= SlashingEngine.MAX_CASCADE_DEPTH
        and all(scores[d] == 0.8 for d in beyond_horizon)
        else 0.0,
    )
    report.set(
        "single_settlement",
        1.0 - fraction(dup, len(settled_dids), empty=0.0),
    )
    report.set(
        "deterministic_settlement", 1.0 if settle_a == settle_b else 0.0
    )
    report.set(
        "honest_preserved",
        1.0 if all(scores[d] == 0.8 for d in bystanders) else 0.0,
    )
    report.details = {
        "max_depth": out_a["max_depth"],
        "duplicates": dup,
        "dedupes": out_a["dedupes"],
        "settled": settled_dids,
    }
    return report


# ── 4. saga compensation storm ───────────────────────────────────────


def compensation_storm(
    seed: int, *, hardened: bool = True, quick: bool = True,
    device="cuda",
) -> ContainmentReport:
    """Mass concurrent saga failures under bounded executor capacity.

    An attacker (or a correlated outage) fails a large cohort of sagas
    in one round, forcing reverse-order compensation for every one of
    them while honest sagas are mid-flight and new work keeps arriving.
    Unhardened, the naive executor splits its per-round capacity fairly
    between compensations and the open workload — the backlog outlives
    the drill. Hardened, the Supervisor's comp-backlog pressure flips
    degraded mode (new arrivals defer, fan-out pauses) and
    `saga_work(comp_budget)` drains a deterministic bounded batch per
    round, compensations first.
    """
    from hypervisor_tpu_torch.models import SessionConfig
    from hypervisor_tpu_torch.ops import saga_ops
    from hypervisor_tpu_torch.resilience.supervisor import Supervisor
    from hypervisor_tpu_torch.state import HypervisorState

    rng = random.Random(seed)
    report = ContainmentReport("compensation_storm", seed, hardened)
    n_honest = 6
    n_storm = 24 if quick else 96
    capacity = 6            # outcomes the executor can settle per round
    rounds = 14 if quick else 40
    arrivals_per_round = 2

    st = HypervisorState(device=device)
    sup = Supervisor(
        st,
        degrade_after_comp_backlog=(16 if hardened else 10 ** 9),
        degrade_after_failures=10 ** 9,
        degrade_after_stragglers=10 ** 9,
        degrade_after_capacity=10 ** 9,
        exit_after_clean=4,
        sleep=lambda s: None,
    )
    sess = st.create_session(
        "scn:storm", SessionConfig(min_sigma_eff=0.0), now=0.0
    )
    steps3 = [{"has_undo": True, "retries": 0, "timeout": 300.0}] * 3

    honest_slots = [
        st.create_saga(f"saga:honest:{i}", sess, steps3)
        for i in range(n_honest)
    ]
    storm_slots = [
        st.create_saga(f"saga:storm:{i}", sess, steps3)
        for i in range(n_storm)
    ]
    # Two committed steps per storm saga -> 2 reverse-order undos each.
    st.saga_round(exec_outcomes={s: True for s in storm_slots})
    st.saga_round(exec_outcomes={s: True for s in storm_slots})
    # Honest sagas are mid-flight: one committed step so far.
    st.saga_round(exec_outcomes={s: True for s in honest_slots})

    # The storm: every storm saga fails its third step in ONE round.
    report.attack("storm_fail", n_storm)
    st.saga_round(exec_outcomes={s: False for s in storm_slots})

    peak_backlog = 0
    deferred = 0
    arrived = 0
    for r in range(rounds):
        budget = capacity if hardened and sup.degraded else None
        execute, compensate = sup.dispatch(
            "saga_round_plan", st.saga_work, comp_budget=budget
        )
        peak_backlog = max(peak_backlog, len(compensate))
        if hardened and sup.degraded:
            # Degraded posture: compensations first, remaining capacity
            # settles in-flight forward steps; NEW arrivals defer.
            comp_batch = compensate[:capacity]
            exec_batch = execute[: capacity - len(comp_batch)]
            deferred += arrivals_per_round
        else:
            # Naive fair executor: alternate forward/compensation work
            # and keep accepting the open workload.
            merged: list[tuple[str, tuple[int, int]]] = []
            for i in range(max(len(execute), len(compensate))):
                if i < len(execute):
                    merged.append(("exec", execute[i]))
                if i < len(compensate):
                    merged.append(("comp", compensate[i]))
            batch = merged[:capacity]
            exec_batch = [w for kind, w in batch if kind == "exec"]
            comp_batch = [w for kind, w in batch if kind == "comp"]
            for _ in range(arrivals_per_round):
                st.create_saga(f"saga:new:{arrived}", sess, steps3)
                arrived += 1
        report.record(
            "round", r, len(execute), len(compensate),
            len(exec_batch), len(comp_batch), bool(sup.degraded),
        )
        if not exec_batch and not comp_batch:
            continue
        sup.dispatch(
            "saga_round", st.saga_round,
            exec_outcomes={s: True for s, _ in exec_batch},
            undo_outcomes={s: True for s, _ in comp_batch},
        )

    saga_state = _host(st.sagas.saga_state)
    storm_done = sum(
        1 for s in storm_slots
        if saga_state[s] == saga_ops.SAGA_COMPLETED
    )
    honest_done = sum(
        1 for s in honest_slots
        if saga_state[s] == saga_ops.SAGA_COMPLETED
    )
    _, remaining = st.saga_work()

    report.set("storm_drained",
               1.0 - fraction(len(remaining), n_storm, empty=0.0))
    report.set("compensations_complete",
               fraction(storm_done, n_storm, empty=0.0))
    report.set("honest_inflight_completed",
               fraction(honest_done, n_honest, empty=0.0))
    report.set("invariants_clean",
               1.0 if _sanitize_total(st) == 0 else 0.0)
    if hardened:
        report.set(
            "backpressure_engaged",
            1.0 if sup.comp_backpressure_entries >= 1 else 0.0,
        )
        report.set("degraded_exited", 0.0 if sup.degraded else 1.0)
    report.details = {
        "peak_backlog": peak_backlog,
        "storm_completed": storm_done,
        "honest_completed": honest_done,
        "remaining_compensations": len(remaining),
        "arrivals_accepted": arrived,
        "arrivals_deferred": deferred,
        "degraded_entries": sup.degraded_entries,
    }
    _ = rng  # arrival mix is fixed; rng reserved for future jitter
    return report


# ── 5. byzantine-client API fuzz ─────────────────────────────────────


def byzantine_fuzz(
    seed: int, *, hardened: bool = True, quick: bool = True,
    device="cuda",
) -> ContainmentReport:
    """Malformed / contradictory / replayed calls on the API surface.

    Runs the stdlib HTTP transport (raw malformed bodies, garbage
    query params, unknown routes) AND the service layer (contradictory
    lifecycle sequences, non-finite sigma, replayed requests).
    Containment: every byzantine call is a clean 4xx refusal — never a
    5xx, never a dropped connection, never a table mutation — and the
    honest session keeps serving afterwards with invariants intact.
    (`hardened` is accepted for signature uniformity; the transport
    and input-gate hardening this scenario proves is always-on.)
    """
    import http.client
    import json as _json

    from hypervisor_tpu_torch.api.server import HypervisorHTTPServer
    from hypervisor_tpu_torch.api.service import ApiError, HypervisorService
    from hypervisor_tpu_torch.core import Hypervisor
    from hypervisor_tpu_torch.observability import HypervisorEventBus

    rng = random.Random(seed)
    report = ContainmentReport("byzantine_fuzz", seed, hardened)
    n_ops = 40 if quick else 160

    bus = HypervisorEventBus()
    svc = HypervisorService(
        hypervisor=Hypervisor(event_bus=bus, device=device), event_bus=bus
    )
    run = asyncio.run

    from hypervisor_tpu_torch.api import models as M

    created = run(svc.create_session(M.CreateSessionRequest(
        creator_did="did:op", min_sigma_eff=0.5
    )))
    sid = created.session_id
    for i in range(3):
        run(svc.join_session(sid, M.JoinSessionRequest(
            agent_did=f"did:honest:{i}", sigma_raw=0.8
        )))
    run(svc.activate_session(sid))
    sigma_before = {
        p["agent_did"]: p["sigma_eff"]
        for p in run(svc.get_session(sid)).model_dump()["participants"]
    }

    server = HypervisorHTTPServer(svc).start()

    def http_op(method, path, body: bytes | None = None,
                headers: dict | None = None) -> int:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=10)
        try:
            hdrs = {"Content-Type": "application/json"}
            hdrs.update(headers or {})
            conn.request(method, path, body=body, headers=hdrs)
            resp = conn.getresponse()
            resp.read()
            return resp.status
        except (ConnectionError, http.client.HTTPException, OSError):
            return -1  # dropped connection = containment failure
        finally:
            conn.close()

    def svc_op(coro_fn, *args) -> int:
        try:
            run(coro_fn(*args))
            return 200
        except ApiError as e:
            return e.status
        except Exception:  # noqa: BLE001 — unhandled = containment failure
            return 599

    junk = ['{"creator_did": ', "<xml>no</xml>", "\x00\xff\xfe", "[1, 2",
            '{"a": NaN}', "", "}{"]
    catalog: list[tuple[str, object, set[int]]] = [
        ("malformed_json", lambda: http_op(
            "POST", "/api/v1/sessions",
            rng.choice(junk).encode("utf-8", "ignore")), {400, 422}),
        ("wrong_types", lambda: http_op(
            "POST", "/api/v1/sessions",
            _json.dumps({"creator_did": rng.randrange(9)}).encode()),
         {200, 201, 400, 422}),
        ("array_body", lambda: http_op(
            "POST", f"/api/v1/sessions/{sid}/join",
            b'[1, 2, 3]'), {400, 422}),
        ("unknown_route", lambda: http_op(
            "POST", f"/api/v1/{rng.choice(['x', 'admin', '..'])}", b"{}"),
         {404}),
        ("bad_query_int", lambda: http_op(
            "GET", "/api/v1/events?limit=" + rng.choice(
                ["abc", "1e9x", "--", "%00"])), {400}),
        # Pydantic tolerates (ignores) stray fields — the valid core
        # admits once, then replays refuse as duplicates; the stdlib
        # fallback models refuse outright.
        ("stray_fields", lambda: http_op(
            "POST", f"/api/v1/sessions/{sid}/join",
            _json.dumps({"agent_did": "did:x", "sigma_raw": 0.7,
                         "root": True}).encode()), {200, 400, 422}),
        ("nan_sigma", lambda: svc_op(
            svc.join_session, sid, M.JoinSessionRequest(
                agent_did=f"did:nan:{rng.randrange(4)}",
                sigma_raw=rng.choice(
                    [float("nan"), float("inf"), -2.0, 7.5]),
            )), {400, 422}),
        ("dup_join", lambda: svc_op(
            svc.join_session, sid, M.JoinSessionRequest(
                agent_did="did:honest:0", sigma_raw=0.8)), {400}),
        ("ghost_session", lambda: svc_op(
            svc.join_session, f"ghost-{rng.randrange(9)}",
            M.JoinSessionRequest(agent_did="did:x", sigma_raw=0.8)),
         {404}),
        ("ghost_terminate", lambda: svc_op(
            svc.terminate_session, f"ghost-{rng.randrange(9)}"), {404}),
        ("self_vouch", lambda: svc_op(
            svc.create_vouch, sid, M.CreateVouchRequest(
                voucher_did="did:honest:1", vouchee_did="did:honest:1",
                voucher_sigma=0.8)), {400, 422}),
        ("nan_vouch", lambda: svc_op(
            svc.create_vouch, sid, M.CreateVouchRequest(
                voucher_did="did:honest:1", vouchee_did="did:honest:2",
                voucher_sigma=0.8, bond_pct=float("nan"))), {400, 422}),
        ("ghost_kill", lambda: svc_op(
            svc.kill_agent, sid, M.KillAgentRequest(
                agent_did=f"did:ghost:{rng.randrange(9)}")),
         {404, 409}),
        ("ghost_leave", lambda: svc_op(
            svc.leave_session, sid, M.LeaveSessionRequest(
                agent_did=f"did:ghost:{rng.randrange(9)}")),
         {404, 409}),
        ("replay_activate", lambda: svc_op(
            svc.activate_session, sid), {400}),
        ("ghost_saga_step", lambda: svc_op(
            svc.execute_saga_step, f"saga-{rng.randrange(9)}", "s0"),
         {404}),
    ]

    failures_5xx = 0
    unexpected = 0
    for i in range(n_ops):
        label, op, expected = catalog[rng.randrange(len(catalog))]
        status = op()
        report.attack("op", i, label, status)
        if status >= 500 or status < 0:
            failures_5xx += 1
        elif status not in expected:
            unexpected += 1

    # Honest traffic must still be served, bit-for-bit governed.
    post_status = svc_op(svc.join_session, sid, M.JoinSessionRequest(
        agent_did="did:honest:99", sigma_raw=0.8))
    honest_ok = post_status == 200
    sigma_after = {
        p["agent_did"]: p["sigma_eff"]
        for p in run(svc.get_session(sid)).model_dump()["participants"]
    }
    sigma_stable = all(
        abs(sigma_after.get(d, -1.0) - v) < 1e-9
        for d, v in sigma_before.items()
    )
    server.stop()

    report.set("no_server_errors",
               1.0 - fraction(failures_5xx, n_ops, empty=0.0))
    report.set("refusals_well_formed",
               1.0 - fraction(unexpected, n_ops, empty=0.0))
    report.set("honest_still_served", 1.0 if honest_ok else 0.0)
    report.set("honest_sigma_preserved", 1.0 if sigma_stable else 0.0)
    report.set("invariants_clean",
               1.0 if _sanitize_total(svc.hv.state) == 0 else 0.0)
    report.details = {
        "ops": n_ops,
        "server_errors": failures_5xx,
        "unexpected_statuses": unexpected,
        "post_attack_join_status": post_status,
    }
    return report


from hypervisor_tpu_torch.adversarial.noisy_neighbor import (  # noqa: E402
    noisy_neighbor,
)

ADVERSARIES = {
    "sybil_flood": sybil_flood,
    "collusion_ring": collusion_ring,
    "slash_cascade": slash_cascade,
    "compensation_storm": compensation_storm,
    "byzantine_fuzz": byzantine_fuzz,
    # Round 16 (tenant-dense serving): one byzantine tenant at full
    # rate — containment scored on its NEIGHBORS (goodput, zero
    # cross-tenant sheds, chain heads bit-identical to a solo oracle).
    "noisy_neighbor": noisy_neighbor,
}

__all__ = [
    "ADVERSARIES",
    "byzantine_fuzz",
    "collusion_ring",
    "compensation_storm",
    "noisy_neighbor",
    "slash_cascade",
    "sybil_flood",
]
