"""The port's tenant front door and fair-share scheduler against the
reference's, on the CPU.

Counterparts of `tests/unit/test_tenancy.py`'s serving cases on
`hypervisor_tpu_torch.tenancy.{TenantFrontDoor, TenantWaveScheduler}`
over `TenantArena(device="cpu")`: the flooding tenant (it sheds against
its own queue alone, its neighbours keep full goodput, nothing is a novel
signature after the warm-up, and each neighbour's chain heads equal a
solo oracle's), the DRR deficit reset, the per-tenant quantum knob, the
tenants panel ranked by pressure, a tick-and-drain sequence, and
`GET /debug/tenants`. Each case runs one seeded sequence on both packages
under one deterministic clock (`test_torch_tenancy.both`) and holds every
recorded value equal (tolerance 0); the compile counts are each
package's own (ROADMAP C.2) and are held to zero separately.
"""

from __future__ import annotations

import asyncio
import http.client
import json

import numpy as np
import pytest

import hypervisor_tpu_torch as PORT
from tests.test_torch_serving import Pkg, ticket_record
from tests.test_torch_tenancy import arena_of, both, config, same, scfg

CFG_KW = dict(buckets=(4, 8), lifecycle_deadline_s=0.05, lifecycle_queue_depth=16)


def tenant_front(P: Pkg, tenants: int = 4, **kw):
    arena = arena_of(P, tenants)
    tenancy = P.mod("tenancy")
    front = tenancy.TenantFrontDoor(arena, P.serving.ServingConfig(**{**CFG_KW, **kw}))
    return arena, front, tenancy.TenantWaveScheduler(front)


def heads_by_session(st) -> dict:
    """Chain heads keyed by session id (slots differ across layouts)."""
    sid = st.sessions.sid
    sid = np.asarray(sid.cpu() if hasattr(sid, "cpu") else sid)
    return {st.session_ids.string(int(sid[slot])): np.asarray(head, np.uint32)
            for slot, head in st._chain_seed.items()}


def flood(P: Pkg) -> dict:
    from importlib import import_module

    health = import_module(f"{P.pkg.__name__}.observability.health")
    arena, front, sched = tenant_front(P)
    sched.warm(now=0.0)
    base = health.compile_summary(last=0)
    log, created = [], []
    batch, create = arena.governance_wave_batch, arena.create_sessions_batch

    def logged_create(ids_per_tenant, config_, pad_to=None):
        created.append({t: list(v) for t, v in ids_per_tenant.items()})
        return create(ids_per_tenant, config_, pad_to)

    def logged(lanes, bucket, now, omega=0.5):
        log.append((created[-1], lanes, bucket, now))
        return batch(lanes, bucket, now, omega)

    arena.governance_wave_batch, arena.create_sessions_batch = logged, logged_create
    now, shed = 10.0, {t: 0 for t in range(4)}
    refusals = []
    for r in range(5):
        for t in range(4):
            for i in range(40 if t == 3 else 2):
                res = front.submit_lifecycle(t, f"s:{t}:{r}:{i}", f"did:{t}:{r}:{i}", 0.8, now=now)
                if res.refused:
                    shed[t] += 1
                    refusals.append((t, res.to_dict()))
        sched.tick(now)
        now += 0.1
    for _ in range(20):
        if not any(len(d.lifecycles) for d in front.doors):
            break
        sched.lifecycle_round(now)
        now += 0.05
    after = health.compile_summary(last=0)
    return {
        "served": {t: front.doors[t].served["lifecycle"] for t in range(4)}, "shed": shed,
        "refusals": refusals[:8], "deficit": list(sched.deficit),
        "rounds": sched.lifecycle_rounds, "waves": arena.waves,
        "heads": [sorted((k, v.tobytes().hex()) for k, v in
                         heads_by_session(arena.tenants[t]).items() if k.startswith("s:"))
                  for t in range(4)],
        "novel_after_warm": (after["compiles"] - base["compiles"],
                             after["recompiles"] - base["recompiles"]),
        "log": log if not P.is_ref else None,
    }


def test_flooding_tenant_sheds_alone_neighbours_keep_full_goodput():
    ref, port = both(flood)
    log = port.pop("log")
    ref.pop("log")
    assert ref["novel_after_warm"] == (0, 0) and port["novel_after_warm"] == (0, 0)
    from tests.test_torch_facade_api import assert_same

    assert_same("flood", port, ref)
    assert [port["served"][t] for t in range(3)] == [10, 10, 10]
    assert [port["shed"][t] for t in range(3)] == [0, 0, 0] and port["shed"][3] > 0
    # Each neighbour's chain heads equal a solo state's replaying that
    # tenant's batched waves as solo waves at their bucket.
    P = Pkg(PORT)
    for t in range(3):
        solo = PORT.state.HypervisorState(config(P), device="cpu")
        want = {}
        for names, lanes, bucket, now in log:
            spec = lanes.get(t)
            if spec is None:
                continue
            slots = solo.create_sessions_batch(names[t], scfg(P))
            solo.run_governance_wave(slots, spec["dids"], slots.copy(), spec["sigma_raw"],
                                     spec["delta_bodies"], now=now,
                                     trustworthy=spec.get("trustworthy"), pad_to=(bucket, bucket))
        want = sorted((k, v.tobytes().hex()) for k, v in heads_by_session(solo).items())
        assert port["heads"][t] == want and len(want) == 10, t


def test_drr_deficit_resets_for_idle_tenants():
    def drive(P):
        _, front, sched = tenant_front(P, tenants=2)
        front.submit_lifecycle(0, "s:a", "did:a", 0.8, now=0.0)
        served = sched.lifecycle_round(0.0)
        return {"served": served, "deficit": list(sched.deficit)}

    rec = same(drive)
    assert rec["deficit"][1] == 0.0 and rec["served"] == 1


def test_quantum_knob_overrides_and_base_restores():
    def drive(P):
        _, front, sched = tenant_front(P, tenants=2, buckets=(4,))
        base = sched.quantum
        log = [sched.quantum_of(0)]
        sched.set_quantum(0, base * 2.0)
        log += [sched.quantum_of(0), sched.quantum_of(1), dict(sched.quanta)]
        for i in range(12):
            front.submit_lifecycle(0, f"q:{i}", f"did:q:{i}", 0.8, now=0.0)
            front.submit_lifecycle(1, f"r:{i}", f"did:r:{i}", 0.8, now=0.0)
        log.append(sched.lifecycle_round(0.0))
        log.append(list(sched.deficit))
        sched.set_quantum(0, base)
        log.append(dict(sched.quanta))
        return log

    rec = same(drive)
    assert rec[1] == 2 * rec[0] and rec[-1] == {}


def test_summary_ranks_by_pressure():
    def drive(P):
        _, front, _ = tenant_front(P)
        for i in range(30):
            front.submit_lifecycle(2, f"p:{i}", f"did:p:{i}", 0.8, now=0.0)
        return front.summary(top_k=2)

    rec = same(drive)
    assert rec["top_k"][0]["tenant"] == 2 and rec["top_k"][0]["queue_depth"] > 0


def test_tick_and_drain_match_reference():
    """Ragged lifecycles on three tenants across ticks, then a drain: every
    ticket, each door's summary and the arena's panel are the reference's."""

    def drive(P):
        arena, front, sched = tenant_front(P, tenants=3)
        rng = np.random.RandomState(4)
        tickets, reports = [], []
        now = 0.0
        for r in range(4):
            for t in range(3):
                for i in range(int(rng.randint(0, 6))):
                    tickets.append(front.submit_lifecycle(
                        t, f"d:{t}:{r}:{i}", f"did:d:{t}:{r}:{i}", float(rng.uniform(0.3, 0.9)),
                        now=now))
            reports.append(sched.tick(now))
            now += 0.03
        waves = sched.drain(now)
        return {"tickets": [ticket_record(tk) for tk in tickets], "reports": reports,
                "waves": waves, "arena": arena.summary(),
                "doors": [d.summary() for d in front.doors]}

    rec = same(drive)
    assert rec["arena"]["waves"] > 0


def test_debug_tenants_serves_the_arena_panel():
    def drive(P):
        api = P.mod("api")
        arena, front, sched = tenant_front(P, tenants=2, buckets=(4,))
        front.submit_lifecycle(1, "x:a", "did:x:a", 0.8, now=0.0)
        sched.lifecycle_round(0.0)
        hv = (P.mod("core").Hypervisor() if P.is_ref
              else P.mod("core").Hypervisor(device="cpu"))
        bare = asyncio.run(api.HypervisorService(hypervisor=hv).debug_tenants())
        svc = api.HypervisorService(hypervisor=hv)
        svc.tenancy = front
        panel = asyncio.run(svc.debug_tenants())
        via = api.HypervisorService(hypervisor=hv)
        via.hv.state = arena.tenants[1]
        through_tenant = asyncio.run(via.debug_tenants())
        return {"bare": bare, "panel": panel, "via": through_tenant}

    rec = same(drive)
    assert rec["bare"] == {"enabled": False}
    assert rec["panel"]["enabled"] and rec["panel"]["num_tenants"] == 2
    assert rec["via"]["via_tenant"] == 1
    # And over the port's stdlib transport, as JSON.
    P = Pkg(PORT)
    _, front, _ = tenant_front(P, tenants=2, buckets=(4,))
    svc = PORT.api.HypervisorService(hypervisor=PORT.Hypervisor(device="cpu"))
    svc.tenancy = front
    server = PORT.api.HypervisorHTTPServer(service=svc, port=0).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
        conn.request("GET", "/debug/tenants")
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
    finally:
        server.stop()
    assert resp.status == 200 and body["enabled"] and body["num_tenants"] == 2


@pytest.mark.parametrize("tenant", [0, 2])
def test_tenant_door_submits_route_to_their_own_door(tenant):
    def drive(P):
        _, front, _ = tenant_front(P, tenants=3, buckets=(4,))
        tk = front.submit_lifecycle(tenant, "o:a", "did:o:a", 0.8, now=0.0)
        return {"depths": front.queue_depths(), "ticket": ticket_record(tk)}

    rec = same(drive)
    assert rec["depths"][tenant]["lifecycle"] == 1
    assert sum(d["lifecycle"] for d in rec["depths"].values()) == 1
