"""The port's API (`hypervisor_tpu_torch.api`) against the reference's.

`api/models.py` and `api/server.py` are copies of the reference's modules
(held as text by `test_torch_host_engines`); `api/service.py` differs
where it meets the device (`device_stats.backend` is the state's torch
device type, `/debug/profile` opens a `torch.profiler` window).

One call sequence (`SEQUENCE`, the reference's `tests/unit/test_api.py`
calls: sessions, joins, rings, actions, sagas, vouches, events,
quarantine, the serving front door's join wave and stream, leave, kill,
sweeps, terminate and the debug panels) runs through each package's
`HypervisorService` over a small-table facade (the port's on the CPU),
then through the stdlib `http.server` transport on a localhost port.
Every response must be equal (status and body) under the deterministic
ids and clocks of `test_torch_serving.both`; where a body holds wall
times (the metrics exposition's stage histograms, the health and
compile panels, the flight recorder) only its wall-free part is held.
The same sequence runs once more with pydantic taken away, so the
models' stand-in `BaseModel` (what the card, which has no pydantic,
runs) must give pydantic's `model_dump()`.
"""

from __future__ import annotations

import asyncio
import http.client
import importlib
import json
import re
import sys

import pytest

import hypervisor_tpu as REF
import hypervisor_tpu_torch as PORT
from hypervisor_tpu_torch.testing import same_health_on_every_run
from tests.test_torch_metrics import prom_masked
from tests.test_torch_serving import Pkg, both

WRITE = {"action_id": "w1", "name": "write", "execute_api": "/x", "undo_api": "/u",
         "reversibility": "full"}

#: (label, method, path, body); `{s0}`, `{s1}`, `{g0}`, `{st0}` take the
#: ids earlier responses returned.
SEQUENCE = [
    ("health", "GET", "/health", None),
    ("create0", "POST", "/api/v1/sessions",
     {"creator_did": "did:admin", "max_participants": 8, "min_sigma_eff": 0.0}),
    ("create1", "POST", "/api/v1/sessions", {"creator_did": "did:lead", "min_sigma_eff": 0.0}),
    ("create_bad", "POST", "/api/v1/sessions", {"max_participants": 3}),
    ("list", "GET", "/api/v1/sessions", None),
    ("list_archived", "GET", "/api/v1/sessions?state=archived", None),
    ("get0", "GET", "/api/v1/sessions/{s0}", None),
    ("join_a", "POST", "/api/v1/sessions/{s0}/join", {"agent_did": "did:a", "sigma_raw": 0.8}),
    ("join_b", "POST", "/api/v1/sessions/{s0}/join", {"agent_did": "did:b", "sigma_raw": 0.95}),
    ("join_lo", "POST", "/api/v1/sessions/{s0}/join", {"agent_did": "did:lo", "sigma_raw": 0.1}),
    ("join_dup", "POST", "/api/v1/sessions/{s0}/join", {"agent_did": "did:a", "sigma_raw": 0.8}),
    ("join_ghost", "POST", "/api/v1/sessions/session:ghost/join",
     {"agent_did": "did:x", "sigma_raw": 0.8}),
    ("activate", "POST", "/api/v1/sessions/{s0}/activate", None),
    ("rings", "GET", "/api/v1/sessions/{s0}/rings", None),
    ("agent_ring", "GET", "/api/v1/agents/did:a/ring", None),
    ("agent_ring_ghost", "GET", "/api/v1/agents/did:ghost/ring", None),
    ("memberships", "GET", "/api/v1/agents/did:a/memberships", None),
    ("ring_check", "POST", "/api/v1/rings/check",
     {"agent_ring": 3, "action": dict(WRITE), "sigma_eff": 0.8}),
    ("action_check", "POST", "/api/v1/sessions/{s0}/actions/check",
     {"agent_did": "did:a", "action": dict(WRITE)}),
    ("action_bad", "POST", "/api/v1/sessions/{s0}/actions/check",
     {"agent_did": "did:a", "action": {"bogus": 1}}),
    ("saga", "POST", "/api/v1/sessions/{s0}/sagas", None),
    ("saga_step", "POST", "/api/v1/sagas/{g0}/steps",
     {"action_id": "a", "agent_did": "did:a", "execute_api": "/x"}),
    ("saga_exec", "POST", "/api/v1/sagas/{g0}/steps/{st0}/execute", None),
    ("saga_get", "GET", "/api/v1/sagas/{g0}", None),
    ("sagas", "GET", "/api/v1/sessions/{s0}/sagas", None),
    ("saga_ghost", "GET", "/api/v1/sagas/saga:ghost", None),
    ("vouch", "POST", "/api/v1/sessions/{s0}/vouch",
     {"voucher_did": "did:b", "vouchee_did": "did:a", "voucher_sigma": 0.9}),
    ("vouch_bad", "POST", "/api/v1/sessions/{s0}/vouch",
     {"voucher_did": "did:a", "vouchee_did": "did:a", "voucher_sigma": 0.9}),
    ("vouches", "GET", "/api/v1/sessions/{s0}/vouches", None),
    ("liability", "GET", "/api/v1/agents/did:b/liability", None),
    ("events", "GET", "/api/v1/events?limit=6", None),
    ("events_created", "GET", "/api/v1/events?event_type=session.created", None),
    ("events_bad", "GET", "/api/v1/events?event_type=bogus.type", None),
    ("event_stats", "GET", "/api/v1/events/stats", None),
    ("stats", "GET", "/api/v1/stats", None),
    ("device_stats", "GET", "/api/v1/device/stats", None),
    ("quarantine", "GET", "/api/v1/agents/did:a/quarantine", None),
    ("quarantines", "GET", "/api/v1/security/quarantines", None),
    ("serving_bare", "GET", "/debug/serving", None),
    ("join_wave", "POST", "/api/v1/sessions/{s1}/join-wave",
     {"joins": [{"agent_did": f"did:w{i}", "sigma_raw": 0.8} for i in range(3)]}),
    ("join_wave_empty", "POST", "/api/v1/sessions/{s1}/join-wave", {"joins": []}),
    ("join_wave_nan", "POST", "/api/v1/sessions/{s1}/join-wave",
     {"joins": [{"agent_did": "did:nan", "sigma_raw": 2.0}]}),
    ("serving", "GET", "/debug/serving", None),
    ("slo", "GET", "/debug/slo", None),
    ("stream", "GET", "/api/v1/serving/stream?frames=2", None),
    ("leave", "POST", "/api/v1/sessions/{s1}/leave", {"agent_did": "did:w0"}),
    ("leave_again", "POST", "/api/v1/sessions/{s1}/leave", {"agent_did": "did:w0"}),
    ("kill", "POST", "/api/v1/sessions/{s0}/kill", {"agent_did": "did:lo", "reason": "ring_breach"}),
    ("kill_bad", "POST", "/api/v1/sessions/{s0}/kill", {"agent_did": "did:b", "reason": "bogus"}),
    ("sweep", "POST", "/api/v1/security/sweep", None),
    ("integrity", "GET", "/debug/integrity", None),
    ("resilience", "GET", "/debug/resilience", None),
    ("tenants", "GET", "/debug/tenants", None),
    ("roofline", "GET", "/debug/roofline", None),
    ("incidents", "GET", "/debug/incidents", None),
    ("memory", "GET", "/debug/memory", None),
    ("metrics", "GET", "/metrics", None),
    ("debug_health", "GET", "/debug/health", None),
    ("compiles", "GET", "/debug/compiles", None),
    ("flight", "GET", "/debug/flight", None),
    ("trace", "GET", "/trace/{s0}", None),
    ("terminate", "POST", "/api/v1/sessions/{s0}/terminate", None),
    ("get0_after", "GET", "/api/v1/sessions/{s0}", None),
    ("nope", "GET", "/no/such/route", None),
]

#: Responses whose bodies hold wall times: only their wall-free part.
WALL_BODIES = {"debug_health", "compiles", "flight", "trace", "memory"}


def ids_from(label: str, body, ids: dict) -> None:
    if not isinstance(body, dict):
        return
    if label == "create0":
        ids["s0"] = body.get("session_id")
    elif label == "create1":
        ids["s1"] = body.get("session_id")
    elif label == "saga":
        ids["g0"] = body.get("saga_id")
    elif label == "saga_step":
        ids["st0"] = body.get("step_id")


def shaped(label: str, status: int, body):
    """The comparable form of one response."""
    if label == "metrics":
        return status, prom_masked(body)
    if label in WALL_BODIES and isinstance(body, dict):
        return status, sorted(body)
    return status, body


def via_service(P: Pkg, svc) -> list:
    """`SEQUENCE` through the service, routed and coerced as the stdlib
    transport does (its router, query coercion and JSON rendering)."""
    srv = P.mod("api.server")
    router = srv._Router()
    ids: dict = {}
    out = []
    for label, method, path, body in SEQUENCE:
        path = path.format(**ids)
        raw, _, query = path.partition("?")
        hit = router.match(method, raw)
        if hit is None:
            out.append((label, 404, {"detail": "Not found"}))
            continue
        name, kwargs, model = hit
        try:
            if model is not None:
                kwargs["req"] = model(**(body or {}))
            for pair in filter(None, query.split("&")):
                k, _, v = pair.partition("=")
                kwargs[k] = srv._coerce_query(k, v)
            result = asyncio.run(getattr(svc, name)(**kwargs))
        except srv.ApiError as e:
            out.append((label, *shaped(label, e.status, {"detail": e.detail})))
            continue
        except Exception as e:  # noqa: BLE001 — request validation, as the transport
            if "req" not in kwargs and model is not None:
                out.append((label, 422, {"detail": "invalid request"}))
                continue
            raise
        status = 201 if (method, name) in srv._CREATED else 200
        if isinstance(result, srv.PrometheusText):
            body_out = str(result)
        elif isinstance(result, srv.NdjsonStream):
            body_out = [json.loads(json.dumps(frame)) for frame in result.frames]
        else:
            body_out = json.loads(json.dumps(srv._to_jsonable(result)))
        ids_from(label, body_out, ids)
        out.append((label, *shaped(label, status, body_out)))
    return out


def via_http(P: Pkg, svc) -> list:
    """`SEQUENCE` over the stdlib transport on a localhost port."""
    server = P.mod("api.server").HypervisorHTTPServer(service=svc, port=0).start()
    ids: dict = {}
    out = []
    try:
        for label, method, path, body in SEQUENCE:
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
            data = json.dumps(body).encode() if body is not None else None
            conn.request(method, path.format(**ids), body=data,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            text = resp.read().decode()
            conn.close()
            ctype = resp.getheader("Content-Type", "")
            if ctype.startswith("application/json"):
                body_out = json.loads(text)
            elif ctype.startswith("application/x-ndjson"):
                body_out = [json.loads(line) for line in text.splitlines() if line]
            else:
                body_out = text
            if resp.status == 422 and label in ("create_bad",):
                body_out = {"detail": "invalid request"}
            ids_from(label, body_out, ids)
            out.append((label, *shaped(label, resp.status, body_out)))
    finally:
        server.stop()
    return out


def service_for(P: Pkg):
    """A service over a small-table facade whose bus bridges the health
    plane with the `recompile` kind kept off (the packages count compiles
    differently, ROADMAP C.2), as the facade parity runs do."""
    hv = P.pkg.Hypervisor(state=P.state(max_agents=64, max_sessions=32, max_vouch_edges=32,
                                        max_sagas=8, delta_log_capacity=256,
                                        event_log_capacity=64, trace_log_capacity=128),
                          event_bus=P.mod("observability").HypervisorEventBus())
    same_health_on_every_run(hv)
    return P.mod("api").HypervisorService(hypervisor=hv, event_bus=hv.event_bus)


def compare(ref: list, port: list) -> dict:
    assert [r[0] for r in port] == [r[0] for r in ref]
    for (label, ws, wb), (_, gs, gb) in zip(ref, port):
        assert (gs, gb) == (ws, wb), label
    return {label: (status, body) for label, status, body in port}


@pytest.fixture(scope="module")
def service_runs():
    return both(lambda P: via_service(P, service_for(P)))


def test_service_sequence_matches_reference(service_runs):
    rec = compare(*service_runs)
    assert rec["create0"][0] == 201 and rec["join_a"][1]["assigned_ring"] == 2
    assert rec["join_dup"][0] == 400 and rec["join_ghost"][0] == 404
    assert rec["join_wave"][1]["wave"]["lanes"] == 3
    assert [lane["admitted"] for lane in rec["join_wave"][1]["lanes"]] == [True] * 3
    assert rec["join_wave_empty"][0] == rec["join_wave_nan"][0] == 422
    assert rec["serving_bare"][1] == {"enabled": False} and rec["serving"][1]["enabled"]
    assert rec["slo"][1]["enabled"] and rec["roofline"][1] == {"enabled": False}
    assert rec["device_stats"][1]["backend"] == "cpu"
    assert rec["terminate"][1]["state"] == "archived" and rec["nope"][0] == 404
    assert len(rec["stream"][1]) == 2


def test_stdlib_transport_matches_reference_and_the_service(service_runs):
    ref, port = both(lambda P: via_http(P, service_for(P)))
    rec = compare(ref, port)
    by_label = {label: (s, b) for label, s, b in service_runs[1]}
    for label, (status, body) in rec.items():
        if label in ("create_bad",):
            continue
        assert (status, body) == by_label[label], label


def without_pydantic(monkeypatch):
    """Reload the port's API modules with pydantic unimportable."""
    monkeypatch.setitem(sys.modules, "pydantic", None)
    for name in ("hypervisor_tpu_torch.api.models", "hypervisor_tpu_torch.api.service",
                 "hypervisor_tpu_torch.api.server", "hypervisor_tpu_torch.api"):
        importlib.reload(sys.modules[name])


def test_pydantic_fallback_gives_the_same_responses(service_runs, monkeypatch):
    try:
        without_pydantic(monkeypatch)
        models = importlib.import_module("hypervisor_tpu_torch.api.models")
        assert models._HAVE_PYDANTIC is False
        _, port_bare = both(lambda P: [] if P.is_ref else via_service(P, service_for(P)))
    finally:
        monkeypatch.undo()
        for name in ("hypervisor_tpu_torch.api.models", "hypervisor_tpu_torch.api.service",
                     "hypervisor_tpu_torch.api.server", "hypervisor_tpu_torch.api"):
            importlib.reload(sys.modules[name])
    assert importlib.import_module("hypervisor_tpu_torch.api.models")._HAVE_PYDANTIC
    compare(service_runs[1], port_bare)


def test_routes_match_reference():
    ref = [(m, p, n, getattr(r, "__name__", None)) for m, p, n, r in REF.api.ROUTES]
    port = [(m, p, n, getattr(r, "__name__", None)) for m, p, n, r in PORT.api.ROUTES]
    assert port == ref


def test_fleet_and_autopilot_endpoints_name_a_later_slice():
    """With no fleet and no autopilot attached, `/debug/fleet` and
    `/debug/autopilot` answer `{"enabled": false}` and the other fleet
    routes the reference's typed 503, status and body equal to the
    reference's over the stdlib transport (the fleet's own parity is in
    `tests/test_torch_fleet.py`). The name is the one this test had while
    the fleet routes refused."""
    paths = ["/debug/autopilot", "/debug/fleet", "/fleet/workers", "/fleet/metrics",
             "/fleet/slo", "/fleet/trace/t1", "/fleet/incidents", "/fleet/ownership",
             "/fleet/failover", "/fleet/rebalance"]

    def drive(P):
        server = P.mod("api").HypervisorHTTPServer(service=service_for(P), port=0).start()
        out = []
        try:
            for path in paths:
                conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
                conn.request("GET", path)
                resp = conn.getresponse()
                out.append((path, resp.status, json.loads(resp.read())))
                conn.close()
        finally:
            server.stop()
        return out

    ref, port = both(drive)
    assert port == ref
    rec = {path: (status, body) for path, status, body in port}
    assert rec["/debug/autopilot"] == rec["/debug/fleet"] == (200, {"enabled": False})
    for path in paths[2:]:
        assert rec[path][0] == 503, path
        assert re.search(r"no fleet attached", rec[path][1]["detail"]), path


def test_debug_profile_captures_and_refuses_while_a_trace_runs(tmp_path):
    svc = service_for(Pkg(PORT))
    models = PORT.api.models
    out = asyncio.run(svc.debug_profile(models.ProfileRequest(duration_s=0.01,
                                                              log_dir=str(tmp_path / "a"))))
    assert out["status"] == "captured" and out["dir"] == str(tmp_path / "a")
    assert "hv.profile_window" in {e.get("name") for e in json.load(open(out["trace"]))["traceEvents"]}
    profiling = PORT.observability.profiling
    assert profiling.start(str(tmp_path / "manual"))
    try:
        with pytest.raises(PORT.api.ApiError) as err:
            asyncio.run(svc.debug_profile(models.ProfileRequest(duration_s=0.01)))
    finally:
        profiling.stop()
    assert err.value.status == 409 and "active" in err.value.detail


def test_http_429_carries_a_retry_after_header():
    svc = service_for(Pkg(PORT))
    server = PORT.api.HypervisorHTTPServer(service=svc, port=0).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
        conn.request("POST", "/api/v1/sessions", body=json.dumps({"creator_did": "did:c"}))
        sid = json.loads(conn.getresponse().read())["session_id"]
        svc.hv.state.degraded_policy = PORT.resilience.policy.DegradedPolicy(reason="drill")
        conn.request("POST", f"/api/v1/sessions/{sid}/join",
                     body=json.dumps({"agent_did": "did:shed", "sigma_raw": 0.9}))
        resp = conn.getresponse()
        resp.read()
        conn.close()
        assert resp.status == 429 and int(resp.getheader("Retry-After")) >= 1
    finally:
        svc.hv.state.degraded_policy = None
        server.stop()


def test_fastapi_transport_is_ported_as_text():
    """The FastAPI app builds only where fastapi is installed (neither
    here nor on the card), as the reference's transport tests skip."""
    pytest.importorskip("fastapi")
    app = PORT.api.create_app(service_for(Pkg(PORT)))
    assert {r.path for r in app.routes} >= {p for _, p, _, _ in PORT.api.ROUTES}
