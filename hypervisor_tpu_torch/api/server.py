"""REST transports for the Hypervisor API.

Two transports over the same `HypervisorService` (44 routes: the
reference's 21, `api/server.py`, plus device stats, quarantine views,
the per-membership agent view, leave, the operator sweep, the
per-action gateway with its wave sibling, the flight recorder —
`GET /trace/{session_id}` Chrome/OTLP export + `GET /debug/flight` —
and the health plane: `GET /debug/health` (watchdog + occupancy +
compile totals + stage quantiles), `GET /debug/memory` (per-table HBM
footprints), `GET /debug/compiles` (compile telemetry), plus the
resilience plane: `GET /debug/resilience` (supervisor mode, retry
accounting, WAL status, last watermarked checkpoint), the integrity
plane: `GET /debug/integrity` (sanitizer violations, scrub progress,
repair/restore ladder accounting), and the serving front door:
`GET /debug/serving` (queue depths, shed rates, deadline misses, wave
cadence), `POST .../join-wave` (batched joins with per-lane typed
refusals), and `GET /api/v1/serving/stream` (NDJSON watch feed);
overload sheds map to HTTP 429 + Retry-After on BOTH transports — the
Retry-After hint is LIVE: queue depth x observed drain rate, scaled by
the class's SLO burn state — plus the latency observatory:
`GET /debug/slo` (per-class burn rates, critical-path decomposition,
exemplars, phase shares), and the roofline observatory:
`GET /debug/roofline` (per-program cost models, achieved-bandwidth
fractions, headroom ranking, distance to the floor) +
`POST /debug/profile` (on-demand wedge-proof jax.profiler window)):

 - `create_app()` — a FastAPI application with CORS-open middleware and
   OpenAPI docs, when fastapi is installed.
 - `serve()` / `HypervisorHTTPServer` — a dependency-free stdlib
   `http.server` JSON transport for the bare image (same routes, same
   status codes).
"""

from __future__ import annotations

import asyncio
import json
import re
from typing import Any, Optional
from urllib.parse import parse_qs, urlparse

from hypervisor_tpu_torch import __version__
from hypervisor_tpu_torch.api import models as M
from hypervisor_tpu_torch.api.service import (
    ApiError,
    HypervisorService,
    NdjsonStream,
    PrometheusText,
)
from hypervisor_tpu_torch.observability.metrics import PROMETHEUS_CONTENT_TYPE
from hypervisor_tpu_torch.resilience.policy import DegradedModeRefusal


def _retry_after_headers(retry_after_s: Optional[float]) -> dict:
    """Retry-After header for a 429 (whole seconds, rounded up)."""
    import math

    seconds = max(1, math.ceil(retry_after_s or 1.0))
    return {"Retry-After": str(seconds)}

# ── Route table: (method, pattern, handler_name, request_model) ──────
# {name} segments become handler kwargs; query params pass through for GET.

ROUTES: list[tuple[str, str, str, Optional[type]]] = [
    ("GET", "/health", "health", None),
    ("GET", "/metrics", "metrics", None),
    ("GET", "/trace/{session_id}", "trace_session", None),
    ("GET", "/debug/flight", "debug_flight", None),
    ("GET", "/debug/health", "debug_health", None),
    ("GET", "/debug/memory", "debug_memory", None),
    ("GET", "/debug/compiles", "debug_compiles", None),
    ("GET", "/debug/resilience", "debug_resilience", None),
    ("GET", "/debug/integrity", "debug_integrity", None),
    ("GET", "/debug/serving", "debug_serving", None),
    ("GET", "/debug/slo", "debug_slo", None),
    ("GET", "/debug/roofline", "debug_roofline", None),
    ("GET", "/debug/tenants", "debug_tenants", None),
    ("GET", "/debug/autopilot", "debug_autopilot", None),
    ("POST", "/debug/profile", "debug_profile", M.ProfileRequest),
    ("GET", "/debug/fleet", "debug_fleet", None),
    ("GET", "/fleet/workers", "fleet_workers", None),
    ("GET", "/fleet/metrics", "fleet_metrics", None),
    ("GET", "/fleet/slo", "fleet_slo", None),
    ("GET", "/fleet/trace/{trace_id}", "fleet_trace", None),
    ("GET", "/fleet/incidents", "fleet_incidents", None),
    ("GET", "/fleet/ownership", "fleet_ownership", None),
    ("GET", "/fleet/failover", "fleet_failover", None),
    ("GET", "/fleet/rebalance", "fleet_rebalance", None),
    ("POST", "/fleet/rebalance", "fleet_rebalance_post",
     M.FleetRebalanceRequest),
    ("GET", "/debug/incidents", "debug_incidents", None),
    ("GET", "/incidents/{incident_id}", "get_incident", None),
    ("GET", "/history/query", "history_query", None),
    ("GET", "/api/v1/stats", "stats", None),
    ("GET", "/api/v1/device/stats", "device_stats", None),
    ("POST", "/api/v1/sessions", "create_session", M.CreateSessionRequest),
    ("GET", "/api/v1/sessions", "list_sessions", None),
    ("GET", "/api/v1/sessions/{session_id}", "get_session", None),
    ("POST", "/api/v1/sessions/{session_id}/join", "join_session", M.JoinSessionRequest),
    ("POST", "/api/v1/sessions/{session_id}/join-wave", "join_wave",
     M.JoinWaveRequest),
    ("GET", "/api/v1/serving/stream", "serving_stream", None),
    ("POST", "/api/v1/sessions/{session_id}/activate", "activate_session", None),
    ("POST", "/api/v1/sessions/{session_id}/terminate", "terminate_session", None),
    ("GET", "/api/v1/sessions/{session_id}/rings", "ring_distribution", None),
    ("GET", "/api/v1/agents/{agent_did}/ring", "agent_ring", None),
    ("GET", "/api/v1/agents/{agent_did}/memberships", "agent_memberships", None),
    ("POST", "/api/v1/rings/check", "ring_check", M.RingCheckRequest),
    ("POST", "/api/v1/sessions/{session_id}/actions/check", "action_check",
     M.ActionCheckRequest),
    ("POST", "/api/v1/sessions/{session_id}/actions/check-wave",
     "action_check_wave", M.ActionWaveRequest),
    ("POST", "/api/v1/sessions/{session_id}/sagas", "create_saga", None),
    ("GET", "/api/v1/sessions/{session_id}/sagas", "list_sagas", None),
    ("GET", "/api/v1/sagas/{saga_id}", "get_saga", None),
    ("POST", "/api/v1/sagas/{saga_id}/steps", "add_saga_step", M.AddStepRequest),
    (
        "POST",
        "/api/v1/sagas/{saga_id}/steps/{step_id}/execute",
        "execute_saga_step",
        None,
    ),
    ("POST", "/api/v1/sessions/{session_id}/vouch", "create_vouch", M.CreateVouchRequest),
    ("GET", "/api/v1/sessions/{session_id}/vouches", "list_vouches", None),
    ("GET", "/api/v1/agents/{agent_did}/liability", "agent_liability", None),
    ("GET", "/api/v1/events", "query_events", None),
    ("GET", "/api/v1/events/stats", "event_stats", None),
    ("GET", "/api/v1/agents/{agent_did}/quarantine", "agent_quarantine", None),
    ("GET", "/api/v1/security/quarantines", "list_quarantines", None),
    ("POST", "/api/v1/sessions/{session_id}/leave", "leave_session",
     M.LeaveSessionRequest),
    ("POST", "/api/v1/sessions/{session_id}/kill", "kill_agent",
     M.KillAgentRequest),
    ("POST", "/api/v1/security/sweep", "run_sweeps", None),
]

_QUERY_PARAMS = {
    "list_sessions": ("state",),
    "query_events": ("event_type", "session_id", "agent_did", "limit"),
    "trace_session": ("format",),
    "fleet_trace": ("format",),
    "serving_stream": ("frames", "interval"),
    "history_query": ("series", "start", "end", "tier"),
}

#: Typed query params (everything else passes through as a string).
_QUERY_COERCE = {
    "limit": int,
    "frames": int,
    "interval": float,
    "start": float,
    "end": float,
    "tier": int,
}


def _coerce_query(name: str, value: str):
    return _QUERY_COERCE.get(name, str)(value)

#: Stdlib-transport request-body ceiling: no governance call carries
#: megabytes, and an attacker-declared huge Content-Length must refuse
#: (413) instead of committing the handler thread to reading it.
_MAX_BODY_BYTES = 4 << 20


def _to_jsonable(result: Any) -> Any:
    if hasattr(result, "model_dump"):
        return result.model_dump()
    if isinstance(result, list):
        return [_to_jsonable(r) for r in result]
    return result


# ── FastAPI transport (optional dependency) ──────────────────────────


def create_app(service: Optional[HypervisorService] = None):
    """Build the FastAPI app; raises ImportError when fastapi is absent."""
    from fastapi import FastAPI, HTTPException, Request
    from fastapi.middleware.cors import CORSMiddleware

    svc = service or HypervisorService()
    app = FastAPI(
        title="Hypervisor-TPU API",
        description=(
            "REST API for the TPU-native Agent Hypervisor — multi-agent "
            "Shared Sessions with Execution Rings, Joint Liability, Saga "
            "orchestration, and Merkle audit trails."
        ),
        version=__version__,
    )
    app.add_middleware(
        CORSMiddleware,
        allow_origins=["*"],
        allow_credentials=True,
        allow_methods=["*"],
        allow_headers=["*"],
    )
    app.state.service = svc

    for method, pattern, name, request_model in ROUTES:
        def make_endpoint(name=name, request_model=request_model):
            async def endpoint(request: Request):
                path_kwargs = dict(request.path_params)
                if request_model is not None:
                    # Same byzantine containment as the stdlib
                    # transport: malformed bodies are 400s, not 500s,
                    # and a declared-huge body refuses (413) before the
                    # worker commits to buffering it.
                    declared = request.headers.get("content-length")
                    if declared is not None:
                        try:
                            length = int(declared)
                        except ValueError:
                            raise HTTPException(
                                status_code=400,
                                detail="bad Content-Length",
                            )
                        if length < 0:
                            raise HTTPException(
                                status_code=400,
                                detail="bad Content-Length",
                            )
                        if length > _MAX_BODY_BYTES:
                            raise HTTPException(
                                status_code=413, detail="body too large"
                            )
                    try:
                        body = await request.json()
                    except Exception as e:  # noqa: BLE001 — parse error
                        raise HTTPException(
                            status_code=400,
                            detail=f"malformed JSON: {e}",
                        )
                    if not isinstance(body, dict):
                        raise HTTPException(
                            status_code=422, detail="JSON object required"
                        )
                    path_kwargs["req"] = request_model(**body)
                for q in _QUERY_PARAMS.get(name, ()):
                    if q in request.query_params:
                        value = request.query_params[q]
                        try:
                            path_kwargs[q] = _coerce_query(q, value)
                        except ValueError:
                            raise HTTPException(
                                status_code=400,
                                detail=f"bad query param {q!r}",
                            )
                try:
                    result = await getattr(svc, name)(**path_kwargs)
                except ApiError as e:
                    raise HTTPException(
                        status_code=e.status,
                        detail=e.detail,
                        headers=(
                            _retry_after_headers(e.retry_after_s)
                            if e.status == 429
                            else None
                        ),
                    )
                except DegradedModeRefusal as e:
                    # An overload shed surfacing anywhere in a handler
                    # is backpressure: 429 + Retry-After, never a 500.
                    raise HTTPException(
                        status_code=429,
                        detail=str(e),
                        headers=_retry_after_headers(None),
                    )
                if isinstance(result, PrometheusText):
                    from fastapi.responses import PlainTextResponse

                    return PlainTextResponse(
                        str(result), media_type=PROMETHEUS_CONTENT_TYPE
                    )
                if isinstance(result, NdjsonStream):
                    from fastapi.responses import StreamingResponse

                    return StreamingResponse(
                        (json.dumps(f) + "\n" for f in result.frames),
                        media_type=NdjsonStream.content_type,
                    )
                return _to_jsonable(result)

            return endpoint

        app.add_api_route(
            pattern,
            make_endpoint(),
            methods=[method],
            status_code=201 if (method, name) in _CREATED else 200,
        )
    return app


_CREATED = {
    ("POST", "create_session"),
    ("POST", "create_saga"),
    ("POST", "add_saga_step"),
    ("POST", "create_vouch"),
}


# ── stdlib transport ─────────────────────────────────────────────────


class _Router:
    def __init__(self) -> None:
        self._routes: list[tuple[str, re.Pattern, str, Optional[type]]] = []
        for method, pattern, name, request_model in ROUTES:
            regex = re.compile(
                "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$"
            )
            self._routes.append((method, regex, name, request_model))

    def match(self, method: str, path: str):
        for m, regex, name, request_model in self._routes:
            if m != method:
                continue
            hit = regex.match(path)
            if hit:
                return name, hit.groupdict(), request_model
        return None


class HypervisorHTTPServer:
    """JSON-over-stdlib-http transport for the service layer."""

    def __init__(self, service: Optional[HypervisorService] = None, port: int = 0):
        import http.server
        import threading

        self.service = service or HypervisorService()
        router = _Router()
        svc = self.service

        class Handler(http.server.BaseHTTPRequestHandler):
            # Keep-alive: every response carries Content-Length (or
            # proper chunked framing, `_stream_ndjson`), so HTTP/1.1 is
            # safe — and pollers like hv_top ride ONE connection per
            # refresh instead of a socket per endpoint.
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _dispatch(self, method: str) -> None:
                parsed = urlparse(self.path)
                match = router.match(method, parsed.path)
                if match is None:
                    self._send(404, {"detail": "Not found"})
                    return
                name, kwargs, request_model = match
                if request_model is not None:
                    # Byzantine-client containment (the API-fuzz
                    # scenario, `testing.scenarios`): a malformed body
                    # or garbage Content-Length is a 4xx refusal, never
                    # an unhandled raise that drops the connection.
                    try:
                        length = int(self.headers.get("Content-Length") or 0)
                    except ValueError:
                        self._send(400, {"detail": "bad Content-Length"})
                        return
                    if length < 0:
                        # rfile.read(negative) would block until the
                        # client closes, pinning a handler thread.
                        self._send(400, {"detail": "bad Content-Length"})
                        return
                    if length > _MAX_BODY_BYTES:
                        self._send(413, {"detail": "body too large"})
                        return
                    try:
                        body = json.loads(self.rfile.read(length) or b"{}")
                    except (json.JSONDecodeError, UnicodeDecodeError) as e:
                        self._send(400, {"detail": f"malformed JSON: {e}"})
                        return
                    if not isinstance(body, dict):
                        self._send(422, {"detail": "JSON object required"})
                        return
                    try:
                        kwargs["req"] = request_model(**body)
                    except Exception as e:  # noqa: BLE001 — validation error
                        self._send(422, {"detail": str(e)})
                        return
                query = parse_qs(parsed.query)
                for q in _QUERY_PARAMS.get(name, ()):
                    if q in query:
                        value = query[q][0]
                        try:
                            kwargs[q] = _coerce_query(q, value)
                        except ValueError:
                            self._send(
                                400, {"detail": f"bad query param {q!r}"}
                            )
                            return
                try:
                    result = asyncio.run(getattr(svc, name)(**kwargs))
                except ApiError as e:
                    self._send(
                        e.status,
                        {"detail": e.detail},
                        headers=(
                            _retry_after_headers(e.retry_after_s)
                            if e.status == 429
                            else None
                        ),
                    )
                    return
                except DegradedModeRefusal as e:
                    # Overload shed in a handler = backpressure: 429 +
                    # Retry-After, never an unhandled raise (500/drop).
                    self._send(
                        429,
                        {"detail": str(e)},
                        headers=_retry_after_headers(None),
                    )
                    return
                status = 201 if ("POST", name) in _CREATED else 200
                if isinstance(result, PrometheusText):
                    self._send_raw(
                        status, str(result).encode(), PROMETHEUS_CONTENT_TYPE
                    )
                    return
                if isinstance(result, NdjsonStream):
                    self._stream_ndjson(result)
                    return
                self._send(status, _to_jsonable(result))

            def _stream_ndjson(self, stream: NdjsonStream) -> None:
                """Chunked newline-delimited JSON (the serving watch
                feed): frames flush as they are produced."""
                self.send_response(200)
                self.send_header("Content-Type", NdjsonStream.content_type)
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header("Access-Control-Allow-Origin", "*")
                self.end_headers()
                try:
                    for frame in stream.frames:
                        data = (json.dumps(frame) + "\n").encode()
                        self.wfile.write(
                            f"{len(data):x}\r\n".encode() + data + b"\r\n"
                        )
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client went away mid-stream

            def _send(
                self,
                status: int,
                payload: Any,
                headers: Optional[dict] = None,
            ) -> None:
                self._send_raw(
                    status,
                    json.dumps(payload).encode(),
                    "application/json",
                    headers=headers,
                )

            def _send_raw(
                self,
                status: int,
                data: bytes,
                content_type: str,
                headers: Optional[dict] = None,
            ) -> None:
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.send_header("Access-Control-Allow-Origin", "*")
                for key, value in (headers or {}).items():
                    self.send_header(key, value)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

        self._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)

    def start(self) -> "HypervisorHTTPServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def serve(port: int = 8000, service: Optional[HypervisorService] = None) -> None:
    """Blocking server entry point: FastAPI+uvicorn if present, else stdlib."""
    try:
        import uvicorn  # noqa: F401

        uvicorn.run(create_app(service), host="0.0.0.0", port=port)
    except ImportError:
        server = HypervisorHTTPServer(service, port=port)
        print(f"hypervisor-tpu API (stdlib transport) on :{server.port}")
        server._httpd.serve_forever()
