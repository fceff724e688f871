"""ONE merged fleet exposition + the frozen `FleetSnapshot` rollup.

The tenant-label merge is the template, lifted one level: every
worker's `/metrics` rendering concatenates into ONE exposition with
`worker="<id>"` stamped on EVERY series (tenant + worker become two
labels — a tenant-arena worker's `tenant="3"` series gains
`worker="w0"` next to it), headers emitted once from the first worker.
Label values escape through the ONE shared helper
(`observability.metrics.escape_label_value`) so a hostile worker or
tenant id cannot break the scrape line.

The rollups (fleet occupancy / compile / recompile totals, per-worker
roofline floor distance, worst-burn tenant across workers) fold into a
frozen `FleetSnapshot` whose `digest()` covers exactly the rule-input
fields — wall-contaminated advisories (burn states, scrape wall) are
excluded, the `SignalSnapshot` discipline — ready to feed a
fleet-level autopilot later.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import re
import time
import urllib.parse
from typing import Mapping, Optional

from hypervisor_tpu_torch.observability.metrics import escape_label_value
from hypervisor_tpu_torch.observability.snapshot import snapshot_digest

#: Debug endpoints the fleet drain scrapes per worker, joined with
#: `/metrics` into the merged exposition + snapshot rollups.
DEBUG_ENDPOINTS = (
    "health", "slo", "roofline", "tenants", "autopilot",
)

_SAMPLE_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(.*)$")

_BURN_RANK = {"ok": 0, "warning": 1, "critical": 2}


# ── exposition merge (the tenant template, worker axis) ─────────────


def stamp_worker_label(text: str, worker: str, emit_headers: bool) -> str:
    """Re-stamp one worker's exposition: inject `worker="<id>"` into
    EVERY sample line; keep `# HELP`/`# TYPE` headers only when
    `emit_headers` (headers once, from the first worker)."""
    stamped = escape_label_value(worker)
    out: list[str] = []
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("#"):
            if emit_headers:
                out.append(line)
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            # Not a sample line — pass through untouched rather than
            # guess at a label splice point.
            out.append(line)
            continue
        name, labels, value = m.group(1), m.group(2), m.group(3)
        if labels:
            inner = labels[1:-1]
            merged = f'{{worker="{stamped}"' + ("," + inner if inner else "") + "}"
        else:
            merged = f'{{worker="{stamped}"}}'
        out.append(f"{name}{merged} {value}")
    return "\n".join(out) + ("\n" if out else "")


def merge_expositions(per_worker: Mapping[str, str]) -> str:
    """Concatenate every worker's `/metrics` text into ONE exposition,
    worker-labeled on every row (sorted worker order; headers from the
    first worker only — the `TenantArena.metrics_prometheus` shape)."""
    parts = [
        stamp_worker_label(per_worker[w], w, emit_headers=(i == 0))
        for i, w in enumerate(sorted(per_worker))
    ]
    return "".join(parts)


def sample_series_count(text: str) -> int:
    """Number of sample rows (non-comment, non-blank) in an exposition."""
    return sum(
        1
        for line in text.splitlines()
        if line.strip() and not line.startswith("#")
    )


def worker_label_coverage(text: str) -> float:
    """Fraction of sample rows carrying a `worker="..."` label — the
    gate-6k conservation check pins this at exactly 1.0."""
    total = labeled = 0
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        total += 1
        if 'worker="' in line:
            labeled += 1
    return (labeled / total) if total else 0.0


# ── the frozen fleet rollup ──────────────────────────────────────────


@dataclasses.dataclass(frozen=True)
class FleetSnapshot:
    """One drain round's fleet rollup (host-plane, frozen).

    Every field is either deterministic given the scraped payloads
    (counters, lease states, series counts) or quantized before
    digesting (floor distances). The advisory fields are contaminated
    by measured wall clock and are EXCLUDED from `digest()` — the
    `SignalSnapshot` discipline: every rule input stays digest-covered.
    """

    seq: int
    now: float                       # caller's clock
    workers: tuple = ()              # sorted worker ids
    states: tuple = ()               # ((worker, lease state), ...)
    occupancy: tuple = ()            # ((worker, live sessions), ...)
    compiles: tuple = ()             # ((worker, compiles), ...)
    recompiles: tuple = ()           # ((worker, recompiles), ...)
    series: tuple = ()               # ((worker, sample series), ...)
    merged_series: int = 0
    transitions_digest: str = ""     # the lease plane's replay digest
    floor_distance: tuple = ()       # ((worker, distance), ...) quantized
    # ── advisory (wall-contaminated; excluded from digest) ───────────
    worst_burn: tuple = ()           # (worker, queue/tenant, state) worst
    scrape_wall_ms: float = 0.0
    errors: tuple = ()               # ((worker, endpoint), ...) fetch fails

    _ADVISORY_FIELDS = ("worst_burn", "scrape_wall_ms", "errors")

    def digest(self) -> str:
        """sha256 over the canonical encoding of the rule-input fields
        (sorted keys, quantized floats, advisories popped) — encoding
        via the ONE shared `observability.snapshot` helper."""

        def _quantize(payload: dict) -> None:
            payload["now"] = round(self.now, 6)
            payload["floor_distance"] = [
                (w, None if d is None else round(float(d), 1))
                for w, d in self.floor_distance
            ]

        return snapshot_digest(self, _quantize)

    def totals(self) -> dict:
        return {
            "occupancy": sum(v for _, v in self.occupancy),
            "compiles": sum(v for _, v in self.compiles),
            "recompiles": sum(v for _, v in self.recompiles),
            "series": sum(v for _, v in self.series),
        }


# ── per-worker scraping (keep-alive) ─────────────────────────────────


class WorkerClient:
    """ONE reused HTTP connection per worker, across scrape planes AND
    drain rounds — the `hv_top.UrlPoller` precedent lifted into the
    supervisor's scraper. Before round 19 every plane of every round
    was its own `urllib.request.urlopen` (TCP handshake per endpoint
    per cycle: 6 redials per worker per drain). Both transports have
    served HTTP/1.1 keep-alive since r18; against an HTTP/1.0 server
    `will_close` drops the socket and the next request transparently
    redials."""

    def __init__(self, base_url: str, timeout_s: float = 5.0) -> None:
        if "://" not in base_url:
            base_url = "http://" + base_url
        u = urllib.parse.urlsplit(base_url.rstrip("/"))
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or (443 if u.scheme == "https" else 80)
        self.timeout_s = float(timeout_s)
        self._conn: Optional[http.client.HTTPConnection] = None

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None

    def get(self, path: str) -> tuple[int, bytes]:
        """GET over the reused connection; one reconnect retry covers
        a server that dropped the idle socket between rounds."""
        for attempt in (0, 1):
            try:
                if self._conn is None:
                    self._conn = http.client.HTTPConnection(
                        self.host, self.port, timeout=self.timeout_s
                    )
                self._conn.request("GET", path)
                resp = self._conn.getresponse()
                body = resp.read()
                if resp.will_close:
                    self.close()
                return resp.status, body
            except (OSError, http.client.HTTPException):
                self.close()
                if attempt:
                    raise
        raise OSError("unreachable")  # pragma: no cover

    def get_text(self, path: str) -> Optional[str]:
        try:
            status, body = self.get(path)
        except (OSError, http.client.HTTPException):
            return None
        if status != 200:
            return None
        return body.decode("utf-8", "replace")

    def get_json(self, path: str) -> Optional[dict]:
        raw = self.get_text(path)
        if raw is None:
            return None
        try:
            return json.loads(raw)
        except json.JSONDecodeError:
            return None


def _split_url(url: str) -> tuple[str, str]:
    """(base, path) of one absolute URL — the compat-shim splitter."""
    if "://" not in url:
        url = "http://" + url
    u = urllib.parse.urlsplit(url)
    base = f"{u.scheme}://{u.netloc}"
    path = u.path or "/"
    if u.query:
        path += "?" + u.query
    return base, path


def fetch_text(url: str, timeout_s: float = 5.0) -> Optional[str]:
    """One-shot fetch (throwaway connection) — kept for callers
    outside the observatory's keep-alive pool."""
    base, path = _split_url(url)
    client = WorkerClient(base, timeout_s)
    try:
        return client.get_text(path)
    finally:
        client.close()


def fetch_json(url: str, timeout_s: float = 5.0) -> Optional[dict]:
    raw = fetch_text(url, timeout_s)
    if raw is None:
        return None
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return None


def _worst_burn_of(slo_payload: Optional[dict]) -> Optional[tuple]:
    """(queue, state) of the worst burn class in one worker's
    /debug/slo payload, or None."""
    if not slo_payload or not slo_payload.get("enabled"):
        return None
    worst = None
    for queue, rec in (slo_payload.get("classes") or {}).items():
        state = (rec or {}).get("burn_state") or (rec or {}).get("state")
        if state is None:
            continue
        if worst is None or _BURN_RANK.get(state, 0) > _BURN_RANK.get(
            worst[1], 0
        ):
            worst = (queue, state)
    return worst


class FleetObservatory:
    """The supervisor-side drain: scrape every worker, merge the
    expositions, fold the `FleetSnapshot`, publish `hv_fleet_*` rows.

    Attach to a `HypervisorService` via `service.fleet = observatory`
    to surface `GET /debug/fleet` + `GET /fleet/*` on both transports.
    """

    def __init__(
        self,
        workers: Mapping[str, str],
        registry=None,
        metrics=None,
        timeout_s: float = 5.0,
    ) -> None:
        #: worker id -> base URL (e.g. "http://127.0.0.1:8091").
        self.workers = dict(workers)
        self.registry = registry
        self.metrics = metrics
        self.timeout_s = float(timeout_s)
        self._seq = 0
        self.last_snapshot: Optional[FleetSnapshot] = None
        self.last_merged: Optional[str] = None
        #: ONE keep-alive connection per worker, reused across scrape
        #: planes and drain rounds (`WorkerClient`).
        self._clients: dict[str, WorkerClient] = {}
        #: Last successfully scraped exposition per worker — retained
        #: across rounds so a `fleet.worker_dead` incident can bundle
        #: what the worker looked like BEFORE it stopped answering.
        self.last_expositions: dict[str, str] = {}
        #: Supervisor-side black-box recorder (FLEET scope): captures
        #: on new DEAD lease transitions after each drain. Timestamps
        #: come from the transition's caller clock, so a seeded kill
        #: drill replays to a bit-identical incident digest (gate 6l).
        from hypervisor_tpu_torch.observability.incidents import IncidentRecorder

        self.incidents = IncidentRecorder(metrics=metrics, scope="fleet")
        self.incidents.register_provider(
            "exposition", self._incident_exposition_block
        )
        self.incidents.register_provider(
            "registry", self._incident_registry_block
        )
        self.incidents.register_provider(
            "trace", self._incident_trace_block
        )
        #: Transition seqs already examined for capture (the DEAD scan
        #: is incremental; replaying the registry does not re-capture).
        self._transition_cursor = 0
        #: Optional failover plane (`fleet.failover`): attach an
        #: `OwnershipMap` / `FailoverController` here and the API
        #: surfaces them at `GET /fleet/ownership` / `/fleet/failover`.
        self.ownership = None
        self.failover = None
        #: Optional rebalance plane (`fleet.rebalance`): attach a
        #: `RebalanceController` here and the API surfaces it at
        #: `GET/POST /fleet/rebalance`.
        self.rebalance = None

    def _client(self, worker: str) -> WorkerClient:
        client = self._clients.get(worker)
        if client is None:
            client = WorkerClient(self.workers[worker], self.timeout_s)
            self._clients[worker] = client
        return client

    def close(self) -> None:
        for client in self._clients.values():
            client.close()
        self._clients.clear()

    # ── the merged drain ─────────────────────────────────────────────

    def drain(self, now: Optional[float] = None) -> tuple[str, FleetSnapshot]:
        """One drain round: scrape `/metrics` + the debug endpoints
        from every worker, merge + worker-label the exposition, fold
        the rollup snapshot. A worker that fails to answer drops out
        of this round's merge (its absence is visible in `errors` and
        `hv_fleet_scrape_errors_total`)."""
        t0 = time.perf_counter()
        if now is None:
            now = time.time()
        expositions: dict[str, str] = {}
        payloads: dict[str, dict] = {}
        errors: list[tuple] = []
        for worker in sorted(self.workers):
            client = self._client(worker)
            text = client.get_text("/metrics")
            if text is None:
                errors.append((worker, "metrics"))
            else:
                expositions[worker] = text
                self.last_expositions[worker] = text
            per = {}
            for ep in DEBUG_ENDPOINTS:
                doc = client.get_json(f"/debug/{ep}")
                if doc is None:
                    errors.append((worker, ep))
                else:
                    per[ep] = doc
            payloads[worker] = per
        merged = merge_expositions(expositions)
        snap = self._fold(
            now, expositions, payloads, merged, errors,
            scrape_wall_ms=(time.perf_counter() - t0) * 1e3,
        )
        self.last_snapshot = snap
        self.last_merged = merged
        self._publish(snap, errors)
        self._capture_dead_transitions()
        return merged, snap

    # ── fleet incident capture (the worker_dead black box) ───────────

    def _capture_dead_transitions(self) -> None:
        """Scan the lease plane's transition log past the cursor and
        capture ONE fleet-scope incident per new DEAD declaration.
        Rule inputs (worker, lease seq, transition `now`) all come
        from the replay-deterministic transition itself, so the same
        seeded kill drill replays to a bit-identical incident id."""
        if self.registry is None:
            return
        transitions = self.registry.transitions
        for tr in transitions[self._transition_cursor:]:
            if tr.new == "dead":
                self.incidents.observe(
                    "fleet_worker_dead",
                    {
                        "worker": tr.worker,
                        "lease_seq": tr.seq,
                        "from": tr.old,
                        "to": tr.new,
                        "now": round(float(tr.now), 6),
                        "replay_key": tr.replay_key(),
                    },
                )
        self._transition_cursor = len(transitions)

    def _incident_exposition_block(self, trigger: dict) -> dict:
        """The dead worker's LAST successfully scraped exposition —
        what it looked like before it stopped answering."""
        worker = trigger.get("worker")
        text = self.last_expositions.get(worker)
        return {
            "worker": worker,
            "series": (
                sample_series_count(text) if text is not None else 0
            ),
            "metrics": text,
        }

    def _incident_registry_block(self, trigger: dict) -> dict:
        """The lease plane's journal slice + replay digest around the
        transition that triggered capture."""
        if self.registry is None:
            return {"enabled": False}
        out = self.registry.summary(tail=16)
        out["enabled"] = True
        out["observations_tail"] = [
            list(o) for o in self.registry.observations[-32:]
        ]
        return out

    def _incident_trace_block(self, trigger: dict) -> dict:
        """Stitched fleet trace for the trigger's causal trace id (a
        synthetic per-incident id when the trigger carries none) — the
        `fleet.missing` block names the dead worker's absent lane."""
        from hypervisor_tpu_torch.fleet.trace import stitch_fleet_trace

        trace_id = trigger.get("trace_id") or (
            f"fleet-dead-{trigger.get('worker')}-{trigger.get('lease_seq')}"
        )
        return stitch_fleet_trace(
            self.workers, trace_id, timeout_s=min(self.timeout_s, 2.0)
        )

    def _fold(
        self, now, expositions, payloads, merged, errors, scrape_wall_ms
    ) -> FleetSnapshot:
        states = (
            tuple(sorted(self.registry.states().items()))
            if self.registry is not None
            else ()
        )
        occupancy, compiles, recompiles, series, floors = [], [], [], [], []
        worst = None
        for worker in sorted(self.workers):
            per = payloads.get(worker, {})
            health = per.get("health") or {}
            comp = health.get("compiles") or {}
            occ = health.get("occupancy") or {}
            live = occ.get("tables") or {}
            sessions = live.get("sessions") or {}
            occupancy.append(
                (worker, int(sessions.get("live_rows", 0) or 0))
            )
            compiles.append((worker, int(comp.get("compiles", 0) or 0)))
            recompiles.append((worker, int(comp.get("recompiles", 0) or 0)))
            if worker in expositions:
                series.append(
                    (worker, sample_series_count(expositions[worker]))
                )
            roof = per.get("roofline") or {}
            floor = (roof.get("floor") or {}) if roof.get("enabled") else {}
            floors.append((worker, floor.get("distance")))
            wb = _worst_burn_of(per.get("slo"))
            if wb is not None and (
                worst is None
                or _BURN_RANK.get(wb[1], 0) > _BURN_RANK.get(worst[2], 0)
            ):
                worst = (worker, wb[0], wb[1])
        self._seq += 1
        return FleetSnapshot(
            seq=self._seq,
            now=round(float(now), 6),
            workers=tuple(sorted(self.workers)),
            states=states,
            occupancy=tuple(occupancy),
            compiles=tuple(compiles),
            recompiles=tuple(recompiles),
            series=tuple(series),
            merged_series=sample_series_count(merged),
            transitions_digest=(
                self.registry.transition_digest()
                if self.registry is not None
                else ""
            ),
            floor_distance=tuple(floors),
            worst_burn=(worst,) if worst is not None else (),
            scrape_wall_ms=round(scrape_wall_ms, 3),
            errors=tuple(errors),
        )

    def _publish(self, snap: FleetSnapshot, errors) -> None:
        if self.metrics is None:
            return
        from hypervisor_tpu_torch.observability import metrics as mp

        counts = (
            self.registry.counts()
            if self.registry is not None
            else {"alive": len(self.workers), "suspected": 0, "dead": 0}
        )
        self.metrics.gauge_set(mp.FLEET_WORKERS_ALIVE, counts["alive"])
        self.metrics.gauge_set(
            mp.FLEET_WORKERS_SUSPECTED, counts["suspected"]
        )
        self.metrics.gauge_set(mp.FLEET_WORKERS_DEAD, counts["dead"])
        self.metrics.inc(mp.FLEET_SCRAPES)
        if errors:
            self.metrics.inc(mp.FLEET_SCRAPE_ERRORS, len(errors))

    # ── service-facing views ─────────────────────────────────────────

    def summary(self) -> dict:
        """The `/debug/fleet` payload: lease states, rollup totals,
        the snapshot's rule-input digest, per-worker floor distance."""
        merged, snap = self.drain()
        out = {
            "workers": {
                w: {
                    "url": self.workers[w],
                    "state": dict(snap.states).get(w, "unknown"),
                    "occupancy": dict(snap.occupancy).get(w, 0),
                    "compiles": dict(snap.compiles).get(w, 0),
                    "recompiles": dict(snap.recompiles).get(w, 0),
                    "series": dict(snap.series).get(w),
                    "floor_distance": dict(snap.floor_distance).get(w),
                }
                for w in snap.workers
            },
            "totals": snap.totals(),
            "counts": (
                self.registry.counts()
                if self.registry is not None
                else None
            ),
            "worst_burn": (
                {
                    "worker": snap.worst_burn[0][0],
                    "queue": snap.worst_burn[0][1],
                    "state": snap.worst_burn[0][2],
                }
                if snap.worst_burn
                else None
            ),
            "merged_series": snap.merged_series,
            "snapshot_seq": snap.seq,
            "snapshot_digest": snap.digest(),
            "scrape_wall_ms": snap.scrape_wall_ms,
            "errors": [list(e) for e in snap.errors],
            "incidents": {
                "captured": self.incidents.captured_total,
                "retained": len(self.incidents._ring),
            },
        }
        if self.registry is not None:
            out["registry"] = self.registry.summary()
        return out

    def slo_rollup(self) -> dict:
        """The `/fleet/slo` payload: every worker's burn plane plus
        the fleet worst-burn fold."""
        per_worker = {}
        worst = None
        for worker in sorted(self.workers):
            doc = self._client(worker).get_json("/debug/slo")
            per_worker[worker] = doc if doc is not None else {
                "enabled": False, "unreachable": True,
            }
            wb = _worst_burn_of(doc)
            if wb is not None and (
                worst is None
                or _BURN_RANK.get(wb[1], 0) > _BURN_RANK.get(worst[2], 0)
            ):
                worst = (worker, wb[0], wb[1])
        return {
            "workers": per_worker,
            "worst_burn": (
                {"worker": worst[0], "queue": worst[1], "state": worst[2]}
                if worst
                else None
            ),
        }

    def incidents_rollup(self) -> dict:
        """The `/fleet/incidents` payload: every worker's own incident
        index (worker-labeled, over the keep-alive pool) merged with
        the supervisor's FLEET-scope captures. A pre-r19 worker (404
        on `/debug/incidents`) reports `enabled: False` — the hv_top
        degrade discipline, one level down."""
        per_worker: dict[str, dict] = {}
        merged: list[dict] = []
        for worker in sorted(self.workers):
            doc = self._client(worker).get_json("/debug/incidents")
            if doc is None:
                per_worker[worker] = {
                    "enabled": False, "unreachable": True,
                }
                continue
            per_worker[worker] = doc
            for row in doc.get("last") or []:
                merged.append({**row, "worker": worker})
        fleet_rows = [
            {**row, "worker": None}
            for row in self.incidents.index()
        ]
        merged.sort(key=lambda r: (-float(r.get("now") or 0.0), r["id"]))
        return {
            "fleet": self.incidents.summary(),
            "fleet_incidents": fleet_rows,
            "workers": per_worker,
            "merged": fleet_rows + merged,
        }


__all__ = [
    "DEBUG_ENDPOINTS",
    "FleetObservatory",
    "FleetSnapshot",
    "WorkerClient",
    "fetch_json",
    "fetch_text",
    "merge_expositions",
    "sample_series_count",
    "stamp_worker_label",
    "worker_label_coverage",
]
