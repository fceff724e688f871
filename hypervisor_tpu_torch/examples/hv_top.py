"""hv_top: one-screen live view of the runtime health plane.

The operator's glance: table occupancy (live/capacity/high-water/HBM
bytes), compile telemetry (compiles, recompiles with the argument that
forced them, donation failures), per-stage latency p50/p99, watchdog
stragglers, and the bench trajectory (`BENCH_trajectory.json`) — built
from ONE `/debug/health` + `/metrics` poll per refresh.

Two modes::

    python -m hypervisor_tpu_torch.examples.hv_top  # in-process demo:
        # drives governance waves through a local HypervisorState and
        # renders its health plane (add --watch to refresh until ^C)
    python -m hypervisor_tpu_torch.examples.hv_top --url http://host:8000 --watch
        # poll a running deployment's /debug/health + /metrics
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from hypervisor_tpu_torch.examples._watch_common import (
    build_state,
    drive_round,
    fmt_table,
    watch_loop,
)

#: Counter series the /metrics poll surfaces in the header.
HEADER_COUNTERS = (
    "hv_governance_wave_ticks_total",
    "hv_admission_admitted_total",
    "hv_sessions_archived_total",
)


def parse_prometheus_counters(text: str) -> dict[str, float]:
    """name{labels} -> value for every sample line (counters/gauges)."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        try:
            series, value = line.rsplit(" ", 1)
            out[series] = float(value)
        except ValueError:
            continue
    return out


class UrlPoller:
    """One reused HTTP connection for every poll of a frame.

    A refresh reads 7 endpoints; a `urlopen` each would pay a TCP
    handshake per endpoint per frame. The poller holds ONE
    `http.client.HTTPConnection` across requests AND frames — true
    keep-alive against HTTP/1.1 servers (both transports), and a
    transparent auto-reconnect against HTTP/1.0 servers
    (`will_close` responses drop the socket; the next request
    redials)."""

    def __init__(self, base: str, timeout: float = 10.0) -> None:
        from urllib.parse import urlsplit

        if "://" not in base:
            base = "http://" + base
        u = urlsplit(base.rstrip("/"))
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or (443 if u.scheme == "https" else 80)
        self.timeout = timeout
        self._conn = None

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None

    def get(self, path: str) -> tuple[int, bytes]:
        """GET over the reused connection; one reconnect retry covers
        a server that dropped the idle socket between frames."""
        import http.client

        for attempt in (0, 1):
            try:
                if self._conn is None:
                    self._conn = http.client.HTTPConnection(
                        self.host, self.port, timeout=self.timeout
                    )
                self._conn.request("GET", path)
                resp = self._conn.getresponse()
                body = resp.read()
                if resp.will_close:
                    self.close()
                return resp.status, body
            except OSError:
                self.close()
                if attempt:
                    raise
        raise OSError("unreachable")  # pragma: no cover

    def get_json(self, path: str) -> dict | None:
        """Observatory-panel fetch: 404 (older server), any transport
        error, or garbage JSON all degrade to None — the panel renders
        "n/a", the watch loop never crashes."""
        try:
            status, body = self.get(path)
            if status != 200:
                return None
            return json.loads(body)
        except (OSError, json.JSONDecodeError):
            return None


def poll_url(
    base,
) -> tuple[
    dict, dict[str, float], dict | None, dict | None, dict | None,
    dict | None, dict | None,
]:
    """One (/debug/health, /metrics, /debug/roofline, /debug/tenants,
    /debug/autopilot, /debug/fleet, /debug/incidents) poll against a
    live deployment — all on ONE reused connection (`UrlPoller`; a bare
    URL string still works and builds a throwaway poller). The
    observatory polls degrade gracefully: an older server without an
    endpoint (404) — or any fetch error — renders that panel as "n/a"
    instead of crashing the watch loop."""
    poller = base if isinstance(base, UrlPoller) else UrlPoller(base)
    status, body = poller.get("/debug/health")
    if status != 200:
        raise OSError(f"/debug/health -> HTTP {status}")
    health = json.loads(body)
    status, body = poller.get("/metrics")
    if status != 200:
        raise OSError(f"/metrics -> HTTP {status}")
    counters = parse_prometheus_counters(body.decode())
    roofline = poller.get_json("/debug/roofline")   # an older server: n/a
    tenants = poller.get_json("/debug/tenants")     # an older server: n/a
    autopilot = poller.get_json("/debug/autopilot")  # an older server: n/a
    fleet = poller.get_json("/debug/fleet")         # an older server: n/a
    if fleet:
        # failover + rebalance planes (older servers — or an
        # unattached plane's 503 — render those sub-panels as absent)
        fleet["ownership"] = poller.get_json("/fleet/ownership")
        fleet["rebalance"] = poller.get_json("/fleet/rebalance")
    incidents = poller.get_json("/debug/incidents")  # an older server: n/a
    return health, counters, roofline, tenants, autopilot, fleet, incidents


def poll_state(
    state, tenant_front=None
) -> tuple[
    dict, dict[str, float], dict | None, dict | None, dict | None,
    dict | None, dict | None,
]:
    """The in-process twin of `poll_url` (same payload shapes).
    `tenant_front` (a `tenancy.TenantFrontDoor`) supplies the tenants
    panel; a solo state whose tables live in an arena reports that
    arena's panel automatically."""
    health = state.health_summary()
    counters = parse_prometheus_counters(state.metrics_prometheus())
    try:
        roofline = state.roofline_summary()
    except Exception:  # noqa: BLE001 — panel shows n/a, never crashes
        roofline = None
    tenants = None
    try:
        if tenant_front is not None:
            tenants = tenant_front.summary()
            tenants["enabled"] = True
        else:
            arena = getattr(state, "_tenant_arena", None)
            if arena is not None:
                tenants = arena.summary()
                tenants["enabled"] = True
    except Exception:  # noqa: BLE001 — panel shows n/a, never crashes
        tenants = None
    try:
        autopilot = state.autopilot_summary()
    except Exception:  # noqa: BLE001 — panel shows n/a, never crashes
        autopilot = None
    try:
        incidents = state.incidents_summary()
    except Exception:  # noqa: BLE001 — panel shows n/a, never crashes
        incidents = None
    # The fleet plane is supervisor-side only — an in-process state has
    # no worker fan-out, so the panel reads n/a (as an older server's).
    return health, counters, roofline, tenants, autopilot, None, incidents


def load_trajectory(root: Path) -> list[dict]:
    path = root / "BENCH_trajectory.json"
    if not path.exists():
        return []
    try:
        return json.loads(path.read_text()).get("rounds", [])
    except (OSError, json.JSONDecodeError):
        return []


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:,.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:,.1f} GiB"


def render(
    health: dict,
    counters: dict[str, float],
    trajectory: list[dict],
    roofline: dict | None = None,
    tenants: dict | None = None,
    autopilot: dict | None = None,
    fleet: dict | None = None,
    incidents: dict | None = None,
) -> str:
    lines = [
        f"hv_top @ {time.strftime('%H:%M:%S')}  "
        f"backend={health.get('backend', '?')}  "
        f"uptime={health.get('uptime_s', 0):,.0f}s  "
        + "  ".join(
            f"{name.removeprefix('hv_').removesuffix('_total')}="
            f"{int(counters.get(name, 0)):,}"
            for name in HEADER_COUNTERS
        ),
        "",
    ]

    occ = health.get("occupancy", {})
    rows = []
    for name, row in sorted(occ.get("tables", {}).items()):
        cap = row.get("capacity_rows", 0)
        live = row.get("live_rows")
        rows.append(
            (
                name,
                "-" if live is None else f"{live:,}",
                f"{cap:,}",
                f"{row.get('occupancy', 0) * 100:.1f}%"
                if live is not None
                else "-",
                "-"
                if row.get("high_water_rows") is None
                else f"{row['high_water_rows']:,}",
                _fmt_bytes(row.get("bytes", 0)),
            )
        )
    lines.append(
        f"occupancy  (warn at {occ.get('warn_threshold', 0) * 100:.0f}%, "
        f"{occ.get('warnings_fired', 0)} warning(s) fired)"
    )
    lines += fmt_table(
        rows, header=("table", "live", "capacity", "occ", "hiwater", "hbm")
    )

    c = health.get("compiles", {})
    lines.append("")
    lines.append(
        f"compiles   total={c.get('compiles', 0)}  "
        f"recompiles={c.get('recompiles', 0)}  "
        f"donation_failures={c.get('donation_failures', 0)}  "
        f"wall={c.get('compile_wall_ms', 0):,.0f} ms  "
        f"programs={c.get('programs', 0)}"
    )
    for event in c.get("recent", [])[-3:]:
        changed = "; ".join(event.get("changed", [])) or "first trace"
        lines.append(
            f"  {event['kind']:9s} {event['program']:28s} "
            f"{event['wall_ms']:>9.1f} ms  {changed}"
        )

    lines.append("")
    lines.append("stage latency (host bracket, µs)")
    stage_rows = [
        (stage, f"{row['n']:,}", f"{row['p50_us']:,.1f}",
         f"{row['p99_us']:,.1f}")
        for stage, row in sorted(health.get("stages", {}).items())
    ]
    lines += fmt_table(stage_rows, header=("stage", "n", "p50", "p99"))

    wd = health.get("watchdog", {})
    lines.append("")
    lines.append(
        f"watchdog   k={wd.get('k')}  floor={wd.get('floor_us', 0):,.0f} µs"
        f"  stragglers={wd.get('straggler_count', 0)}"
    )
    for s in wd.get("recent_stragglers", [])[-3:]:
        lines.append(
            f"  {s['stage']:28s} {s['duration_us']:>12,.0f} µs "
            f"(deadline {s['deadline_us']:,.0f})  trace={s['trace_id']}"
        )

    integ = health.get("integrity", {})
    lines.append("")
    if not integ.get("enabled"):
        lines.append("integrity  (plane not attached)")
    else:
        sampling = integ.get("sampling", {})
        repairs = integ.get("repairs", {})
        restores = integ.get("restores", {})
        scrub = integ.get("scrub", {})
        lines.append(
            f"integrity  checks={sampling.get('checks', 0):,} "
            f"(every {sampling.get('every', 0)} dispatches)  "
            f"violations={integ.get('violations_seen', 0):,}  "
            f"repaired={repairs.get('rows_repaired', 0):,}  "
            f"quarantined={repairs.get('rows_quarantined', 0):,}  "
            f"restores={restores.get('count', 0)}"
        )
        size = scrub.get("sweep_size", 0)
        lines.append(
            f"  scrub    {scrub.get('position', 0):,}/{size:,} of sweep "
            f"{scrub.get('sweeps_completed', 0) + 1:,}  "
            f"links={scrub.get('links_verified', 0):,}  "
            f"mismatches={scrub.get('mismatches', 0):,}"
        )
        for row in integ.get("last_violations", [])[-3:]:
            lines.append(
                f"  {row.get('table', '?'):10s} row {row.get('row', -1):>6} "
                f" {', '.join(row.get('checks', []))}"
            )
        last_restore = restores.get("last")
        if last_restore:
            lines.append(
                f"  restored  {last_restore.get('reason', '')[:60]}"
            )

    serving = health.get("serving", {})
    lines.append("")
    if not serving.get("enabled"):
        lines.append("serving    (front door not attached)")
    else:
        shed = serving.get("shed", {})
        shed_str = "  ".join(
            f"{reason}={count}" for reason, count in sorted(shed.items())
        )
        lines.append(
            f"serving    buckets={','.join(str(b) for b in serving.get('buckets', []))}  "
            f"shed_rate={serving.get('shed_rate', 0) * 100:.2f}%  "
            f"deadline_misses={serving.get('deadline_misses', 0):,}  "
            f"pad_lanes={serving.get('padded_lanes', 0):,}"
        )
        lines.append(f"  sheds    {shed_str}")
        q_rows = []
        for name, q in sorted(serving.get("queues", {}).items()):
            last = q.get("last_wave") or {}
            q_rows.append(
                (
                    name,
                    f"{q.get('depth', 0):,}/{q.get('capacity', 0):,}",
                    f"{q.get('enqueued', 0):,}",
                    f"{q.get('served', 0):,}",
                    f"{q.get('waves', 0):,}",
                    f"{q.get('deadline_s', 0) * 1e3:,.0f}ms",
                    "-" if not last else f"{last.get('fill_pct', 0):.0f}%",
                )
            )
        lines += fmt_table(
            q_rows,
            header=(
                "queue", "depth", "enq", "served", "waves", "deadline",
                "fill",
            ),
        )

    lines.append("")
    if not tenants or not tenants.get("enabled"):
        lines.append("tenants    (single-tenant deployment)")
    else:
        last = tenants.get("last_wave") or {}
        lines.append(
            f"tenants    T={tenants.get('num_tenants', 0):,}  "
            f"batched_waves={tenants.get('waves', 0):,}  "
            f"last: {last.get('tenants_served', 0)} tenants @ "
            f"bucket {last.get('bucket', '-')}"
        )
        t_rows = []
        for row in tenants.get("top_k", []):
            burn = row.get("slo_states") or {}
            burning = ",".join(
                f"{q}:{s}" for q, s in sorted(burn.items()) if s != "ok"
            )
            t_rows.append(
                (
                    f"t{row.get('tenant')}",
                    f"{row.get('sessions_live', 0):,}",
                    f"{row.get('members', 0):,}",
                    f"{row.get('queue_depth', 0):,}",
                    f"{row.get('shed_rate', 0) * 100:.2f}%",
                    burning or "ok",
                    f"{row.get('pressure', 0):,}",
                )
            )
        lines += fmt_table(
            t_rows,
            header=(
                "tenant", "sessions", "members", "depth", "shed",
                "burn", "pressure",
            ),
        )

    lines.append("")
    if not autopilot or not autopilot.get("enabled"):
        lines.append("autopilot  n/a (endpoint absent or plane off)")
    else:
        outcomes = autopilot.get("outcomes") or {}
        knobs = autopilot.get("knobs") or {}
        now_k = knobs.get("now") or {}
        static_k = knobs.get("static") or {}
        prewarm = autopilot.get("prewarm") or {}
        digest = autopilot.get("digest") or ""
        lines.append(
            f"autopilot  decisions={autopilot.get('decisions', 0):,}  "
            f"confirmed={outcomes.get('confirmed', 0)}  "
            f"refuted={outcomes.get('refuted', 0)}  "
            f"pending={outcomes.get('pending', 0)}  "
            f"windows={autopilot.get('windows', 0):,}  "
            f"prewarmed={prewarm.get('events', 0)}  "
            f"digest={digest[:12] or '-'}"
        )
        knob_rows = []
        for name in sorted(set(now_k) | set(static_k)):

            def _k(d):
                v = d.get(name)
                if isinstance(v, (list, tuple)):
                    return ",".join(str(x) for x in v)
                return "-" if v is None else str(v)

            cur, base = _k(now_k), _k(static_k)
            knob_rows.append(
                (name, base, cur, "tuned" if cur != base else "")
            )
        lines += fmt_table(
            knob_rows, header=("knob", "static", "now", "")
        )
        for d in (autopilot.get("last") or [])[-4:]:
            outcome = d.get("outcome")
            mark = (
                "?" if outcome is None
                else "+" if outcome.get("ok") else "x"
            )
            lines.append(
                f"  [{mark}] #{d.get('seq')} {d.get('rule', ''):18s} "
                f"{d.get('knob', ''):22s} "
                f"{d.get('before')} -> {d.get('after')}"
            )

    lines.append("")
    if not fleet or not fleet.get("enabled"):
        lines.append("fleet      n/a (endpoint absent or no fleet attached)")
    else:
        counts = fleet.get("counts") or {}
        totals = fleet.get("totals") or {}
        worst = fleet.get("worst_burn")
        lines.append(
            f"fleet      workers={len(fleet.get('workers') or {})}  "
            f"alive={counts.get('alive', '-')}  "
            f"suspected={counts.get('suspected', '-')}  "
            f"dead={counts.get('dead', '-')}  "
            f"series={fleet.get('merged_series', 0):,}  "
            f"worst_burn="
            + (
                f"{worst['worker']}/{worst['queue']}:{worst['state']}"
                if worst else "ok"
            )
            + f"  digest={str(fleet.get('snapshot_digest', ''))[:12] or '-'}"
        )
        f_rows = []
        for name, row in sorted((fleet.get("workers") or {}).items()):
            dist = row.get("floor_distance")
            f_rows.append(
                (
                    name,
                    row.get("state", "?"),
                    f"{row.get('occupancy', 0):,}",
                    f"{row.get('compiles', 0):,}/{row.get('recompiles', 0):,}",
                    "-" if row.get("series") is None
                    else f"{row['series']:,}",
                    "-" if dist is None else f"{dist:,.1f}x",
                )
            )
        f_rows.append(
            (
                "Σ",
                "",
                f"{totals.get('occupancy', 0):,}",
                f"{totals.get('compiles', 0):,}/"
                f"{totals.get('recompiles', 0):,}",
                f"{totals.get('series', 0):,}",
                "",
            )
        )
        lines += fmt_table(
            f_rows,
            header=("worker", "state", "occ", "comp/rec", "series", "floor"),
        )
        own = fleet.get("ownership")
        if own:
            lines.append(
                f"ownership  epoch={own.get('epoch', 0)}  "
                f"transitions={own.get('transition_count', 0):,}  "
                f"digest="
                f"{str(own.get('transition_digest', ''))[:12] or '-'}"
            )
            fenced = own.get("fenced") or {}
            o_rows = []
            for name, rec in sorted((own.get("owners") or {}).items()):
                ts = rec.get("tenants") or []
                o_rows.append(
                    (
                        name,
                        ",".join(str(t) for t in ts) or "-",
                        f"e{rec.get('epoch', 0)}",
                        f"{fenced.get(name, 0)}",
                    )
                )
            lines += fmt_table(
                o_rows,
                header=("worker", "tenants", "epoch", "fence"),
            )
        reb = fleet.get("rebalance")
        if reb:
            inflight = reb.get("inflight") or {}
            plan = reb.get("plan") or {}
            lines.append(
                f"rebalance  inflight={len(inflight)}  "
                f"committed={reb.get('migration_count', 0)}  "
                f"aborted={reb.get('aborted_count', 0)}  "
                f"planned={len(plan.get('proposals') or [])}"
            )
            m_rows = []
            for t, rec in sorted(inflight.items()):
                m_rows.append(
                    (
                        f"t{t}",
                        f"{rec.get('source', '?')}->"
                        f"{rec.get('dest', '?')}",
                        f"e{rec.get('epoch', 0)}",
                        "inflight",
                    )
                )
            for rec in (reb.get("migrations") or [])[-4:]:
                m_rows.append(
                    (
                        f"t{rec.get('tenant')}",
                        f"{rec.get('source')}->{rec.get('dest')}",
                        f"e{rec.get('epoch', 0)}",
                        rec.get("status", "committed"),
                    )
                )
            for rec in (reb.get("aborted") or [])[-4:]:
                m_rows.append(
                    (
                        f"t{rec.get('tenant')}",
                        f"{rec.get('source')}->{rec.get('dest')}",
                        f"e{rec.get('epoch', 0)}",
                        "aborted"
                        + ("/salvaged" if rec.get("salvaged") else ""),
                    )
                )
            if m_rows:
                lines += fmt_table(
                    m_rows,
                    header=("tenant", "route", "epoch", "status"),
                )

    lines.append("")
    if not incidents or not incidents.get("enabled"):
        lines.append("incidents  n/a (endpoint absent or an older server)")
    else:
        lines.append(
            f"incidents  captured={incidents.get('captured', 0):,}  "
            f"suppressed={incidents.get('suppressed', 0):,}  "
            f"evicted={incidents.get('evicted', 0):,}  "
            f"retained={incidents.get('retained', 0)}  "
            f"classes={','.join(incidents.get('classes') or []) or '-'}"
        )
        i_rows = [
            (
                f"#{row.get('seq')}",
                row.get("class", "?"),
                f"{row.get('now', 0):,.1f}",
                _fmt_bytes(row.get("bytes", 0)),
                str(row.get("id", ""))[:12],
            )
            for row in (incidents.get("last") or [])[:4]
        ]
        if i_rows:
            lines += fmt_table(
                i_rows, header=("seq", "class", "now", "bundle", "id")
            )

    slo = health.get("slo", {})
    lines.append("")
    if not slo.get("enabled"):
        lines.append("slo        (latency observatory not armed)")
    else:
        alerts = slo.get("alerts", {})
        attribution = slo.get("attribution", {})
        lines.append(
            "slo        alerts: "
            f"warn={alerts.get('warning', 0)} "
            f"crit={alerts.get('critical', 0)} "
            f"recovered={alerts.get('recovered', 0)}  "
            f"tickets={attribution.get('tickets', 0):,}  "
            f"exemplar_cov={attribution.get('exemplar_coverage', 0) * 100:.0f}%  "
            f"sum_err={attribution.get('max_sum_error_ms', 0):.3f} ms"
        )
        slo_rows = []
        attr_classes = attribution.get("classes", {})
        for name, row in sorted(slo.get("classes", {}).items()):
            comp = attr_classes.get(name, {})

            def _pc(c):
                cell = comp.get(c)
                return "-" if not cell else (
                    f"{cell['p50_ms']:.0f}/{cell['p99_ms']:.0f}"
                )

            slo_rows.append(
                (
                    name,
                    row.get("state", "?"),
                    f"{row.get('burn_fast', 0):.1f}",
                    f"{row.get('burn_slow', 0):.1f}",
                    f"{row.get('good', 0):,}/{row.get('bad', 0):,}",
                    _pc("queue_wait"),
                    _pc("pad_wait"),
                    _pc("wave_wall"),
                )
            )
        lines += fmt_table(
            slo_rows,
            header=(
                "class", "state", "burn5m", "burn1h", "good/bad",
                "queue p50/99", "pad p50/99", "wave p50/99",
            ),
        )

    lines.append("")
    if not roofline or not roofline.get("enabled"):
        lines.append("roofline   n/a (endpoint absent or observatory off)")
    else:
        floor = roofline.get("floor") or {}
        peaks = roofline.get("peaks") or {}
        lines.append(
            f"roofline   peak={peaks.get('peak_bw_gbs', 0):,.0f} GB/s  "
            f"wave floor={floor.get('modeled_floor_us') or '-'} µs  "
            f"measured={floor.get('measured_p50_us') or '-'} µs  "
            f"distance={floor.get('distance') or '-'}x  "
            f"worst={roofline.get('worst_program') or '-'}"
        )
        rl_rows = []
        for name, row in sorted((roofline.get("programs") or {}).items()):
            model = row.get("model") or {}
            mb = model.get("bytes_accessed")
            fl = model.get("flops")
            frac = row.get("achieved_bw_frac")
            rl_rows.append(
                (
                    name,
                    "-" if mb is None else f"{mb / 1e6:,.2f} MB",
                    "-" if fl is None else f"{fl / 1e6:,.1f} M",
                    "-"
                    if row.get("wall_p50_us") is None
                    else f"{row['wall_p50_us']:,.0f}",
                    "-" if frac is None else f"{frac * 100:.2f}%",
                    "-"
                    if row.get("distance") is None
                    else f"{row['distance']:,.0f}x",
                )
            )
        lines += fmt_table(
            rl_rows,
            header=("program", "bytes", "flops", "p50 µs", "bw", "dist"),
        )

    if trajectory:
        lines.append("")
        lines.append("bench trajectory (headline per-op p50, µs)")
        traj_rows = [
            (
                f"r{row['round']:02d}",
                row.get("backend", "?")
                + ("/quick" if row.get("quick") else ""),
                "-"
                if row.get("headline_per_op_us") is None
                else f"{row['headline_per_op_us']:,.4f}",
                row.get("git_commit") or "-",
            )
            for row in trajectory[-6:]
        ]
        lines += fmt_table(
            traj_rows, header=("round", "mode", "per-op", "commit")
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--url", type=str, default=None,
        help="poll a running deployment instead of the in-process demo",
    )
    ap.add_argument("--sessions", type=int, default=64, help="demo lanes/wave")
    ap.add_argument("--rounds", type=int, default=1, help="demo waves/refresh")
    ap.add_argument("--watch", action="store_true", help="refresh until ^C")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the state (cpu on a machine without a card)")
    args = ap.parse_args(argv)

    root = Path(__file__).resolve().parent.parent
    trajectory = load_trajectory(root)

    if args.url:
        poller = UrlPoller(args.url)  # ONE connection across frames

        def frame() -> str:
            (
                health, counters, roofline, tenants, autopilot, fleet,
                incidents,
            ) = poll_url(poller)
            return render(
                health, counters, trajectory, roofline, tenants,
                autopilot, fleet, incidents,
            )

        try:
            return watch_loop(frame, watch=args.watch, interval=args.interval)
        finally:
            poller.close()

    state = build_state(args.sessions * max(args.rounds, 1) + 64, device=args.device)
    # Live integrity panel for the in-process demo: sampled sanitizer +
    # paced scrubbing over the demo traffic.
    from hypervisor_tpu_torch.integrity import IntegrityPlane
    from hypervisor_tpu_torch.serving import FrontDoor, WaveScheduler

    IntegrityPlane(state, every=4, scrub_every=8)
    # Live serving panel: a small front-door stream rides alongside the
    # direct demo waves (lifecycles through the scheduler's bucketed
    # drain, so queue depth / fill / cadence move on screen).
    front = FrontDoor(state)
    scheduler = WaveScheduler(front)
    progress = {"rnd": 0, "driving": True}

    def tick() -> None:
        for _ in range(args.rounds):
            if progress["driving"]:
                progress["driving"] = drive_round(
                    state, args.sessions, progress["rnd"], prefix="top"
                )
            rnd = progress["rnd"]
            now = state.now()
            for i in range(3):
                front.submit_lifecycle(
                    f"top:serve:r{rnd}:{i}",
                    f"did:top:serve:r{rnd}:{i}",
                    0.8,
                    now=now,
                )
            scheduler.tick(now=now + front.config.lifecycle_deadline_s)
            progress["rnd"] += 1

    def frame() -> str:
        (
            health, counters, roofline, tenants, autopilot, fleet,
            incidents,
        ) = poll_state(state)
        return render(
            health, counters, trajectory, roofline, tenants, autopilot,
            fleet, incidents,
        )

    return watch_loop(
        frame, watch=args.watch, interval=args.interval, tick=tick
    )


if __name__ == "__main__":
    sys.exit(main())
