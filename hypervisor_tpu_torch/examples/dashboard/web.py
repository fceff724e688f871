"""Browser dashboard over the stdlib HTTP transport — no new deps.

The same five panels (overview, rings, sagas, liability, events) plus the
security and device-occupancy panels the terminal renderer shows, served
as ONE self-contained HTML page from `http.server`. Data comes from the
same `simulate()` world as every other renderer (`app.py` — the
simulator drives the REAL engines on `--device`); the page polls
`/data.json` and the server re-runs the scenario with a rotating seed at
most once per `refresh_s`, so the dashboard is live the same way a
Streamlit rerun is.

Run: `python -m hypervisor_tpu_torch.examples.dashboard.web [--port 8400]`
or   `python -m hypervisor_tpu_torch.examples.dashboard.app --serve 8400`.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path


def _load_app():
    # The sibling module, as the package's own.
    import importlib

    return importlib.import_module("hypervisor_tpu_torch.examples.dashboard.app")


def state_to_json(st) -> dict:
    """DashboardState -> JSON-safe dict (the /data.json payload)."""
    return {
        "stats": dict(st.stats),
        "ring_counts": {str(k): int(v) for k, v in sorted(st.ring_counts.items())},
        "session_rows": [list(r) for r in st.session_rows],
        "saga_rows": [list(r) for r in st.saga_rows],
        "vouch_edges": [list(r) for r in st.vouch_edges],
        "slash_events": [[d, list(c)] for d, c in st.slash_events],
        "risk_rows": [[d, round(float(r), 3), rec] for d, r, rec in st.risk_rows],
        "quarantine_rows": [list(r) for r in st.quarantine_rows],
        "security_rows": [list(r) for r in st.security_rows],
        "elevation_rows": [list(r) for r in st.elevation_rows],
        "lock_rows": [[res, int(n)] for res, n in st.lock_rows],
        "deadlock_info": {
            "cycle": list(st.deadlock_info.get("cycle") or []),
            "victim": st.deadlock_info.get("victim"),
        },
        "device_stats": {k: int(v) for k, v in st.device_stats.items()},
        "events": [
            [str(ts), et.split(".")[-1], did] for ts, et, did in st.events[:40]
        ],
        "generated_at": time.strftime("%H:%M:%S"),
    }


# One self-contained page: palette roles as CSS custom properties (the
# skill-validated reference palette — slot-1 blue is the only series on
# screen, so no legend; status colors are the reserved four and always
# ship icon + label, never color alone), a single-series SVG bar chart
# with 4px rounded data-ends, 2px bar gaps, a per-bar hover tooltip,
# and a table view beside every chart.
PAGE = """<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>hypervisor_tpu_torch dashboard</title>
<style>
  :root { color-scheme: light dark; }
  .viz-root {
    --surface-1: #fcfcfb; --surface-2: #f4f4f2;
    --text-primary: #0b0b0b; --text-secondary: #52514e; --text-muted: #7a786f;
    --series-1: #2a78d6;
    --status-good: #0ca30c; --status-warning: #fab219;
    --status-serious: #ec835a; --status-critical: #d03b3b;
    --grid: #e4e3df; --border: #dedcd6;
  }
  @media (prefers-color-scheme: dark) {
    .viz-root {
      --surface-1: #1a1a19; --surface-2: #232322;
      --text-primary: #ffffff; --text-secondary: #c3c2b7; --text-muted: #8d8b82;
      --series-1: #3987e5;
      --grid: #33332f; --border: #3a3934;
    }
  }
  body { margin: 0; font: 14px/1.45 system-ui, sans-serif; }
  .viz-root { background: var(--surface-1); color: var(--text-primary);
              min-height: 100vh; padding: 18px 22px; }
  h1 { font-size: 17px; margin: 0 0 2px; }
  .sub { color: var(--text-muted); font-size: 12px; margin-bottom: 16px; }
  .grid { display: grid; gap: 14px;
          grid-template-columns: repeat(auto-fit, minmax(330px, 1fr)); }
  .panel { background: var(--surface-2); border: 1px solid var(--border);
           border-radius: 10px; padding: 12px 14px; }
  .panel h2 { font-size: 12px; letter-spacing: .06em; text-transform: uppercase;
              color: var(--text-secondary); margin: 0 0 10px; }
  .tiles { display: grid; grid-template-columns: repeat(3, 1fr); gap: 8px; }
  .tile { padding: 6px 2px; }
  .tile .v { font-size: 24px; font-weight: 650; font-variant-numeric: tabular-nums; }
  .tile .k { font-size: 11px; color: var(--text-muted); }
  table { width: 100%; border-collapse: collapse; font-size: 12.5px; }
  th { text-align: left; color: var(--text-muted); font-weight: 500;
       border-bottom: 1px solid var(--grid); padding: 2px 6px 4px 0; }
  td { padding: 3px 6px 3px 0; border-bottom: 1px solid var(--grid);
       color: var(--text-secondary); font-variant-numeric: tabular-nums; }
  td.id { color: var(--text-primary); }
  .badge { font-size: 11px; white-space: nowrap; }
  .badge::before { content: "● "; }
  .b-good { color: var(--status-good); }
  .b-warning { color: var(--status-warning); }
  .b-serious { color: var(--status-serious); }
  .b-critical { color: var(--status-critical); }
  .feed { max-height: 260px; overflow-y: auto; font-size: 12px; }
  .feed div { padding: 2px 0; border-bottom: 1px solid var(--grid);
              color: var(--text-secondary); }
  .feed .t { color: var(--text-muted); margin-right: 6px;
             font-variant-numeric: tabular-nums; }
  #tooltip { position: fixed; pointer-events: none; display: none;
             background: var(--surface-1); color: var(--text-primary);
             border: 1px solid var(--border); border-radius: 6px;
             padding: 4px 8px; font-size: 12px; box-shadow: 0 2px 8px #0003; }
  svg text { fill: var(--text-secondary); font-size: 11px; }
  svg .val { fill: var(--text-primary); font-weight: 600; }
  svg .gridline { stroke: var(--grid); stroke-width: 1; }
</style></head>
<body><div class="viz-root">
  <h1>hypervisor_tpu_torch — governance dashboard</h1>
  <div class="sub">live simulated world driving the real engines ·
    refreshed <span id="at">…</span></div>
  <div class="grid">
    <div class="panel"><h2>Overview</h2><div class="tiles" id="tiles"></div>
      <table id="sessions"></table></div>
    <div class="panel"><h2>Ring distribution (participants per ring)</h2>
      <svg id="rings" width="100%" height="170" viewBox="0 0 320 170"
           preserveAspectRatio="xMidYMid meet" role="img"
           aria-label="participants per execution ring"></svg>
      <table id="ringtable"></table></div>
    <div class="panel"><h2>Sagas</h2><table id="sagas"></table></div>
    <div class="panel"><h2>Liability</h2><table id="liab"></table></div>
    <div class="panel"><h2>Security</h2><table id="sec"></table></div>
    <div class="panel"><h2>Device plane</h2><table id="dev"></table></div>
    <div class="panel" style="grid-column: 1 / -1;"><h2>Events</h2>
      <div class="feed" id="events"></div></div>
  </div>
  <div id="tooltip"></div>
<script>
const RING_NAMES = {0: "Ring 0 root", 1: "Ring 1 privileged",
                    2: "Ring 2 standard", 3: "Ring 3 sandbox"};
const tooltip = document.getElementById("tooltip");
function showTip(e, html) {
  tooltip.innerHTML = html; tooltip.style.display = "block";
  tooltip.style.left = (e.clientX + 12) + "px";
  tooltip.style.top = (e.clientY - 10) + "px";
}
function hideTip() { tooltip.style.display = "none"; }
function el(tag, attrs, text) {
  const n = document.createElementNS("http://www.w3.org/2000/svg", tag);
  for (const k in attrs) n.setAttribute(k, attrs[k]);
  if (text !== undefined) n.textContent = text;
  return n;
}
function renderRings(counts) {
  const svg = document.getElementById("rings");
  svg.replaceChildren();
  const rings = [0, 1, 2, 3];
  const vals = rings.map(r => counts[r] || 0);
  const max = Math.max(1, ...vals);
  const W = 320, H = 170, padL = 10, padB = 28, padT = 14;
  const bw = (W - padL * 2) / rings.length;
  // recessive horizontal gridlines
  for (let g = 1; g <= 3; g++) {
    const y = padT + (H - padB - padT) * g / 4;
    svg.appendChild(el("line", {x1: padL, x2: W - padL, y1: y, y2: y,
                                class: "gridline"}));
  }
  rings.forEach((r, i) => {
    const h = Math.round((H - padB - padT) * vals[i] / max);
    const x = padL + i * bw + 2, y = H - padB - h;   // 2px gap between bars
    const w = bw - 4;
    // 4px rounded DATA end, square baseline: path with rounded top only
    const rr = Math.min(4, h);
    const d = `M${x},${H - padB} L${x},${y + rr} Q${x},${y} ${x + rr},${y}` +
      ` L${x + w - rr},${y} Q${x + w},${y} ${x + w},${y + rr}` +
      ` L${x + w},${H - padB} Z`;
    const bar = el("path", {d: d, fill: "var(--series-1)"});
    bar.addEventListener("mousemove",
      e => showTip(e, `<b>${RING_NAMES[r]}</b><br>${vals[i]} participant` +
                      (vals[i] === 1 ? "" : "s")));
    bar.addEventListener("mouseleave", hideTip);
    svg.appendChild(bar);
    if (vals[i] > 0)
      svg.appendChild(el("text", {x: x + w / 2, y: y - 4,
                                  "text-anchor": "middle", class: "val"},
                         String(vals[i])));
    svg.appendChild(el("text", {x: x + w / 2, y: H - padB + 14,
                                "text-anchor": "middle"}, "R" + r));
  });
}
function table(id, head, rows) {
  const t = document.getElementById(id);
  t.innerHTML = "<tr>" + head.map(h => `<th>${h}</th>`).join("") + "</tr>" +
    rows.map(r => "<tr>" + r.map((c, i) =>
      `<td class="${i === 0 ? "id" : ""}">${c}</td>`).join("") + "</tr>").join("");
}
function badge(cls, label) { return `<span class="badge b-${cls}">${label}</span>`; }
const SEV = ["good:none", "warning:low", "serious:medium",
             "serious:high", "critical:critical"];
async function refresh() {
  let d;
  try { d = await (await fetch("data.json")).json(); }
  catch (e) { return; }
  document.getElementById("at").textContent = d.generated_at;
  const tiles = document.getElementById("tiles");
  tiles.innerHTML = Object.entries(d.stats).map(([k, v]) =>
    `<div class="tile"><div class="v">${v}</div><div class="k">${k}</div></div>`
  ).join("");
  table("sessions", ["session", "state", "n", "mode"], d.session_rows);
  renderRings(Object.fromEntries(
    Object.entries(d.ring_counts).map(([k, v]) => [parseInt(k), v])));
  table("ringtable", ["ring", "participants"],
    Object.entries(d.ring_counts).map(([k, v]) => [RING_NAMES[k] || k, v]));
  table("sagas", ["workflow", "state", "steps"], d.saga_rows.map(r =>
    [r[0], r[1] === "COMPLETED" ? badge("good", r[1]) :
           r[1] === "COMPENSATED" ? badge("serious", r[1]) :
           r[1] === "ESCALATED" ? badge("critical", r[1]) : r[1], r[2]]));
  table("liab", ["edge / agent", "detail", ""],
    d.vouch_edges.map(r => [r[0] + " → " + r[1], "bond " + r[2], ""])
    .concat(d.slash_events.map(r =>
      [r[0], "clipped: " + (r[1].join(", ") || "—"),
       badge("critical", "slashed")]))
    .concat(d.risk_rows.map(r => [r[0], "risk " + r[1],
      r[2] === "admit" ? badge("good", r[2]) : badge("serious", r[2])])));
  table("sec", ["agent", "anomaly", "breaker"], d.security_rows.map(r => {
    const [cls, label] = (SEV[r[1]] || SEV[0]).split(":");
    return [r[0], badge(cls, label),
            r[2] ? badge("critical", "tripped") : badge("good", "closed")];
  }).concat(d.quarantine_rows.map(r =>
    [r[0], "quarantine: " + r[1],
     r[2] ? badge("serious", "active") : badge("good", "released")])));
  table("dev", ["table", "occupancy"], Object.entries(d.device_stats));
  document.getElementById("events").innerHTML = d.events.map(e =>
    `<div><span class="t">${e[0].slice(11, 19)}</span>${e[1]}` +
    (e[2] ? ` <span class="t">${e[2]}</span>` : "") + "</div>").join("");
}
refresh();
setInterval(refresh, 5000);
</script>
</div></body></html>
"""


class DashboardServer:
    """Threaded stdlib HTTP server for the live dashboard."""

    def __init__(
        self,
        port: int = 0,
        n_sessions: int = 4,
        refresh_s: float = 5.0,
        device="cuda",
    ) -> None:
        self._app = _load_app()
        self._device = device
        self._lock = threading.Lock()
        self._json = b"{}"
        self._built_at = 0.0
        self._seed = 7
        self._n_sessions = n_sessions
        self._refresh_s = refresh_s
        self._rebuilding = False
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self) -> None:
                path = self.path.split("?")[0]
                if path in ("/", "/index.html"):
                    body = PAGE.encode()
                    ctype = "text/html; charset=utf-8"
                elif path == "/data.json":
                    body = outer._payload()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_port
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )

    def _payload(self) -> bytes:
        """Serve the cached snapshot; kick a BACKGROUND rebuild when
        stale. Polls never block on the multi-second engine simulation
        (nor serialize behind each other on the lock while it runs) —
        a poll arriving mid-rebuild just gets the previous world."""
        with self._lock:
            payload = self._json
            stale = time.monotonic() - self._built_at > self._refresh_s
            if stale and not self._rebuilding:
                self._rebuilding = True
                threading.Thread(target=self._rebuild, daemon=True).start()
        return payload

    def _rebuild(self) -> None:
        try:
            # Rotate the seed: each rebuild is a fresh scenario through
            # the real engines — the liveness model of a Streamlit
            # rerun, rate-limited to refresh_s.
            st = asyncio.run(
                self._app.simulate(
                    n_sessions=self._n_sessions, seed=self._seed,
                    device=self._device,
                )
            )
            data = json.dumps(state_to_json(st)).encode()
            with self._lock:
                self._seed += 1
                self._json = data
                self._built_at = time.monotonic()
        finally:
            with self._lock:
                self._rebuilding = False

    def start(self) -> "DashboardServer":
        self._rebuild()  # build the first world before accepting polls
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8400)
    ap.add_argument("--sessions", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the state (cpu on a machine without a card)")
    args = ap.parse_args()
    srv = DashboardServer(port=args.port, n_sessions=args.sessions,
                          device=args.device).start()
    print(f"dashboard: http://127.0.0.1:{srv.port}/  (Ctrl-C to stop)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
