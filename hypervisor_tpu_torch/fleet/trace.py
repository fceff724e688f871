"""Cross-process trace stitching: worker fragments -> one timeline.

Each worker's `/trace/{session_id}` serves the fragments the local
flight recorder saw for a `CausalTraceId` — Chrome `trace_event` JSON
(default) or OTLP-lite (`?format=otlp`). A request that fans out across
the fleet leaves one fragment per worker; the stitcher merges them into
ONE timeline with worker lanes:

* Chrome: every worker gets its own pid lane (sorted worker order,
  pid 1..N) with a `process_name` metadata event naming the worker —
  Perfetto renders one process row per worker, tracks (tid = wave_seq)
  nested under it.
* OTLP: one `resourceSpans` entry per worker, `service.name` suffixed
  with the worker id and a `hv.worker` resource attribute, so any OTLP
  backend groups spans by worker out of the box.

Stitching is pure text/JSON surgery — no clocks are re-based. Workers
already export wall-anchored timestamps (the tracer's unix clock), so
lanes line up to the accuracy of host NTP, which is what the fleet has
ahead of the shard-out (clock reconciliation is ROADMAP item 1 work).
"""

from __future__ import annotations

import json
import urllib.request
from typing import Mapping, Optional


def fetch_fragment(
    base_url: str,
    trace_id: str,
    fmt: Optional[str] = None,
    timeout_s: float = 5.0,
) -> Optional[dict]:
    """GET one worker's trace fragment; None on 404/error (a worker
    that never served the trace simply has no lane)."""
    url = f"{base_url}/trace/{trace_id}"
    if fmt:
        url += f"?format={fmt}"
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return json.loads(resp.read().decode())
    except Exception:
        return None


def stitch_chrome(fragments: Mapping[str, dict]) -> dict:
    """Merge per-worker Chrome `trace_event` fragments into one
    timeline: worker -> pid lane (1..N in sorted worker order), one
    `process_name` metadata event per lane."""
    events: list[dict] = []
    for lane, worker in enumerate(sorted(fragments), start=1):
        frag = fragments[worker]
        if not frag:
            continue
        events.append({
            "name": "process_name",
            "ph": "M",
            "pid": lane,
            "args": {"name": f"worker:{worker}"},
        })
        for ev in frag.get("traceEvents", ()):
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                continue  # replaced by the worker-named lane metadata
            stitched = dict(ev)
            stitched["pid"] = lane
            events.append(stitched)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def stitch_otlp(fragments: Mapping[str, dict]) -> dict:
    """Merge per-worker OTLP-lite fragments: one `resourceSpans` entry
    per worker, resource re-stamped with the worker identity."""
    resource_spans: list[dict] = []
    for worker in sorted(fragments):
        frag = fragments[worker]
        if not frag:
            continue
        for rs in frag.get("resourceSpans", ()):
            stitched = dict(rs)
            attrs = [
                a for a in stitched.get("resource", {}).get("attributes", ())
                if a.get("key") not in ("service.name", "hv.worker")
            ]
            attrs.extend([
                {
                    "key": "service.name",
                    "value": {"stringValue": f"hypervisor_tpu_torch/{worker}"},
                },
                {"key": "hv.worker", "value": {"stringValue": worker}},
            ])
            stitched["resource"] = {"attributes": attrs}
            resource_spans.append(stitched)
    return {"resourceSpans": resource_spans}


def stitch_fleet_trace(
    workers: Mapping[str, str],
    trace_id: str,
    fmt: Optional[str] = None,
    timeout_s: float = 5.0,
) -> dict:
    """Fetch every worker's fragment for `trace_id` and stitch.

    Returns the merged document plus a `fleet` block naming which
    workers contributed a lane and which had nothing recorded.
    """
    fmt = fmt or "chrome"
    fragments: dict[str, dict] = {}
    missing: list[str] = []
    for worker, base_url in sorted(workers.items()):
        frag = fetch_fragment(
            base_url, trace_id,
            fmt="otlp" if fmt == "otlp" else None,
            timeout_s=timeout_s,
        )
        if frag is None:
            missing.append(worker)
        else:
            fragments[worker] = frag
    if fmt == "otlp":
        doc = stitch_otlp(fragments)
    else:
        doc = stitch_chrome(fragments)
    doc["fleet"] = {
        "trace_id": trace_id,
        "format": fmt,
        "workers": sorted(fragments),
        "missing": missing,
    }
    return doc


__all__ = [
    "fetch_fragment",
    "stitch_chrome",
    "stitch_fleet_trace",
    "stitch_otlp",
]
