"""The program's own spans (`hypervisor_tpu_torch.observability.profiling`),
read as per-layer figures of one cell, beside the harness's wraps.

The harness reads none of this yet: wiring it in (a driver's
`program_spans()`, a window's totals in `TraceData`, the profiled window's
`hv.*` ranges) is a change to the harness's own files. That change keeps
the pure readers here (`READERS`, `window`, `label_idle`,
`unattributed_share`) for the harness to import, and deletes the loop
below (`run`, `profile_program`, `main`), which the harness's own
`run_cell` and `profile_calls` then replace. Until then

    python3 -m hvbench.program_spans --workload <cell> --seed <n> --seconds <s>

runs one cell as `hvbench.run` does (set-up, a closed loop of calls for
`--seconds`, then the traffic's profiled calls), with the harness's
spans and the program's both on, and prints one JSON line:

  * `program_ms_per_call`: each reading of `READERS` over the window
    (the difference of two `profiling.span_totals()` reads);
  * `twins_ms_per_call`: the harness's own readings of the same layers
    (`staging_ms`, `dispatch_ms`, `gateway_ms`, `audit_booking_ms`);
  * `self_ms_per_call`: self ms a call of every span path;
  * `obs_ms_per_wave`: the telemetry's own spans a fused wave;
  * `counters`: the recorder's counters over the window;
  * `idle_gaps_by_program_span` and `idle_unattributed_share`: the
    profiled window's device idle time by the innermost program span
    open (`label_idle`);
  * `clock_offset_us`: the profiler's `hv.*` ranges less the span
    records of the same spans, at both ends;
  * `span_cost_ns`: one empty span with no profiler on and with one,
    and a bare `record_function` with none.

It needs a CUDA device unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

from hvbench.trace import _union

#: Entry spans: their idle time is a layer's only through their children.
ENTRY_SPANS = ("governance_wave", "governance_pipeline")
#: The label of idle time under no program span, or under an entry's own.
UNATTRIBUTED = "(unattributed)"


def window(before: dict, after: dict) -> dict:
    """`after` less `before`, two `profiling.span_totals()` reads, entry
    by entry; entries that did not move are left out."""
    out: dict = {}
    for group in ("spans", "device", "counters"):
        was, moved = before.get(group, {}), {}
        for key, now in after.get(group, {}).items():
            if isinstance(now, int):
                d = now - was.get(key, 0)
                if d:
                    moved[key] = d
            else:
                d = tuple(a - b for a, b in zip(now, was.get(key, (0,) * len(now))))
                if d[0]:
                    moved[key] = d
        out[group] = moved
    return out


def total_ms(w: dict, suffix: str) -> float | None:
    """Total ms of the span paths that are `suffix` or end in `/suffix`;
    None when none ran in the window."""
    hits = [v[1] for p, v in w["spans"].items() if p == suffix or p.endswith("/" + suffix)]
    return sum(hits) / 1e6 if hits else None


def _per_call(ms: float | None, calls: int) -> float | None:
    return None if ms is None or calls <= 0 else ms / calls


def _dispatch_ms(w: dict) -> float | None:
    """The fused wave's bracket less its gateway, epilogue and upload:
    the twin of the harness's `dispatch_ms`, whose wrap of the wave's
    call leaves the staged columns' copies out (`span_upload_ms`)."""
    wave = total_ms(w, "governance_wave")
    if wave is None:
        return None
    inner = [total_ms(w, f"governance_wave/{c}") for c in ("gateway_wave", "epilogue", "upload")]
    return wave - sum(x or 0.0 for x in inner)


def _sum_ms(w: dict, names) -> float | None:
    parts = [total_ms(w, n) for n in names]
    return None if all(p is None for p in parts) else sum(p or 0.0 for p in parts)


def _obs_ms(w: dict) -> float | None:
    hits = [v[1] for p, v in w["spans"].items() if p.rsplit("/", 1)[-1].startswith("obs.")]
    return sum(hits) / 1e6 if hits else None


def _device_span_ms(w: dict) -> float | None:
    v = w["device"].get("governance_wave")
    return v[1] / v[0] / 1e6 if v else None


#: name -> read(window, calls): the proposed per-layer readings (ms a
#: call; `wave_device_span_ms` is the mean of one wave's device span).
READERS = {
    "span_staging_ms": lambda w, n: _per_call(total_ms(w, "staging"), n),
    "span_dispatch_ms": lambda w, n: _per_call(_dispatch_ms(w), n),
    "span_gateway_ms": lambda w, n: _per_call(total_ms(w, "governance_wave/gateway_wave"), n),
    "span_epilogue_ms": lambda w, n: _per_call(total_ms(w, "governance_wave/epilogue"), n),
    "span_upload_ms": lambda w, n: _per_call(total_ms(w, "governance_wave/upload"), n),
    "span_audit_booking_ms": lambda w, n: _per_call(total_ms(w, "audit_booking"), n),
    "span_wrap_readback_ms": lambda w, n: _per_call(
        total_ms(w, "audit_booking/wrap_readback"), n),
    "span_client_ms": lambda w, n: _per_call(
        _sum_ms(w, ("sessions_create", "vouch_add", "edge_free")), n),
    "span_consensus_ms": lambda w, n: _per_call(total_ms(w, "governance_pipeline/consensus"), n),
    "span_observability_ms": lambda w, n: _per_call(_obs_ms(w), n),
    "wave_device_span_ms": lambda w, n: _device_span_ms(w),
}


def label_idle(busy, ranges, lo: float, hi: float) -> dict:
    """The time in [lo, hi] outside every `busy` interval, split at the
    edges of `ranges` ((start, end, name), properly nested) and labelled
    by the innermost range open; time under no range, or under an entry
    span's own stretch (`ENTRY_SPANS`), is `UNATTRIBUTED`. Returns
    {label: time}, in the inputs' unit."""
    merged = _union([(max(a, lo), min(b, hi)) for a, b in busy if b > lo and a < hi])
    points = {lo, hi}
    for s, e, _ in ranges:
        points.update(x for x in (s, e) if lo < x < hi)
    for a, b in merged:
        points.update((a, b))
    points = sorted(points)
    by_start = sorted(ranges)
    out: dict = defaultdict(float)
    active: list = []
    nxt = busy_i = 0
    for a, b in zip(points, points[1:]):
        m = (a + b) / 2
        while busy_i < len(merged) and merged[busy_i][1] <= m:
            busy_i += 1
        if busy_i < len(merged) and merged[busy_i][0] <= m:
            continue  # the device was busy
        while nxt < len(by_start) and by_start[nxt][0] <= m:
            active.append(by_start[nxt])
            nxt += 1
        active = [r for r in active if r[1] >= m]
        inner = max(active, key=lambda r: (r[0], -r[1]), default=None)
        label = UNATTRIBUTED if inner is None or inner[2] in ENTRY_SPANS else inner[2]
        out[label] += b - a
    return dict(out)


def unattributed_share(gaps: dict) -> float | None:
    """The share of the idle time, in %, that no program span takes."""
    idle = sum(gaps.values())
    return 100.0 * gaps.get(UNATTRIBUTED, 0.0) / idle if idle > 0 else None


def clock_offsets(ranges, records) -> dict | None:
    """The profiler's ranges less the span records of the same spans
    (both (start µs, end µs, name), paired in start order): median, least
    and most offset over both ends. None unless the names pair up."""
    ranges, records = sorted(ranges), sorted(records)
    if not ranges or [r[2] for r in ranges] != [r[2] for r in records]:
        return None
    offs = [x - y for a, b in zip(ranges, records) for x, y in ((a[0], b[0]), (a[1], b[1]))]
    deciles = statistics.quantiles(offs, n=10) if len(offs) > 1 else offs * 9
    return {"pairs": len(ranges), "median": statistics.median(offs), "min": min(offs),
            "p10": deciles[0], "p90": deciles[-1], "max": max(offs)}


def profile_program(run_call, n: int, sync, on_cuda: bool):
    """Run `n` calls under `torch.profiler`, each in a range `hvbench.call`:
    (device intervals, program `hv.*` ranges, the calls' extent) in the
    profiler's µs, and the span records of the window in
    `time.perf_counter` µs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hypervisor_tpu_torch.observability import profiling

    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter_ns() / 1e3
        for _ in range(n):
            with torch.profiler.record_function("hvbench.call"):
                run_call()
        sync()
    device, host, calls = [], [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith(
                    ("hvbench.", "hv.")):
                device.append((a, b))
        elif e.name.startswith("hv."):
            host.append((a, b, e.name[3:]))
        elif e.name == "hvbench.call":
            calls.append((a, b))
    extent = (min(a for a, _ in calls), max(b for _, b in calls))
    records = [(s.start_us, s.end_us, s.stage) for root in profiling.span_trees()
               for s in root.walk() if s.start_us >= t0]
    return device, host, extent, records


def span_cost_ns(n: int = 100_000) -> dict:
    """ns a span with no profiler on and with one (CPU activity), and a
    bare `record_function` with none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hypervisor_tpu_torch.observability import profiling

    def loop(make, k):
        t = time.perf_counter_ns()
        for _ in range(k):
            with make():
                pass
        return (time.perf_counter_ns() - t) / k

    out = {"span_off": loop(lambda: profiling.stage_scope("cost_probe"), n),
           "record_function_off": loop(lambda: torch.profiler.record_function("x"), n)}
    with profile(activities=[ProfilerActivity.CPU]):
        out["span_on"] = loop(lambda: profiling.stage_scope("cost_probe"), n // 10)
    return out


def run(workload: str, seed: int, seconds: float, device: str, root: Path) -> dict:
    import torch

    from hvbench import harness
    from hvbench.trace import Spans
    from hypervisor_tpu_torch.observability import profiling

    bench = harness.load_bench(root)
    _, config, traffic = harness.cell_spec(bench, workload, root)
    driver_mod = importlib.import_module(f"hvbench.drivers.{traffic['driver']}")
    spans = Spans()
    drv = driver_mod.Driver(config, traffic, seed, device, spans)
    drv.setup()
    drv.sync()
    spans.reset()
    before = profiling.span_totals()
    t0, first = time.perf_counter(), drv.calls
    while time.perf_counter() - t0 < seconds:
        drv.call()
    drv.sync()
    window_s = time.perf_counter() - t0
    w = window(before, profiling.span_totals())
    calls = drv.calls - first
    twin = dict(spans.ms)
    twins = {"staging_ms": twin.get("staging"), "gateway_ms": twin.get("gateway"),
             "audit_booking_ms": twin.get("audit_booking"),
             "dispatch_ms": (twin["dispatch"] - twin.get("gateway", 0.0) - twin.get("epilogue", 0.0)
                             if "dispatch" in twin else None)}
    on_cuda = torch.device(device).type == "cuda"
    dev, host, (lo, hi), records = profile_program(drv.call, int(traffic["profile_calls"]),
                                                   drv.sync, on_cuda)
    gaps = label_idle(dev, host, lo, hi)
    waves = w["spans"].get("governance_wave", (0,))[0]
    obs = {p: v[1] / 1e6 / waves for p, v in w["spans"].items()
           if waves and p.rsplit("/", 1)[-1].startswith("obs.")}
    return {
        "workload": workload, "seed": seed,
        "device": torch.cuda.get_device_name(0) if on_cuda else "cpu",
        "calls": calls, "window_s": window_s,
        "sessions_per_s": calls * drv.sessions_per_call / window_s,
        "program_ms_per_call": {k: f(w, calls) for k, f in READERS.items()},
        "twins_ms_per_call": {k: None if v is None else v / calls for k, v in twins.items()},
        "self_ms_per_call": {p: v[2] / 1e6 / calls for p, v in sorted(w["spans"].items())},
        "obs_ms_per_wave": obs, "counters": w["counters"],
        "idle_gaps_by_program_span": {k: v / 1e6 for k, v in sorted(gaps.items(),
                                                                   key=lambda kv: -kv[1])},
        "idle_unattributed_share": unattributed_share(gaps),
        "clock_offset_us": clock_offsets(host, records),
        "span_cost_ns": span_cost_ns(),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="hvbench.program_spans", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("hvbench.program_spans: no CUDA device (pass --device cpu to rehearse)",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    print(json.dumps(run(args.workload, args.seed, args.seconds, args.device, Path.cwd())),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
