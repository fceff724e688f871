"""One run of one cell: set-up, the measured window, the traced window,
the comparison with the reference, and the result line.

Everything a cell needs is found by name: the cell in `BENCHMARK.json`,
its configuration in the file the configuration names, its traffic in
`hvbench/traffic/<traffic>.json`, the driver the traffic names in
`hvbench/drivers/`, each per-layer metric in `hvbench/metrics/<name>.py`
and the name fragments of the kernels whose time the roofline readers
divide by in every file under `hvbench/kernels/`. A later cell, mix or
metric is new files and new entries, and no edit.
"""

from __future__ import annotations

import gc
import importlib
import json
import statistics
import sys
import time
from pathlib import Path

from hvbench import work
from hvbench.gen import Sample
from hvbench.trace import Spans, TraceData, profile_calls

def load_bench(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_spec(bench: dict, workload: str, root: Path) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of a workload name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"hvbench: no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((root / "hvbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def kernel_patterns(root: Path) -> list:
    out: list = []
    for f in sorted((root / "hvbench" / "kernels").glob("*.json")):
        out.extend(json.loads(f.read_text())["patterns"])
    return out


def per_layer_metrics(bench: dict, workload: str) -> list:
    return [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]


def model_seconds(work_items: list) -> float:
    """The least time the card needs for this work: the larger of its
    bytes at the memory peak and its integer instructions at the integer
    peak."""
    nbytes = ops = 0
    for name, shapes in work_items:
        b, o = work.kernel_work(name, **shapes)
        nbytes, ops = nbytes + b, ops + o
    return max(nbytes / work.HBM_BYTES_PER_S, ops / work.INT32_INSTRUCTIONS_PER_S)


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, root: Path) -> tuple[dict, dict]:
    """Returns (result line, checks)."""
    import torch

    _, config, traffic = cell_spec(bench, workload, root)
    driver_mod = importlib.import_module(f"hvbench.drivers.{traffic['driver']}")
    spans = Spans() if trace else None
    drv = driver_mod.Driver(config, traffic, seed, device, spans)
    t_setup = time.perf_counter()
    drv.setup()
    setup_s = time.perf_counter() - t_start
    print(json.dumps({"setup_stages_s": {**drv.setup_stages,
                                         "driver_total": time.perf_counter() - t_setup}}),
          file=sys.stderr)
    model_s = model_seconds(drv.roofline_work())

    sample = Sample(int(traffic["check_calls"]), seed)
    if spans is not None:
        spans.reset()
    calls_ms = []
    t0 = time.perf_counter()
    first = drv.calls
    while True:
        c = drv.calls
        calls_ms.append(drv.call())
        if sample.admit(c):
            sample.kept[c] = drv.keep()
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    n_calls = drv.calls - first
    sessions_per_s = n_calls * drv.sessions_per_call / window_s

    on_cuda = torch.device(device).type == "cuda"
    if trace:
        spans_ms = dict(spans.ms)  # the measured window's, before the profiled calls
        profile = profile_calls(drv.call, int(traffic["profile_calls"]), spans, drv.sync, on_cuda)
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    record = drv.collect(sample.kept)
    del drv, sample
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, failed = driver_mod.judge(config, traffic, seed, record, n_calls)
    reference_s = time.perf_counter() - t_ref
    correct = all(v["value"] <= v["limit"] for v in checks.values())

    line: dict = {"correct": correct, "attempted": n_calls, "failed": len(failed)}
    if trace:
        data = TraceData(workload=workload, calls_ms=calls_ms, window_s=window_s,
                         spans_ms=spans_ms, profile=profile,
                         model_s_per_call=model_s,
                         kernel_patterns=kernel_patterns(root))
        metrics = {}
        for m in per_layer_metrics(bench, workload):
            value = importlib.import_module(f"hvbench.metrics.{m['name']}").read(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        line["metrics"] = metrics
    else:
        line["metrics"] = {"sessions_per_s": {"value": sessions_per_s, "unit": "sessions/s"},
                           "setup_s": {"value": setup_s, "unit": "s"}}
    line["device"] = device_info(torch, device, peak)
    if trace:
        line["device"]["busy_s"] = profile.busy_s
        line["device"]["window_s"] = profile.wall_s
        ops = sorted(profile.ops.items(), key=lambda kv: -kv[1][0])[:10]
        line["breakdown"] = {
            "device_ops": [[name[:120], s] for name, (s, _) in ops],
            "idle_gaps": sorted(([k, v] for k, v in profile.gaps.items()),
                                key=lambda kv: -kv[1])[:10]}
        line["device_op_counts"] = {name[:120]: n for name, (_, n) in ops}
        line["traced_sessions_per_s"] = sessions_per_s
        line["spans_ms_per_call"] = {k: v / max(n_calls, 1) for k, v in spans_ms.items()}
        line["profiled_calls"] = profile.calls
    deciles = statistics.quantiles(calls_ms, n=10) if len(calls_ms) > 1 else calls_ms * 9
    line["window"] = {"seconds": window_s, "calls": n_calls, "call_ms_p10": deciles[0],
                      "call_ms_median": statistics.median(calls_ms), "call_ms_p90": deciles[-1],
                      "reference_s": reference_s}
    line["checks"] = checks
    return line, checks


def device_info(torch, device, peak: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": int(peak)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(peak)}
