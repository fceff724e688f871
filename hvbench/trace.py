"""The harness's own spans around the calls into each layer, and the
device trace of a short window of whole calls.

`Spans` keeps each span's total host time in memory. In the profiled
window each span also opens a `torch.profiler.record_function` range
named `hvbench.<span>`, so every idle gap on the device can be labelled
with the host span it fell in. The profiled window's device intervals
come from `torch.profiler` (CUPTI): busy time is their union, and the
kernels' time by name feeds the roofline readers.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

#: The span that brackets one whole call; gaps inside no other span are "other".
CALL = "call"


class Spans:
    """Total host milliseconds a span, over everything since `reset`."""

    def __init__(self) -> None:
        self.ms: dict[str, float] = defaultdict(float)
        self.labelled = False

    def reset(self) -> None:
        self.ms.clear()

    @contextlib.contextmanager
    def span(self, name: str):
        rf = contextlib.nullcontext()
        if self.labelled:
            import torch

            rf = torch.profiler.record_function(f"hvbench.{name}")
        t = time.perf_counter_ns()
        try:
            with rf:
                yield
        finally:
            self.ms[name] += (time.perf_counter_ns() - t) / 1e6

    def wrap(self, name: str, fn):
        def call(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return call


def maybe_span(spans: Spans | None, name: str):
    return contextlib.nullcontext() if spans is None else spans.span(name)


@dataclass
class DeviceProfile:
    """One profiled window of whole calls."""

    calls: int
    wall_s: float                 # host clock, from before the first call to the sync after the last
    busy_s: float                 # union of the device's intervals
    ops: dict = field(default_factory=dict)   # device op name -> [seconds, count]
    gaps: dict = field(default_factory=dict)  # host span -> idle seconds of the device


def _union(intervals: list) -> list:
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _label(t: float, spans: list) -> str:
    """The innermost harness span around instant t."""
    best, width = "other", None
    for a, b, name in spans:
        if a <= t <= b and name != CALL and (width is None or b - a < width):
            best, width = name, b - a
    return best


def profile_calls(run_call, n: int, spans: Spans, sync, on_cuda: bool = True) -> DeviceProfile:
    """Run `n` whole calls under `torch.profiler` and read the device
    trace: busy time, time by device op, idle gaps by host span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    spans.labelled = True
    try:
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                with spans.span(CALL):
                    run_call()
            sync()
            wall = time.perf_counter() - t0
    finally:
        spans.labelled = False
    device, host = [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # Kernels, copies and fills; not the ranges that record_function
            # mirrors onto the device's timeline.
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith(
                    ("hvbench.", "hv.")):
                device.append((a, b, e.name))
        elif e.name.startswith("hvbench."):
            host.append((a, b, e.name[len("hvbench."):]))
    ops: dict = {}
    for a, b, name in device:
        entry = ops.setdefault(name, [0.0, 0])
        entry[0] += (b - a) / 1e6
        entry[1] += 1
    merged = _union([(a, b) for a, b, _ in device])
    busy = sum(b - a for a, b in merged) / 1e6
    calls = [(a, b) for a, b, name in host if name == CALL]
    gaps: dict = defaultdict(float)
    if calls and merged:
        lo, hi = min(a for a, _ in calls), max(b for _, b in calls)
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        for i in range(0, len(edges), 2):
            g0, g1 = edges[i], edges[i + 1]
            if g1 > g0:
                gaps[_label((g0 + g1) / 2, host)] += (g1 - g0) / 1e6
    return DeviceProfile(calls=n, wall_s=wall, busy_s=busy, ops=ops, gaps=dict(gaps))


@dataclass
class TraceData:
    """What the per-layer readers read, from one traced run."""

    workload: str
    calls_ms: list                # every call of the measured window, host clock, synchronised
    window_s: float
    spans_ms: dict                # span -> total ms over the measured window
    profile: DeviceProfile | None
    model_s_per_call: float       # modelled least time of the chain and root work a call needs
    kernel_patterns: list         # device-op name fragments of the kernels doing that work
