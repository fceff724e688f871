"""Runtime profiling: `torch.profiler` traces + named ranges over waves.

The torch counterpart of `hypervisor_tpu.observability.profiling`: a
process-wide toggle that captures a Chrome trace (viewable in Perfetto or
chrome://tracing) of the host's ops and ranges and, on a CUDA device,
every kernel and copy on the card, plus the `hv.<stage>` ranges the
runtime wraps its waves in.

Usage::

    from hypervisor_tpu_torch.observability import profiling

    with profiling.capture("/tmp/hv_trace"):
        state.run_governance_wave(...)      # traced

    # or manual start/stop around a longer window
    profiling.start("/tmp/hv_trace")
    ...
    profiling.stop()

A trace lands in `log_dir` as `hv_trace.<n>.json` (Chrome trace format).

The runtime's spans (`stage_scope`, the span recorder below) are always
on: each keeps its times in a process-wide ring and in totals by path
(`span_totals`, `span_trees`), and opens its `hv.<name>` range only
while a profiler records. `device_span` times the fused wave on the card
with CUDA events.

Profilers do not nest: a capture refuses (or, for `capture`, becomes a
no-op) while any `torch.profiler` session is on in this process, its own
or another's.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import subprocess
import sys
import threading
import time
import weakref
from collections import deque
from typing import Callable, Iterator, Optional

import torch

_lock = threading.Lock()
_active_dir: Optional[str] = None
_profiler = None
_trace_seq = itertools.count()


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _other_profiler_on() -> bool:
    """True when some `torch.profiler` session is recording on this
    thread (ours or another's)."""
    return bool(torch.autograd._profiler_enabled())


def start(log_dir: str) -> bool:
    """Begin a profiler capture writing to `log_dir`.

    Idempotent: returns True only when THIS call started the trace —
    callers that did not acquire must not stop it. Returns False, and
    starts nothing, while another profiler is on.
    """
    global _active_dir, _profiler
    with _lock:
        if _active_dir is not None or _other_profiler_on():
            return False
        prof = torch.profiler.profile(activities=_activities())
        prof.start()
        _profiler = prof
        _active_dir = log_dir
        return True


def stop() -> Optional[str]:
    """End the active capture and write its Chrome trace; returns the
    trace file's path (or None when no capture was active)."""
    global _active_dir, _profiler
    with _lock:
        if _active_dir is None:
            return None
        prof, log_dir = _profiler, _active_dir
        _profiler, _active_dir = None, None
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"hv_trace.{next(_trace_seq)}.json")
        prof.export_chrome_trace(path)
        return path


def is_active() -> bool:
    return _active_dir is not None


@contextlib.contextmanager
def capture(log_dir: str) -> Iterator[None]:
    """Capture a `torch.profiler` trace for the enclosed block.

    Re-entrancy-safe: a capture nested inside another (or inside a
    profiler someone else started) becomes a no-op instead of truncating
    the outer trace.
    """
    acquired = start(log_dir)
    try:
        yield
    finally:
        if acquired:
            stop()


# ── on-demand capture windows (POST /debug/profile) ──────────────────
# "Give me a trace of the next N milliseconds" without ever hanging the
# serving thread: the device plane is probed in a SUBPROCESS with a hard
# timeout first, and the window itself runs on a worker thread joined
# with a bounded wait, so a wedged driver degrades to a TYPED refusal.
# The worker's profiler records the card's kernels and copies from every
# thread (the device activity is process-wide); of the host's ops it
# records its own thread's, among them the window's `hv.profile_window`
# range.

#: EX_TEMPFAIL — "device plane absent or wedged, skip".
EXIT_TPU_UNAVAILABLE = 75

_capture_lock = threading.Lock()
_capture_thread: Optional[threading.Thread] = None


def _probe_timeout_s() -> float:
    try:
        return float(os.environ.get("HV_PROFILE_PROBE_TIMEOUT", "20"))
    except ValueError:
        return 20.0


def probe_device_plane(backend: Optional[str] = None) -> tuple[bool, str]:
    """Subprocess-bounded liveness probe of the device plane.

    On the CPU there is no device to wedge — trivially healthy. With
    CUDA a child process counts the cards under a hard timeout
    (`HV_PROFILE_PROBE_TIMEOUT`, default 20 s); a hang or nonzero exit
    means the driver is wedged and the caller must refuse instead of
    committing this process to the same hang.
    """
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    if backend == "cpu":
        return True, "cpu backend: no device to probe"
    code = "import torch; torch.cuda.device_count(); raise SystemExit(0)"
    try:
        proc = subprocess.run(
            [sys.executable, "-c", code],
            capture_output=True,
            timeout=_probe_timeout_s(),
        )
    except subprocess.TimeoutExpired:
        return False, (
            f"device-plane probe hung past {_probe_timeout_s():.0f}s "
            f"(wedged driver; exit-{EXIT_TPU_UNAVAILABLE} semantics)"
        )
    except OSError as e:
        return False, f"device-plane probe failed to spawn: {e}"
    if proc.returncode != 0:
        return False, (
            f"device-plane probe exited {proc.returncode} "
            "(driver absent or unhealthy)"
        )
    return True, "device plane healthy"


def capture_window(
    log_dir: str,
    duration_s: float = 0.05,
    *,
    probe: bool = True,
    grace_s: float | None = None,
) -> dict:
    """Capture one bounded `torch.profiler` window into `log_dir`.

    Returns a TYPED result dict — never raises, never hangs:
      {"status": "captured", "dir", "duration_s", "trace"}  on success
      {"status": "refused", "reason": "busy"|"active"|
       "wedged", "detail"}                                  otherwise

    The start/sleep/stop sequence runs on a worker thread joined with
    `duration_s + grace_s`; if the profiler wedges the thread is
    abandoned (daemon) and later captures refuse "busy" until it
    returns. `grace_s` defaults from `HV_PROFILE_GRACE_S` (read per
    call), 30 s: stopping writes the trace, and the grace must bound a
    wedge, not a slow disk. "active" means a trace of `start()` or any
    other `torch.profiler` session is on: a second one never starts.
    """
    global _capture_thread
    if grace_s is None:
        grace_s = float(os.environ.get("HV_PROFILE_GRACE_S", "30"))
    duration_s = min(max(float(duration_s), 0.001), 10.0)
    if probe:
        ok, detail = probe_device_plane()
        if not ok:
            return {"status": "refused", "reason": "wedged",
                    "detail": detail}
    with _capture_lock:
        if _capture_thread is not None and _capture_thread.is_alive():
            return {
                "status": "refused",
                "reason": "busy",
                "detail": "a previous capture window has not returned "
                          "(possibly wedged in the profiler)",
            }
        if is_active() or _other_profiler_on():
            return {
                "status": "refused",
                "reason": "active",
                "detail": "a profiling.start() trace or another "
                          "torch.profiler session is running",
            }
        result: dict = {}

        def _run() -> None:
            acquired = start(log_dir)
            if not acquired:
                result["raced"] = True
                return
            try:
                with torch.profiler.record_function("hv.profile_window"):
                    time.sleep(duration_s)
            finally:
                result["trace"] = stop()
            result["done"] = True

        thread = threading.Thread(
            target=_run, name="hv-profile-capture", daemon=True
        )
        _capture_thread = thread
        thread.start()
    thread.join(duration_s + max(grace_s, 0.0))
    if thread.is_alive():
        return {
            "status": "refused",
            "reason": "wedged",
            "detail": (
                f"profiler did not close the window within "
                f"{duration_s + grace_s:.1f}s — capture thread abandoned "
                "(daemon); further captures refuse busy until it returns"
            ),
        }
    if result.get("raced"):
        return {
            "status": "refused",
            "reason": "active",
            "detail": "another trace started first",
        }
    return {
        "status": "captured",
        "dir": log_dir,
        "duration_s": duration_s,
        "trace": result.get("trace"),
    }


# ── the span recorder ────────────────────────────────────────────────
# One primitive times every named region of the program: `stage_scope`.
# A span keeps its name, its path (its open ancestors' names and its own,
# joined by "/"), its parent, `time.perf_counter_ns()` at entry and exit,
# and the `wave_seq` of the innermost flight-recorder bracket open on its
# thread when it closes (`Tracer.begin_wave` opens one, `end_wave` closes
# it). Closed spans go into a bounded process-wide ring, and running
# totals by path (count, total ns, self ns: the duration less its direct
# children's) last for the life of the process. A
# `record_function("hv.<name>")` range opens only while a profiler
# records, so that the spans sit on the device trace's clock then; with
# no profiler on, a span costs two clock reads and a few dictionary
# updates.

#: Span records the ring keeps; the oldest go first.
SPAN_RING = 16_384

_tls = threading.local()   # .stack: open spans; .waves: weak refs to open brackets
_span_lock = threading.Lock()
#: (id, parent id, name, path, start ns, end ns, wave_seq) of each closed span.
_ring: deque = deque(maxlen=SPAN_RING)
_totals: dict[str, list[int]] = {}   # path -> [count, total ns, self ns]
_counters: dict[str, int] = {}
_span_ids = itertools.count(1)
#: The recorder's clock (ns): every span and flight-recorder bracket reads it.
now_ns = time.perf_counter_ns


def _thread_state() -> list:
    """This thread's open spans, made with its open brackets on first use."""
    _tls.waves = []
    stack = _tls.stack = []
    return stack


class stage_scope:
    """Context manager: one span named `name` (the recorder above). Inside
    a wave the names are the stages of the latency histograms
    (`observability.metrics.STAGE_LATENCY`) and of the trace stamps, and
    the innermost open span tells the roofline counter which phase the
    enclosed ops and kernel launches belong to (`current_stage`). `ns`
    holds the duration once the span has closed."""

    __slots__ = ("name", "path", "parent", "id", "child_ns", "t0", "ns", "_rf")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "stage_scope":
        try:
            stack = _tls.stack
        except AttributeError:
            stack = _thread_state()
        parent = stack[-1] if stack else None
        self.parent = parent
        self.path = self.name if parent is None else f"{parent.path}/{self.name}"
        self.id = next(_span_ids)
        self.child_ns = 0
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(f"hv.{self.name}")
            self._rf.__enter__()
        stack.append(self)
        self.t0 = now_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = now_ns()
        _tls.stack.remove(self)
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
        t0, parent = self.t0, self.parent
        ns = self.ns = t1 - t0
        if parent is not None:
            parent.child_ns += ns
        wave_seq = None
        waves = _tls.waves
        if waves:
            for ref in waves:
                record = ref()
                if record is not None:
                    record.phases[self.name] = (t0, t1)
                    wave_seq = record.wave_seq
        _span_lock.acquire()
        _ring.append((self.id, None if parent is None else parent.id, self.name, self.path,
                      t0, t1, wave_seq))
        tot = _totals.get(self.path)
        if tot is None:
            tot = _totals[self.path] = [0, 0, 0]
        tot[0] += 1
        tot[1] += ns
        tot[2] += ns - self.child_ns
        _span_lock.release()


def scoped(name: str) -> Callable:
    """Decorator: the function runs inside `stage_scope(name)`."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with stage_scope(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def current_stage() -> Optional[str]:
    """The name of the innermost span open on this thread, or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1].name if stack else None


def count(name: str, n: int = 1) -> None:
    """Add `n` to the recorder's counter `name`."""
    with _span_lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def open_wave(record) -> None:
    """Open a flight-recorder bracket on this thread. Until `close_wave`,
    every span that closes on the thread carries `record.wave_seq` and
    writes its (start ns, end ns) into `record.phases` under its name
    (the last close of a name wins). Brackets nest (a tenant wave opens
    one a tenant around one dispatch); one whose record is gone (its
    wave raised before `end_wave`) drops out. The bracket's open and
    close on the recorder's clock go into `record.bracket_ns`."""
    try:
        waves = _tls.waves
    except AttributeError:
        _thread_state()
        waves = _tls.waves
    waves[:] = [r for r in waves if r() is not None]
    waves.append(weakref.ref(record))
    record.bracket_ns[0] = now_ns()


def close_wave(record) -> None:
    """Close the bracket `open_wave(record)` opened on this thread."""
    record.bracket_ns[1] = now_ns()
    waves = getattr(_tls, "waves", None)
    if waves:
        waves[:] = [r for r in waves if r() is not None and r() is not record]


# ── the wave's device span ───────────────────────────────────────────

#: Event pairs waiting on the device at most; a wave past that goes untimed.
DEVICE_PENDING = 64
#: Resolved device spans kept a name, for `device_span_quantile`.
DEVICE_RECENT = 256

_dev_lock = threading.Lock()
_dev_free: list = []          # (start, end) event pairs to reuse
_dev_pending: deque = deque()  # (name, start, end), in the order recorded
_dev_totals: dict[str, list[int]] = {}   # name -> [count, total ns]
_dev_recent: dict[str, deque] = {}


class device_span:
    """Context manager: a CUDA event pair recorded on `device`'s current
    stream at entry and at exit, taken from a reused pool and never
    waited on here; `resolve_device_spans` reads it later. On a CPU
    device it records nothing."""

    __slots__ = ("name", "device", "stream", "pair")

    def __init__(self, name: str, device: torch.device) -> None:
        self.name, self.device, self.pair = name, device, None

    def __enter__(self) -> "device_span":
        if self.device.type != "cuda":
            return self
        resolve_device_spans()
        with _dev_lock:
            if len(_dev_pending) >= DEVICE_PENDING:
                return self
            pair = _dev_free.pop() if _dev_free else None
        if pair is None:
            pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        self.stream = torch.cuda.current_stream(self.device)
        pair[0].record(self.stream)
        self.pair = pair
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.pair is None:
            return
        self.pair[1].record(self.stream)
        with _dev_lock:
            _dev_pending.append((self.name, *self.pair))
        self.pair = None


def resolve_device_spans() -> int:
    """Read every recorded event pair the device has passed, oldest
    first, into the device totals (`query`, then `elapsed_time`: no
    wait); returns how many. Runs at each `device_span` entry and at the
    metrics drain."""
    n = 0
    with _dev_lock:
        while _dev_pending:
            name, start, end = _dev_pending[0]
            if not end.query():
                break
            _dev_pending.popleft()
            ns = int(start.elapsed_time(end) * 1e6)
            tot = _dev_totals.setdefault(name, [0, 0])
            tot[0] += 1
            tot[1] += ns
            _dev_recent.setdefault(name, deque(maxlen=DEVICE_RECENT)).append(ns)
            _dev_free.append((start, end))
            n += 1
    return n


def device_span_quantile(name: str, q: float) -> tuple[int, float]:
    """(samples, quantile µs) over the last `DEVICE_RECENT` resolved
    device spans of `name`; (0, 0.0) when there are none."""
    with _dev_lock:
        xs = sorted(_dev_recent.get(name, ()))
    if not xs:
        return 0, 0.0
    return len(xs), xs[min(int(q * len(xs)), len(xs) - 1)] / 1e3


# ── reading the recorder ─────────────────────────────────────────────


def span_totals() -> dict:
    """The recorder's running totals, after resolving what the device has
    passed: `spans` {path: (count, total ns, self ns)}, `device` {name:
    (count, total ns)} and `counters` {name: n}. A window's figures are
    the difference of two reads."""
    resolve_device_spans()
    with _span_lock:
        spans = {path: tuple(v) for path, v in _totals.items()}
        counters = dict(_counters)
    with _dev_lock:
        device = {name: tuple(v) for name, v in _dev_totals.items()}
    return {"spans": spans, "device": device, "counters": counters}


def span_trees() -> list:
    """The ring's records as `tracing.Span` trees (µs of
    `time.perf_counter`), for `tracing.to_chrome_trace` and
    `tracing.to_otlp`. A span whose parent has left the ring is a root."""
    from hypervisor_tpu_torch.observability.tracing import Span

    with _span_lock:
        records = sorted(_ring, key=lambda r: r[4])
    nodes = {}
    roots = []
    for sid, parent, name, _path, t0, t1, wave_seq in records:
        nodes[sid] = node = Span(
            name=f"hv.{name}", stage=name, trace_id="", span_word=sid & 0xFFFFFFFF,
            parent_span_word=None if parent is None else parent & 0xFFFFFFFF,
            start_us=t0 / 1e3, end_us=t1 / 1e3, wave_seq=-1 if wave_seq is None else wave_seq)
    for sid, parent, *_ in records:
        up = nodes.get(parent)
        (roots if up is None else up.children).append(nodes[sid])
    return roots


def reset_spans() -> None:
    """Test hook: drop every record, total, counter and device span."""
    with _span_lock:
        _ring.clear()
        _totals.clear()
        _counters.clear()
    with _dev_lock:
        _dev_pending.clear()
        _dev_totals.clear()
        _dev_recent.clear()

__all__ = [
    "EXIT_TPU_UNAVAILABLE",
    "capture",
    "capture_window",
    "close_wave",
    "count",
    "current_stage",
    "device_span",
    "device_span_quantile",
    "is_active",
    "now_ns",
    "open_wave",
    "probe_device_plane",
    "resolve_device_spans",
    "scoped",
    "span_totals",
    "span_trees",
    "stage_scope",
    "start",
    "stop",
]
