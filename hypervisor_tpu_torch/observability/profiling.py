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
Ranges cost a `record_function` enter and exit when no capture is
active, so the runtime annotates unconditionally.

Profilers do not nest: a capture refuses (or, for `capture`, becomes a
no-op) while any `torch.profiler` session is on in this process, its own
or another's.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import subprocess
import sys
import threading
import time
from typing import Iterator, Optional

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


def span(name: str):
    """A named range for one wave or op (`torch.profiler.record_function`):
    shows as `name` in a captured trace, and on the card brackets the
    kernels launched inside it."""
    return torch.profiler.record_function(name)


def step_span(name: str, step: int):
    """A range grouping one full governance tick as a profiler step."""
    return torch.profiler.record_function(f"{name}#{int(step)}")


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
                with span("hv.profile_window"):
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


#: The stages currently open on each thread (innermost last): the
#: roofline counter attributes each op it sees to the innermost one.
_stages = threading.local()


def current_stage() -> Optional[str]:
    """The innermost `stage_scope` open on this thread, or None."""
    stack = getattr(_stages, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def stage_scope(name: str) -> Iterator[None]:
    """Names a region INSIDE a wave: a `torch.profiler.record_function`
    range `hv.<name>` (the same vocabulary as the latency histograms,
    `observability.metrics.STAGE_LATENCY`, and the trace stamps), which
    also tells the roofline counter which phase the enclosed ops and
    kernel launches belong to."""
    stack = getattr(_stages, "stack", None)
    if stack is None:
        stack = _stages.stack = []
    stack.append(name)
    try:
        with torch.profiler.record_function(f"hv.{name}"):
            yield
    finally:
        stack.pop()


__all__ = [
    "EXIT_TPU_UNAVAILABLE",
    "capture",
    "capture_window",
    "current_stage",
    "is_active",
    "probe_device_plane",
    "span",
    "start",
    "stage_scope",
    "step_span",
    "stop",
]
