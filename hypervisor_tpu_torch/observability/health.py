"""Runtime health plane: compile telemetry, device-memory occupancy, the
wave watchdog.

The torch counterpart of `hypervisor_tpu.observability.health`. The
metrics plane answers "how is the fleet doing" and the flight recorder
answers "what happened to THIS wave"; this module watches the three
things that silently destroy the latency and scale envelope without
either plane noticing:

  * **Compile telemetry** — `CompileWatch` wraps the module-level
    dispatch entries of the port (`hypervisor_tpu_torch.state` and the
    integrity plane instrument them through `instrument()`). The port
    has no jit cache, so every dispatch takes the reference's keyed
    path: it is keyed by its abstract signature (argument structure,
    per-leaf shape and dtype, static argument values), and a novel key
    counts as one compile: the dispatch is timed, and its signature is
    diffed against the previous one to NAME the argument that forced
    the recompile. A kernel library that `kernels/_build.py` builds or
    loads during any dispatch is timed into `compile_wall_ms` too. The
    port updates its tables in place, so `donation_failures` stays 0.
    The watch state is process-global; totals republish into each
    deployment's metrics plane at drain (`publish_compile_counters`)
    and recompile events fan out to subscribed `HealthMonitor`s.
  * **Device-memory occupancy accounting** — every table and ring
    reports through one `footprint()` protocol
    (`tables.struct.footprint`): bytes and capacity are tensor metadata
    (no transfer); live rows ride the drain's one read as gauges
    (`metrics.update_gauges`); `HealthMonitor.update_occupancy` tracks
    high-water marks and emits a capacity event when a table crosses the
    warn threshold — BEFORE a ring wraps or a table saturates.
  * **Wave watchdog** — the host already brackets every dispatch with a
    `CausalTraceId` (`tracing.Tracer`); `HealthMonitor.observe_wave`
    hooks that bracket and compares each wave's wall clock against a
    soft deadline derived from the stage's OWN latency histogram
    (host-plane p99 × k, floored). Overruns emit a straggler event
    carrying the trace id.

Everything here is HOST-side: nothing in this module launches device
work.

Knobs (env, read at monitor construction): `HV_WATCHDOG_K` (deadline
multiplier, default 4.0), `HV_WATCHDOG_FLOOR_US` (deadline floor,
default 50000), `HV_WATCHDOG_MIN_SAMPLES` (histogram samples before the
watchdog arms, default 32), `HV_OCC_WARN` (occupancy warn threshold,
default 0.85).
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import os
import threading
import time
import weakref
from collections import deque
from typing import Callable, Iterable, Mapping, Optional

import numpy as np
import torch

from hypervisor_tpu_torch.observability import metrics as metrics_plane
from hypervisor_tpu_torch.observability import profiling

# ── compile telemetry ────────────────────────────────────────────────


@dataclasses.dataclass(frozen=True)
class CompileEvent:
    """One compile (a novel signature) of a watched program."""

    program: str
    kind: str                  # "compile" (first trace) | "recompile"
    wall_ms: float
    at: float                  # unix seconds
    changed: tuple[str, ...]   # argument diffs that forced a recompile
    donation_failed: bool

    def to_dict(self) -> dict:
        return {
            "program": self.program,
            "kind": self.kind,
            "wall_ms": round(self.wall_ms, 3),
            "at": self.at,
            "changed": list(self.changed),
            "donation_failed": self.donation_failed,
        }


def _flatten(value, leaves: list):
    """Structure of one argument, appending its leaves: tensors and
    arrays are leaves; tuples, lists, dicts and dataclasses (the tables,
    the wave's configs) recurse; anything else is a leaf."""
    if isinstance(value, (torch.Tensor, np.ndarray)):
        leaves.append(value)
        return "*"
    if isinstance(value, (tuple, list)):
        return (type(value).__name__, tuple(_flatten(v, leaves) for v in value))
    if isinstance(value, dict):
        return ("dict", tuple((k, _flatten(value[k], leaves)) for k in sorted(value)))
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return (type(value).__name__, tuple(
            _flatten(getattr(value, f.name), leaves) for f in dataclasses.fields(value)))
    leaves.append(value)
    return "*"


def _tree_leaves(value) -> list:
    leaves: list = []
    _flatten(value, leaves)
    return leaves


def _leaf_key(leaf) -> tuple:
    """Hashable abstract key for one leaf: shape+dtype for tensors and
    arrays, bare type for Python scalars (a scalar's VALUE never keys a
    signature — `now` changes every dispatch)."""
    shape = getattr(leaf, "shape", None)
    if shape is not None:
        return (tuple(shape), str(getattr(leaf, "dtype", "?")))
    return (type(leaf).__name__,)


def _leaf_summary(leaf) -> str:
    shape = getattr(leaf, "shape", None)
    if shape is not None:
        dtype = str(getattr(leaf, "dtype", "?")).removeprefix("torch.")
        return f"{dtype}[{','.join(str(d) for d in shape)}]"
    return type(leaf).__name__


@contextlib.contextmanager
def _roofline_count():
    """The roofline observatory's count of one first dispatch
    (`roofline.counting`), or None when the observatory is off or fails
    to start one: the dispatch itself always runs."""
    try:
        from hypervisor_tpu_torch.observability import roofline

        ctx = roofline.counting()
        count = ctx.__enter__()
    except Exception:  # noqa: BLE001 — observability never raises
        yield None
        return
    try:
        yield count
    finally:
        ctx.__exit__(None, None, None)


class CompileWatch:
    """Thin host wrapper around one dispatch entry point.

    `__call__` passes straight through to the wrapped callable, keyed by
    the call's abstract signature (the reference's keyed path: the port
    has no jit cache to probe). A novel signature is one compile: the
    call is timed, and only then are argument names bound, leaves
    summarized and the signature diffed against the previous compile's
    to name what forced this one. Kernel builds during any call add
    their wall time to `compile_wall_ms` (`kernels._build.load_wall_ms`).
    """

    def __init__(
        self,
        name: str,
        fn: Callable,
        static_argnames: Iterable[str] = (),
    ) -> None:
        self.name = name
        self._fn = fn
        self._static = frozenset(static_argnames)
        self._lock = threading.Lock()
        self._keys: set = set()
        self._last_detail: Optional[list[tuple[str, str]]] = None
        self.compiles = 0
        self.recompiles = 0
        self.donation_failures = 0
        self.compile_wall_ms = 0.0
        self.last_event: Optional[CompileEvent] = None

    # -- signature machinery --------------------------------------------

    def _sig_key(self, args, kwargs):
        static_kv = tuple(
            (k, kwargs[k]) for k in sorted(self._static) if k in kwargs
        )
        dyn_kwargs = {k: v for k, v in kwargs.items() if k not in self._static}
        leaves: list = []
        treedef = _flatten((args, dyn_kwargs), leaves)
        return (treedef, static_kv, tuple(_leaf_key(l) for l in leaves))

    def _sig_detail(self, args, kwargs) -> list[tuple[str, str]]:
        """[(argument name, abstract summary)] in call order — computed
        only on the slow path, so binding cost never rides a cache hit."""
        named: list[tuple[str, object]]
        try:
            bound = inspect.signature(self._fn).bind_partial(*args, **kwargs)
            named = list(bound.arguments.items())
        except (TypeError, ValueError):
            named = [(f"arg{i}", a) for i, a in enumerate(args)]
            named += sorted(kwargs.items())
        detail = []
        for name, value in named:
            if name in self._static:
                detail.append((name, f"static:{value!r}"))
                continue
            leaves = _tree_leaves(value)
            if not leaves:
                detail.append((name, repr(value)))
                continue
            parts = [_leaf_summary(l) for l in leaves[:4]]
            if len(leaves) > 4:
                parts.append(f"+{len(leaves) - 4} more")
            prefix = type(value).__name__
            if prefix in ("Tensor", "ndarray") and len(leaves) == 1:
                detail.append((name, parts[0]))
            else:
                detail.append((name, f"{prefix}({' '.join(parts)})"))
        return detail

    @staticmethod
    def _diff(prev, cur) -> tuple[str, ...]:
        if prev is None:
            return ()
        before = dict(prev)
        changed = []
        for name, summary in cur:
            old = before.get(name, "<absent>")
            if old != summary:
                changed.append(f"{name}: {old} -> {summary}")
        for name, summary in prev:
            if name not in dict(cur):
                changed.append(f"{name}: {summary} -> <absent>")
        return tuple(changed)

    # -- dispatch -------------------------------------------------------

    def __call__(self, *args, **kwargs):
        """Novel abstract signatures are detected by key (the key and its
        lookup timed as the span `obs.compile_key`); a hit only books the
        wall time of a kernel build it ran into."""
        from hypervisor_tpu_torch.kernels import _build

        with profiling.stage_scope("obs.compile_key"):
            key = self._sig_key(args, kwargs)
            with self._lock:
                hit = key in self._keys
        if hit:
            built = _build.load_wall_ms
            out = self._fn(*args, **kwargs)
            built = _build.load_wall_ms - built
            if built:
                with self._lock:
                    self.compile_wall_ms += built
            return out
        t0 = time.perf_counter()
        with _roofline_count() as count:
            out = self._fn(*args, **kwargs)
        wall_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            first = not self._keys
            self._keys.add(key)
        self._record(args, kwargs, wall_ms, first=first, count=count, out=out)
        return out

    def _record(self, args, kwargs, wall_ms, first: bool, count=None, out=None) -> None:
        """Book one compile (the rare path: binding argument names and
        diffing summaries only happens here). Nothing is donated, so no
        compile fails a donation. The roofline observatory takes the
        dispatch's count (`count`, from `roofline.counting`)."""
        detail = self._sig_detail(args, kwargs)
        with self._lock:
            changed = () if first else self._diff(self._last_detail, detail)
            self._last_detail = detail
            kind = "compile" if first else "recompile"
            self.compiles += 1
            if not first:
                self.recompiles += 1
            self.compile_wall_ms += wall_ms
            event = CompileEvent(
                program=self.name,
                kind=kind,
                wall_ms=wall_ms,
                at=time.time(),
                changed=changed,
                donation_failed=False,
            )
            self.last_event = event
        # Roofline observatory intake (`observability.roofline`): every
        # compile queues the modeled work its first dispatch counted; the
        # model resolves off the dispatch path, at the metrics drain.
        # Exception-proof: the observatory must never take down the
        # dispatch that compiled.
        try:
            from hypervisor_tpu_torch.observability import roofline

            roofline.note_compile(
                self.name, count, args, kwargs, out, detail=detail, wall_ms=wall_ms,
            )
        except Exception:  # noqa: BLE001 — observability never raises
            pass
        _LOG.record(event)

    def stats(self) -> dict:
        with self._lock:
            return {
                "program": self.name,
                "compiles": self.compiles,
                "recompiles": self.recompiles,
                "donation_failures": self.donation_failures,
                "compile_wall_ms": round(self.compile_wall_ms, 3),
                "signatures": len(self._keys),
                "last": (
                    self.last_event.to_dict()
                    if self.last_event is not None
                    else None
                ),
            }


class _CompileLog:
    """Process-global aggregate over every `CompileWatch`.

    Global on purpose: the module-level dispatch entries the watches
    wrap are shared by every `HypervisorState` in the process. Deployments
    republish the totals into their own metrics plane at drain, and
    `HealthMonitor`s subscribe (weakly — monitors die with their
    states) for recompile events.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._watches: dict[str, CompileWatch] = {}
        self._events: deque[CompileEvent] = deque(maxlen=256)
        self._subscribers: list[weakref.ref] = []

    def register(self, watch: CompileWatch) -> None:
        with self._lock:
            self._watches[watch.name] = watch

    def subscribe(self, monitor: "HealthMonitor") -> None:
        with self._lock:
            self._subscribers.append(weakref.ref(monitor))

    def record(self, event: CompileEvent) -> None:
        with self._lock:
            self._events.append(event)
            live = []
            targets = []
            for ref in self._subscribers:
                monitor = ref()
                if monitor is not None:
                    live.append(ref)
                    targets.append(monitor)
            self._subscribers = live
        for monitor in targets:
            monitor._on_compile(event)

    def totals(self) -> dict:
        with self._lock:
            watches = list(self._watches.values())
        totals = {
            "programs": len(watches),
            "compiles": 0,
            "recompiles": 0,
            "donation_failures": 0,
            "compile_wall_ms": 0.0,
        }
        for w in watches:
            s = w.stats()
            totals["compiles"] += s["compiles"]
            totals["recompiles"] += s["recompiles"]
            totals["donation_failures"] += s["donation_failures"]
            totals["compile_wall_ms"] += s["compile_wall_ms"]
        totals["compile_wall_ms"] = round(totals["compile_wall_ms"], 3)
        return totals

    def summary(self, last: int = 32) -> dict:
        with self._lock:
            watches = sorted(self._watches)
            events = list(self._events)[-last:]
        return {
            **self.totals(),
            "by_program": [self._watches[n].stats() for n in watches],
            "recent": [e.to_dict() for e in events],
        }


_LOG = _CompileLog()


def instrument(
    name: str, fn: Callable, static_argnames: Iterable[str] = ()
) -> CompileWatch:
    """Wrap one dispatch entry point in compile telemetry and register it
    with the process-global log."""
    watch = CompileWatch(name, fn, static_argnames)
    _LOG.register(watch)
    return watch


def compile_summary(last: int = 32) -> dict:
    """The `GET /debug/compiles` payload."""
    return _LOG.summary(last)


def publish_compile_counters(metrics: "metrics_plane.Metrics") -> None:
    """Republish the global compile totals into one deployment's
    metrics plane as absolute host counters (drain-time, host-only)."""
    t = _LOG.totals()
    metrics.counter_set(metrics_plane.COMPILES, t["compiles"])
    metrics.counter_set(metrics_plane.RECOMPILES, t["recompiles"])
    metrics.counter_set(
        metrics_plane.DONATION_FAILURES, t["donation_failures"]
    )
    metrics.counter_set(
        metrics_plane.COMPILE_WALL_MS, int(t["compile_wall_ms"])
    )


# ── watchdog + occupancy monitor ─────────────────────────────────────


@dataclasses.dataclass(frozen=True)
class StragglerEvent:
    """One wave that overran its watchdog deadline."""

    stage: str
    trace_id: str
    wave_seq: int
    duration_us: float
    deadline_us: float
    at: float

    def to_dict(self) -> dict:
        return {
            "stage": self.stage,
            "trace_id": self.trace_id,
            "wave_seq": self.wave_seq,
            "duration_us": round(self.duration_us, 1),
            "deadline_us": round(self.deadline_us, 1),
            "at": self.at,
        }


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


class HealthMonitor:
    """One deployment's health plane: watchdog, occupancy, event fan-out.

    Listeners receive `(kind, payload)` with kind in {"straggler",
    "capacity", "recompile"}; the facade maps them onto event-bus
    events (`EventType.WAVE_STRAGGLER` / `CAPACITY_WARNING` /
    `RECOMPILE`). Listener exceptions are swallowed — health reporting
    must never take down a dispatch path.
    """

    def __init__(
        self,
        metrics: "metrics_plane.Metrics",
        *,
        k: Optional[float] = None,
        floor_us: Optional[float] = None,
        min_samples: Optional[int] = None,
        occupancy_warn: Optional[float] = None,
    ) -> None:
        self.metrics = metrics
        self.k = k if k is not None else _env_float("HV_WATCHDOG_K", 4.0)
        self.floor_us = (
            floor_us
            if floor_us is not None
            else _env_float("HV_WATCHDOG_FLOOR_US", 50_000.0)
        )
        self.min_samples = (
            min_samples
            if min_samples is not None
            else int(_env_float("HV_WATCHDOG_MIN_SAMPLES", 32))
        )
        self.occupancy_warn = (
            occupancy_warn
            if occupancy_warn is not None
            else _env_float("HV_OCC_WARN", 0.85)
        )
        self.started_at = time.time()
        self._lock = threading.Lock()
        self._listeners: list[Callable[[str, dict], None]] = []
        self.straggler_count = 0
        self.stragglers: deque[StragglerEvent] = deque(maxlen=64)
        self.capacity_warning_count = 0
        self.capacity_events: deque[dict] = deque(maxlen=64)
        self._high_water: dict[str, float] = {}
        self._footprints: dict[str, dict] = {}
        self._warn_armed: dict[str, bool] = {}
        _LOG.subscribe(self)

    # -- event fan-out --------------------------------------------------

    def add_listener(self, fn: Callable[[str, dict], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def _fire(self, kind: str, payload: dict) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(kind, payload)
            except Exception:  # noqa: BLE001 — reporting must not raise
                pass

    def emit_event(self, kind: str, payload: dict) -> None:
        """Public fan-out for co-resident planes: the resilience
        supervisor publishes its degraded-mode transitions and retry
        events through the SAME listener set the watchdog uses, so the
        facade's one health->bus bridge covers both planes."""
        self._fire(kind, payload)

    def _on_compile(self, event: CompileEvent) -> None:
        """Compile-log subscription: recompiles and donation failures
        are operator-visible events; first traces are routine."""
        if event.kind == "recompile" or event.donation_failed:
            self._fire("recompile", event.to_dict())

    # -- watchdog -------------------------------------------------------

    def deadline_us(self, stage: str) -> Optional[float]:
        """Soft deadline for one stage: host-plane p99 × k, floored —
        None while the stage's histogram holds too few samples (the
        watchdog never pages off a cold distribution)."""
        handle = metrics_plane.STAGE_LATENCY.get(stage)
        if handle is None:
            return None
        n, p99 = self.metrics.host_quantile(handle, 0.99)
        if n < self.min_samples:
            return None
        return max(p99 * self.k, self.floor_us)

    def observe_wave(self, record) -> Optional[StragglerEvent]:
        """Check one closed dispatch bracket (`tracing.WaveRecord`)
        against its stage deadline; records + fans out on overrun."""
        duration = float(record.t1_us - record.t0_us)
        deadline = self.deadline_us(record.stage)
        if deadline is None or duration <= deadline:
            return None
        event = StragglerEvent(
            stage=record.stage,
            trace_id=record.trace.full_id,
            wave_seq=record.wave_seq,
            duration_us=duration,
            deadline_us=deadline,
            at=time.time(),
        )
        with self._lock:
            self.straggler_count += 1
            self.stragglers.append(event)
        self.metrics.inc(metrics_plane.WAVE_STRAGGLERS)
        self._fire("straggler", event.to_dict())
        return event

    # -- occupancy ------------------------------------------------------

    def publish_footprints(self, tables: Mapping[str, object]) -> None:
        """Record every table's `footprint()` and publish the static
        bytes/capacity gauges on the host plane (pure array metadata —
        no device transfer)."""
        with self._lock:
            for name, table in tables.items():
                fp = table.footprint()
                self._footprints[name] = fp
                if name in metrics_plane.HEALTH_TABLES:
                    self.metrics.gauge_set(
                        metrics_plane.TABLE_HBM_BYTES[name], fp["bytes"]
                    )
                    self.metrics.gauge_set(
                        metrics_plane.TABLE_CAPACITY_ROWS[name],
                        fp["capacity_rows"],
                    )

    def update_occupancy(self, snap) -> list[dict]:
        """Post-drain occupancy pass: high-water marks + threshold
        events. Warnings fire on the UPWARD crossing only and re-arm
        when occupancy falls back below the threshold, so a ring
        approaching its first wrap warns exactly once instead of every
        scrape. Returns the warnings fired.

        The snapshot is patched IN PLACE (its arrays, not its frozen
        fields) with the high-water gauges and warning-counter bumps
        this pass derives from it — otherwise every exposition would
        lag those series by one drain, and a first scrape after
        traffic could show live_rows above high_water_rows. The same
        values also land on the host plane for the next drain."""
        fired: list[dict] = []
        for name in metrics_plane.HEALTH_TABLES:
            cap = snap.gauge(metrics_plane.TABLE_CAPACITY_ROWS[name])
            if cap <= 0:
                continue
            live = snap.gauge(metrics_plane.TABLE_LIVE_ROWS[name])
            occupancy = live / cap
            with self._lock:
                high = max(self._high_water.get(name, 0.0), live)
                self._high_water[name] = high
                armed = self._warn_armed.get(name, True)
                if occupancy < self.occupancy_warn:
                    self._warn_armed[name] = True
                    warn = False
                else:
                    warn = armed
                    self._warn_armed[name] = False
            handle = metrics_plane.TABLE_HIGH_WATER_ROWS[name]
            self.metrics.gauge_set(handle, high)
            snap.gauges[handle.index] = high
            if warn:
                payload = {
                    "table": name,
                    "live_rows": int(live),
                    "capacity_rows": int(cap),
                    "occupancy": round(occupancy, 4),
                    "threshold": self.occupancy_warn,
                }
                with self._lock:
                    self.capacity_warning_count += 1
                    self.capacity_events.append(payload)
                self.metrics.inc(metrics_plane.CAPACITY_WARNINGS)
                snap.counters[metrics_plane.CAPACITY_WARNINGS.index] += 1
                self._fire("capacity", payload)
                fired.append(payload)
        return fired

    # -- summaries ------------------------------------------------------

    def watchdog_summary(self) -> dict:
        with self._lock:
            recent = [e.to_dict() for e in self.stragglers]
            count = self.straggler_count
        deadlines = {
            stage: round(d, 1)
            for stage in metrics_plane.STAGES
            if (d := self.deadline_us(stage)) is not None
        }
        return {
            "k": self.k,
            "floor_us": self.floor_us,
            "min_samples": self.min_samples,
            "deadlines_us": deadlines,
            "straggler_count": count,
            "recent_stragglers": recent[-8:],
        }

    def occupancy_summary(self, snap=None) -> dict:
        """Per-table occupancy rows (from the last published footprints
        + drained gauges when a snapshot is given)."""
        with self._lock:
            footprints = dict(self._footprints)
            high_water = dict(self._high_water)
            warnings_fired = self.capacity_warning_count
            recent = list(self.capacity_events)[-8:]
        tables = {}
        for name, fp in sorted(footprints.items()):
            row = dict(fp)
            if snap is not None and name in metrics_plane.HEALTH_TABLES:
                live = snap.gauge(metrics_plane.TABLE_LIVE_ROWS[name])
                row["live_rows"] = int(live)
                cap = fp.get("capacity_rows") or 0
                row["occupancy"] = round(live / cap, 4) if cap else 0.0
            if name in high_water:
                row["high_water_rows"] = int(high_water[name])
            tables[name] = row
        return {
            "warn_threshold": self.occupancy_warn,
            "warnings_fired": warnings_fired,
            "recent_warnings": recent,
            "tables": tables,
        }

    def summary(self, snap=None) -> dict:
        return {
            "uptime_s": round(time.time() - self.started_at, 3),
            "watchdog": self.watchdog_summary(),
            "occupancy": self.occupancy_summary(snap),
        }


def hbm_total_bytes(footprints: Mapping[str, dict]) -> int:
    return int(sum(fp.get("bytes", 0) for fp in footprints.values()))


__all__ = [
    "CompileEvent",
    "CompileWatch",
    "HealthMonitor",
    "StragglerEvent",
    "compile_summary",
    "hbm_total_bytes",
    "instrument",
    "publish_compile_counters",
]
