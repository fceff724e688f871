"""Flight recorder: the trace ring's stamps, the host span reconstruction
and its export (`hypervisor_tpu.observability.tracing`).

Three pieces:

  * **Device ring** — `tables.logs.TraceLog`: a wave stamps stage
    begin/end rows as one batched ring write. A stamp carries the wave's
    `causal_trace.device_key()` words, a stage id from `TRACE_STAGES`
    and a monotonic `seq` word, a LOGICAL clock that orders a wave's
    stamps so begin/end nesting reconstructs.
  * **Host plane** — `Tracer`: one `CausalTraceId` and wave sequence
    number per dispatched wave, the head-based sample bit, the wall-clock
    bracket around the dispatch, and host-mirrored stamp rows for the
    dispatches that stamp on the host (`stamp_wave_host`, from the same
    `WAVE_CHILD_STAGES` rule set the in-wave stamps follow).
  * **Reconstruction + export** — `drain()` copies the ring to the host
    once, merges both planes, joins rows to the wave index, and rebuilds
    parent/child spans (a stack walk over the seq order; stamp times
    interpolate inside the host-measured bracket). Exporters render
    Chrome `trace_event` JSON (loadable in Perfetto) and an OTLP-lite
    JSON form; `attach_bus_events` joins host event-bus rows onto spans
    via the shared device-key words. Every closed bracket is offered to
    the health plane's watchdog (`Tracer.health`).

The sample bit is resolved on the host and the context is plain Python
values: there is no jit here, so nothing needs to be traced.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Iterable, NamedTuple, Optional

import numpy as np
import torch

from hypervisor_tpu_torch.observability.causal_trace import CausalTraceId, fnv1a32
from hypervisor_tpu_torch.tables.logs import TraceLog

#: Stage vocabulary for trace stamps; the order is the wire format (stage
#: ids in TraceLog rows): APPEND ONLY.
TRACE_STAGES: tuple[str, ...] = (
    "governance_wave",
    "admission_wave",
    "session_fsm",
    "delta_chain",
    "saga_round",
    "terminate_wave",
    "gateway_wave",
    "slash_cascade",
    "governance_wave_sharded",
    "gateway_wave_sharded",
    "breach_sweep",
    "reconcile_wave_sessions",
)
STAGE_ID: dict[str, int] = {name: i for i, name in enumerate(TRACE_STAGES)}

KIND_BEGIN, KIND_END = 0, 1

#: Each root stage's in-wave child stamps, in order: the fused wave
#: stamps this sequence and `Tracer.stamp_wave_host` replays it.
WAVE_CHILD_STAGES: dict[str, tuple[str, ...]] = {
    "governance_wave": (
        "admission_wave",
        "session_fsm",
        "delta_chain",
        "saga_round",
        "terminate_wave",
    ),
    "governance_wave_sharded": (
        "admission_wave",
        "session_fsm",
        "delta_chain",
        "saga_round",
        "terminate_wave",
    ),
}

_SPAN_PRIME = 0x01000193  # FNV-32 prime
_MASK32 = 0xFFFFFFFF


def child_span_word(parent_span, stage_id):
    """A child stage's span word from its parent's: ((parent ^ (stage+1))
    * FNV prime) mod 2^32. On an int it is masked int math; on a tensor
    (u32 values in int64, or int32 bits) masked int64 math, returned as
    int64 in [0, 2^32) — the reference's wrapping u32 product either way."""
    if isinstance(parent_span, torch.Tensor):
        p = parent_span.to(torch.int64) & _MASK32
        return ((p ^ (int(stage_id) + 1)) * _SPAN_PRIME) & _MASK32
    return ((int(parent_span) ^ (int(stage_id) + 1)) * _SPAN_PRIME) & _MASK32


def stamp_count(stage: str) -> int:
    """Rows one sampled in-wave stamp batch of `stage` writes: its root
    begin/end pair plus a pair per child stage."""
    return 2 + 2 * len(WAVE_CHILD_STAGES.get(stage, ()))


class TraceContext(NamedTuple):
    """What a stamped wave carries: `span` is the word the op's own rows
    use; internal phases stamp `child_span_word(span, phase)`."""

    trace: int     # u32 trace word
    span: int      # u32 root span word of this dispatch
    wave_seq: int  # host wave sequence number
    sampled: bool  # head-based sample bit

    def child(self, stage_name: str) -> "TraceContext":
        """Context for a nested op: same wave, span re-rooted at the
        stage's derived word (the nested op then stamps uniformly)."""
        return self._replace(span=child_span_word(self.span, STAGE_ID[stage_name]))


class WaveStamps:
    """Stamp builder for one op's rows: `begin`/`end` record structural
    stamps, `commit` lands them as ONE batched ring write
    (`TraceLog.stamp_batch`)."""

    def __init__(self, ctx: TraceContext, root_stage: str) -> None:
        self._ctx = ctx
        self._root = STAGE_ID[root_stage]
        self._rows: list[tuple[int, int, int]] = []  # (stage, kind, lane)

    def begin(self, stage_name: str, lane: int = -1) -> None:
        self._rows.append((STAGE_ID[stage_name], KIND_BEGIN, int(lane)))

    def end(self, stage_name: str, lane: int = -1) -> None:
        self._rows.append((STAGE_ID[stage_name], KIND_END, int(lane)))

    def commit(self, log: TraceLog) -> TraceLog:
        """Write the rows IN PLACE (one host-to-device copy of the
        columns, positions from the ring's device cursor); returns it.
        On the card the copy is from pinned memory and asynchronous: a
        copy from pageable memory would wait for every launch the wave
        queued before it."""
        ctx = self._ctx
        if not self._rows or not ctx.sampled:
            return log
        cols = np.array([
            (ctx.trace,
             ctx.span if stage == self._root else child_span_word(ctx.span, stage),
             stage, kind, lane, ctx.wave_seq)
            for stage, kind, lane in self._rows
        ], np.int64).T
        t = torch.from_numpy(np.ascontiguousarray(cols))
        if log.words.device.type == "cuda":
            t = t.pin_memory().to(log.words.device, non_blocking=True)
        log.stamp_batch(*t, sampled=ctx.sampled)
        return log


# ── host plane ───────────────────────────────────────────────────────


@dataclasses.dataclass
class WaveRecord:
    """Host-side record of one dispatched wave (the reconstruction key)."""

    wave_seq: int
    trace: CausalTraceId
    stage: str
    sessions: np.ndarray
    t0_us: float
    t1_us: float = 0.0
    sampled: bool = True
    lanes: int = 0
    mode: str = "device"  # "device" (in-wave stamps) | "host" (mirrored)


@dataclasses.dataclass
class WaveHandle:
    """What `begin_wave` hands the dispatch site: the host record plus
    the context to stamp with (None for a host-stamped dispatch)."""

    record: WaveRecord
    ctx: Optional[TraceContext]


@dataclasses.dataclass
class Span:
    """One reconstructed span. Times are µs on the tracer's clock."""

    name: str
    stage: str
    trace_id: str
    span_word: int
    parent_span_word: Optional[int]
    start_us: float
    end_us: float
    wave_seq: int
    children: list["Span"] = dataclasses.field(default_factory=list)
    events: list[dict] = dataclasses.field(default_factory=list)

    def walk(self) -> Iterable["Span"]:
        yield self
        for child in self.children:
            yield from child.walk()


def _sample_bit(key: str, rate: float) -> bool:
    """Deterministic head-based decision: fnv1a32 of the key against the
    rate threshold."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return (fnv1a32(key) % (1 << 16)) < rate * (1 << 16)


class Tracer:
    """One deployment's trace plane: the device `TraceLog` (`table`) and
    the host wave index.

    `cursor` is the host mirror of `table.cursor`: the host knows every
    advance (a sampled in-wave batch writes `stamp_count(stage)` rows),
    so no wave reads the device cursor back. Knobs, as in the reference:
    `HV_TRACE=0` disables the plane; `HV_TRACE_SAMPLE=<0..1>` sets the
    head-based sample rate (per session, deterministic).
    """

    def __init__(
        self,
        capacity: int = 4096,
        device: str | torch.device = "cuda",
        sample_rate: Optional[float] = None,
        enabled: Optional[bool] = None,
        max_waves: int = 4096,
    ) -> None:
        if enabled is None:
            enabled = os.environ.get("HV_TRACE", "1") != "0"
        if sample_rate is None:
            sample_rate = float(os.environ.get("HV_TRACE_SAMPLE", "1.0"))
        self.enabled = bool(enabled)
        self.sample_rate = float(sample_rate)
        self.capacity = int(capacity)
        self.cursor = 0
        self._lock = threading.Lock()
        self._next_wave = 0
        self._waves: dict[int, WaveRecord] = {}
        self._max_waves = int(max_waves)
        # Host-plane stamp rows: (wave_seq, seq, trace, span, stage, kind, lane).
        self._host_rows: list[tuple[int, int, int, int, int, int, int]] = []
        # µs clock: monotonic for brackets, unix anchor for OTLP export.
        self._perf0 = time.perf_counter()
        self._unix0 = time.time()
        self.table: Optional[TraceLog] = (
            TraceLog.create(self.capacity, device) if self.enabled else None
        )
        #: Most recently closed wave bracket.
        self.last_closed: Optional[WaveRecord] = None
        #: The wave watchdog (`observability.health.HealthMonitor`): every
        #: closed bracket is offered to it, outside the tracer's lock.
        self.health = None

    def _now_us(self) -> float:
        return (time.perf_counter() - self._perf0) * 1e6

    def unix_us(self, us: float) -> float:
        """Tracer-clock µs -> unix µs (the OTLP export anchor)."""
        return self._unix0 * 1e6 + us

    # ── wave bracket ─────────────────────────────────────────────────

    def begin_wave(
        self,
        stage: str,
        sessions: Iterable[int] = (),
        lanes: int = 0,
        device: bool = True,
    ) -> Optional[WaveHandle]:
        """Open one dispatched wave; None when the plane is disabled. The
        sample bit resolves here, per session slot key. `device=False`
        marks a dispatch that stamps on the host (`stamp_wave_host`)."""
        if not self.enabled:
            return None
        sessions = np.asarray(
            sessions if not isinstance(sessions, (int, np.integer)) else [sessions], np.int32
        ).ravel()
        trace = CausalTraceId()
        if self.sample_rate >= 1.0:
            sampled = True
        elif self.sample_rate <= 0.0:
            sampled = False
        else:
            keys = ((f"slot:{s}" for s in sessions.tolist()) if sessions.size
                    else iter((trace.trace_id,)))
            sampled = any(_sample_bit(k, self.sample_rate) for k in keys)
        with self._lock:
            wave_seq = self._next_wave
            self._next_wave += 1
        record = WaveRecord(
            wave_seq=wave_seq, trace=trace, stage=stage, sessions=sessions,
            t0_us=self._now_us(), sampled=sampled, lanes=int(lanes),
            mode="device" if device else "host",
        )
        ctx = None
        if device:
            t_word, s_word = trace.device_key()
            ctx = TraceContext(trace=t_word, span=s_word, wave_seq=wave_seq, sampled=sampled)
        return WaveHandle(record=record, ctx=ctx)

    def end_wave(self, handle: Optional[WaveHandle], table: Optional[TraceLog] = None) -> None:
        """Close the bracket. `table` is the ring the wave stamped (in
        place), which advances the cursor mirror when the wave was
        sampled. Records are kept in a bounded index, oldest evicted."""
        if handle is None:
            return
        handle.record.t1_us = self._now_us()
        with self._lock:
            if table is not None:
                self.table = table
                if handle.record.sampled:
                    self.cursor += stamp_count(handle.record.stage)
            self._waves[handle.record.wave_seq] = handle.record
            self.last_closed = handle.record
            while len(self._waves) > self._max_waves:
                del self._waves[next(iter(self._waves))]
        health = self.health
        if health is not None:
            health.observe_wave(handle.record)

    def stamp_wave_host(self, handle: Optional[WaveHandle]) -> None:
        """Mirror one dispatch's stamp rows on the host plane, from the
        `WAVE_CHILD_STAGES` rule set; unsampled waves mirror nothing."""
        if handle is None or not handle.record.sampled:
            return
        rec = handle.record
        t_word, s_word = rec.trace.device_key()
        root_id = STAGE_ID[rec.stage]
        rows: list[tuple[int, int, int]] = [(root_id, KIND_BEGIN, -1)]
        for child in WAVE_CHILD_STAGES.get(rec.stage, ()):
            rows.append((STAGE_ID[child], KIND_BEGIN, -1))
            rows.append((STAGE_ID[child], KIND_END, -1))
        rows.append((root_id, KIND_END, -1))
        with self._lock:
            for seq, (stage, kind, lane) in enumerate(rows):
                span = s_word if stage == root_id else child_span_word(s_word, stage)
                self._host_rows.append((rec.wave_seq, seq, t_word, span, stage, kind, lane))
            if len(self._host_rows) > self.capacity:
                self._host_rows = self._host_rows[-self.capacity:]

    # ── drain + reconstruction ───────────────────────────────────────

    def _device_rows(self) -> list[tuple[int, int, int, int, int, int, int]]:
        """Live ring rows as (wave_seq, seq, trace, span, stage, kind,
        lane): ONE device-to-host copy of the ring, outside every wave."""
        if self.table is None:
            return []
        words = self.table.words.cpu().numpy()
        signed, unsigned = words, words.view(np.uint32)
        wave_seq = signed[:, TraceLog.COL_WAVE_SEQ]
        live = np.nonzero(wave_seq >= 0)[0]
        rows = [
            (int(wave_seq[i]), int(unsigned[i, TraceLog.COL_SEQ]),
             int(unsigned[i, TraceLog.COL_TRACE]), int(unsigned[i, TraceLog.COL_SPAN]),
             int(signed[i, TraceLog.COL_STAGE]), int(signed[i, TraceLog.COL_KIND]),
             int(signed[i, TraceLog.COL_LANE]))
            for i in live
        ]
        rows.sort(key=lambda r: r[1])
        return rows

    def drain(self) -> list[Span]:
        """Reconstruct every wave both planes hold: stamps group by
        wave_seq, join the host wave index, and nest by a stack walk
        over seq order."""
        with self._lock:
            host_rows = list(self._host_rows)
            waves = dict(self._waves)
        by_wave: dict[int, list[tuple]] = {}
        for row in self._device_rows() + host_rows:
            by_wave.setdefault(row[0], []).append(row)
        spans: list[Span] = []
        for wave_seq in sorted(by_wave):
            record = waves.get(wave_seq)
            if record is None:
                continue  # record evicted: ring rows alone can't be timed
            root = self._reconstruct(record, by_wave[wave_seq])
            if root is not None:
                spans.append(root)
        return spans

    def _reconstruct(self, record: WaveRecord, rows: list[tuple]) -> Optional[Span]:
        rows = sorted(rows, key=lambda r: r[1])
        n = len(rows)
        if n == 0:
            return None
        t0, t1 = record.t0_us, max(record.t1_us, record.t0_us)
        width = (t1 - t0) / (n + 1)

        def vtime(i: int) -> float:
            return t0 + (i + 1) * width

        root: Optional[Span] = None
        stack: list[Span] = []
        for i, (_w, _seq, _trace_w, span_w, stage, kind, _lane) in enumerate(rows):
            stage_name = TRACE_STAGES[stage] if 0 <= stage < len(TRACE_STAGES) else f"stage_{stage}"
            if kind == KIND_BEGIN:
                span = Span(
                    name=f"hv.{stage_name}", stage=stage_name, trace_id=record.trace.trace_id,
                    span_word=span_w,
                    parent_span_word=stack[-1].span_word if stack else None,
                    start_us=t0 if not stack else vtime(i), end_us=t1,
                    wave_seq=record.wave_seq,
                )
                if stack:
                    stack[-1].children.append(span)
                elif root is None:
                    root = span
                stack.append(span)
            else:
                # Close the innermost open span with this word (stamps
                # are well-nested by construction; tolerate strays).
                while stack:
                    top = stack.pop()
                    top.end_us = t1 if not stack else vtime(i)
                    if top.span_word == span_w:
                        break
        while stack:
            stack.pop().end_us = t1
        if root is not None:
            root.start_us, root.end_us = t0, t1
        return root

    # ── queries ──────────────────────────────────────────────────────

    def session_spans(self, session_slot: int) -> list[Span]:
        """Reconstructed waves that touched this session slot."""
        out = []
        for span in self.drain():
            record = self._waves.get(span.wave_seq)
            if record is not None and session_slot in record.sessions:
                out.append(span)
        return out

    def flight_summary(self, last: int = 32) -> dict:
        """The /debug/flight payload: recorder state + recent waves."""
        with self._lock:
            records = [
                self._waves[k] for k in sorted(self._waves)[-last:]
            ]
            cursor = self.cursor if self.table is not None else 0
        return {
            "enabled": self.enabled,
            "sample_rate": self.sample_rate,
            "ring_capacity": self.capacity,
            "ring_cursor": cursor,
            "waves_indexed": len(self._waves),
            "next_wave_seq": self._next_wave,
            "recent_waves": [
                {
                    "wave_seq": r.wave_seq,
                    "trace_id": r.trace.full_id,
                    "stage": f"hv.{r.stage}",
                    # Bounded payload: a bench wave names 10k slots.
                    "sessions": [int(s) for s in r.sessions[:16]],
                    "n_sessions": int(r.sessions.size),
                    "lanes": r.lanes,
                    "sampled": r.sampled,
                    "mode": r.mode,
                    "duration_us": round(max(r.t1_us - r.t0_us, 0.0), 1),
                }
                for r in records
            ],
        }


# ── joins ────────────────────────────────────────────────────────────


def attach_bus_events(spans: list[Span], bus, session_id=None, events=None) -> int:
    """Join host event-bus rows onto spans via the device-key words.

    An event whose `causal_trace_id` keys to a span's (trace, span)
    word pair lands on that span; a trace-word-only match lands on the
    wave's root span. Returns the number of events attached. `events`
    overrides the bus query — the trace endpoint uses it to join
    session-less health events (stragglers carry only the wave's trace
    id) onto the session's waves.
    """
    from hypervisor_tpu_torch.observability.causal_trace import device_key_of

    by_word: dict[tuple[int, int], Span] = {}
    roots_by_trace: dict[int, Span] = {}
    for root in spans:
        root_trace_w = fnv1a32(root.trace_id)
        roots_by_trace.setdefault(root_trace_w, root)
        for span in root.walk():
            by_word[(root_trace_w, span.span_word)] = span
    attached = 0
    if events is None:
        events = (
            bus.query(session_id=session_id) if session_id else bus.all_events
        )
    for event in events:
        t_w, s_w = device_key_of(event.causal_trace_id)
        target = by_word.get((t_w, s_w)) or roots_by_trace.get(t_w)
        if target is None:
            continue
        target.events.append(
            {
                "name": event.event_type.value,
                "ts_us": event.timestamp.timestamp() * 1e6,
                "session_id": event.session_id,
                "agent_did": event.agent_did,
            }
        )
        attached += 1
    return attached


# ── exporters ────────────────────────────────────────────────────────


def to_chrome_trace(spans: list[Span], tracer: Optional[Tracer] = None) -> dict:
    """Chrome `trace_event` JSON (the Perfetto/about:tracing format).

    Complete "X" duration events, one track (tid) per wave; span events
    become "i" instant events on the same track.
    """
    events: list[dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": 1,
            "args": {"name": "hypervisor_tpu_torch"},
        }
    ]
    for root in spans:
        for span in root.walk():
            events.append(
                {
                    "name": span.name,
                    "cat": "hv",
                    "ph": "X",
                    "ts": round(span.start_us, 3),
                    "dur": round(max(span.end_us - span.start_us, 0.0), 3),
                    "pid": 1,
                    "tid": span.wave_seq,
                    "args": {
                        "trace_id": span.trace_id,
                        "span": f"{span.span_word:08x}",
                        "parent_span": (
                            f"{span.parent_span_word:08x}"
                            if span.parent_span_word is not None
                            else None
                        ),
                    },
                }
            )
            for ev in span.events:
                events.append(
                    {
                        "name": ev["name"],
                        "cat": "hv.event",
                        "ph": "i",
                        "s": "t",
                        "ts": round(span.start_us, 3),
                        "pid": 1,
                        "tid": span.wave_seq,
                        "args": {
                            k: v for k, v in ev.items() if k != "name"
                        },
                    }
                )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def to_otlp(spans: list[Span], tracer: Optional[Tracer] = None) -> dict:
    """OTLP-lite JSON: the `resourceSpans` shape OTLP/HTTP JSON uses,
    ids hex-padded to OTLP widths, times in unix nanoseconds (anchored
    to the tracer's unix clock when one is supplied)."""

    def unix_ns(us: float) -> int:
        if tracer is not None:
            return int(tracer.unix_us(us) * 1e3)
        return int(us * 1e3)

    otlp_spans: list[dict] = []
    for root in spans:
        trace_hex = root.trace_id.rjust(32, "0")[:32]
        for span in root.walk():
            otlp_spans.append(
                {
                    "traceId": trace_hex,
                    "spanId": f"{span.span_word:016x}",
                    "parentSpanId": (
                        f"{span.parent_span_word:016x}"
                        if span.parent_span_word is not None
                        else ""
                    ),
                    "name": span.name,
                    "kind": 1,  # SPAN_KIND_INTERNAL
                    "startTimeUnixNano": unix_ns(span.start_us),
                    "endTimeUnixNano": unix_ns(span.end_us),
                    "attributes": [
                        {
                            "key": "hv.wave_seq",
                            "value": {"intValue": span.wave_seq},
                        },
                        {
                            "key": "hv.stage",
                            "value": {"stringValue": span.stage},
                        },
                    ],
                    "events": [
                        {
                            "name": ev["name"],
                            "timeUnixNano": unix_ns(span.start_us),
                        }
                        for ev in span.events
                    ],
                    "status": {},
                }
            )
    return {
        "resourceSpans": [
            {
                "resource": {
                    "attributes": [
                        {
                            "key": "service.name",
                            "value": {"stringValue": "hypervisor_tpu_torch"},
                        }
                    ]
                },
                "scopeSpans": [
                    {
                        "scope": {"name": "hypervisor_tpu_torch.tracing"},
                        "spans": otlp_spans,
                    }
                ],
            }
        ]
    }
