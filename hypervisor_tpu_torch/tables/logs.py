"""Append-only device logs: the DeltaLog of audit records, the EventLog of
typed events and the TraceLog flight-recorder ring
(`hypervisor_tpu.tables.logs`).

Both are fixed-capacity ring buffers with a monotonic `cursor` (a 0-d
int32 tensor; a row lands at `cursor % C`). The reference returns a new
table from every append; here each append writes the columns IN PLACE
and advances the cursor on the device, so no host synchronisation is
needed. u32 columns hold int32 bits (the package's u32 convention).
"""

from __future__ import annotations

import numpy as np
import torch

from hypervisor_tpu_torch import u32
from hypervisor_tpu_torch.tables.struct import footprint, table

#: Body words per delta record (64 bytes); a chain link hashes body || parent.
BODY_WORDS = 16


def _put(col: torch.Tensor, idx: torch.Tensor, rows) -> None:
    col[idx] = torch.as_tensor(rows, device=col.device).to(col.dtype)


@table
class DeltaLog:
    """[C] ring buffer of binary delta records and their chain digests."""

    body: torch.Tensor     # u32[C, 16] as int32 bits
    digest: torch.Tensor   # u32[C, 8] as int32 bits
    session: torch.Tensor  # i32[C] (-1 = never written)
    turn: torch.Tensor     # i32[C]
    cursor: torch.Tensor   # i32[] next write position (monotonic)

    @staticmethod
    def create(capacity: int, device: str | torch.device) -> "DeltaLog":
        return DeltaLog(
            body=torch.zeros((capacity, BODY_WORDS), dtype=torch.int32, device=device),
            digest=torch.zeros((capacity, 8), dtype=torch.int32, device=device),
            session=torch.full((capacity,), -1, dtype=torch.int32, device=device),
            turn=torch.zeros((capacity,), dtype=torch.int32, device=device),
            cursor=torch.zeros((), dtype=torch.int32, device=device),
        )

    @property
    def capacity_rows(self) -> int:
        return int(self.body.shape[-2])  # [C, 16], or [T, C, 16] stacked

    def footprint(self) -> dict:
        """Health-plane bytes and row capacity (`tables.struct.footprint`)."""
        return footprint(self, self.capacity_rows)

    def append_batch(self, bodies, digests, sessions, turns) -> None:
        """Append B records at the cursor (wrapping), IN PLACE."""
        self.append_batch_prefix(bodies, digests, sessions, turns, bodies.shape[0])

    def append_batch_prefix(self, bodies, digests, sessions, turns, n_live) -> None:
        """Append the first `n_live` (an int) of B records at the cursor,
        IN PLACE; the cursor advances by exactly `n_live`. A bucket-padded
        wave's pad rows never land, so the ring equals an unpadded
        append of the live prefix."""
        capacity = self.body.shape[0]
        n = int(n_live)
        pos = torch.arange(n, dtype=torch.int64, device=self.cursor.device)
        idx = (self.cursor.to(torch.int64) + pos) % capacity
        _put(self.body, idx, bodies[:n])
        _put(self.digest, idx, digests[:n])
        _put(self.session, idx, sessions[:n])
        _put(self.turn, idx, turns[:n])
        self.cursor += n


@table
class EventLog:
    """[C] ring buffer of typed events. `trace`/`span` hold the causal
    trace's device key words, so event rows and TraceLog stamps join on
    the same (trace, span) words. The facade mirrors its event bus here
    (`Hypervisor.sync_events_to_device`); the wave's epilogue reads its
    cursor (a live-row gauge) and the sanitizer checks it."""

    event_type: torch.Tensor  # i32[C] EventType code (-1 = empty)
    session: torch.Tensor     # i32[C] session slot
    agent: torch.Tensor       # i32[C] agent slot
    trace: torch.Tensor       # u32[C] as int32 bits
    span: torch.Tensor        # u32[C] as int32 bits
    timestamp: torch.Tensor   # f32[C]
    cursor: torch.Tensor      # i32[]

    @staticmethod
    def create(capacity: int, device: str | torch.device) -> "EventLog":
        def full(value, dtype):
            return torch.full((capacity,), value, dtype=dtype, device=device)

        return EventLog(
            event_type=full(-1, torch.int32),
            session=full(-1, torch.int32),
            agent=full(-1, torch.int32),
            trace=full(0, torch.int32),
            span=full(0, torch.int32),
            timestamp=full(0.0, torch.float32),
            cursor=torch.zeros((), dtype=torch.int32, device=device),
        )

    def append_batch(self, event_types, sessions, agents, traces, timestamps,
                     spans=None) -> None:
        """Append B events at the cursor (wrapping), IN PLACE. Columns are
        [B] host arrays (u32 trace and span words as their values or as
        int32 bits); `spans` defaults to 0. When B exceeds the capacity,
        only the last `capacity` rows land, as a sequential append would
        leave them."""
        capacity = self.event_type.shape[0]
        b = len(event_types)
        if spans is None:
            spans = np.zeros(b, np.int64)
        tail = slice(b - min(b, capacity), b)
        dev = self.cursor.device
        idx = (self.cursor.to(torch.int64)
               + torch.arange(tail.start, b, dtype=torch.int64, device=dev)) % capacity
        for col, rows, dtype in ((self.event_type, event_types, np.int32),
                                 (self.session, sessions, np.int32),
                                 (self.agent, agents, np.int32), (self.trace, traces, np.int64),
                                 (self.span, spans, np.int64),
                                 (self.timestamp, timestamps, np.float32)):
            t = torch.from_numpy(np.asarray(rows, dtype)[tail]).to(dev)
            col[idx] = u32.narrow(t) if dtype is np.int64 else t
        self.cursor += b

    @property
    def capacity_rows(self) -> int:
        return int(self.event_type.shape[-1])  # [C], or [T, C] stacked

    def footprint(self) -> dict:
        """Health-plane bytes and row capacity (`tables.struct.footprint`)."""
        return footprint(self, self.capacity_rows)


@table
class TraceLog:
    """[C] flight-recorder ring: stage begin/end stamps per wave.

    One row is seven u32 words (int32 bits here): trace and span words
    (`causal_trace.device_key()`), the stage index into
    `observability.tracing.TRACE_STAGES`, the kind (0 begin, 1 end), the
    lane or session scope, the host wave sequence number (-1 = empty)
    and `seq`, the pre-wrap cursor position — a logical clock that
    orders a wave's stamps. An unsampled wave writes no row and leaves
    the cursor in place.
    """

    words: torch.Tensor   # u32[C, 7] as int32 bits (column order below)
    cursor: torch.Tensor  # i32[]

    COL_TRACE = 0
    COL_SPAN = 1
    COL_STAGE = 2
    COL_KIND = 3
    COL_LANE = 4
    COL_WAVE_SEQ = 5
    COL_SEQ = 6

    @staticmethod
    def create(capacity: int, device: str | torch.device) -> "TraceLog":
        words = torch.zeros((capacity, 7), dtype=torch.int32, device=device)
        words[:, TraceLog.COL_LANE] = -1
        words[:, TraceLog.COL_WAVE_SEQ] = -1
        return TraceLog(words=words, cursor=torch.zeros((), dtype=torch.int32, device=device))

    @property
    def capacity_rows(self) -> int:
        return int(self.words.shape[-2])  # [C, 7], or [T, C, 7] stacked

    def footprint(self) -> dict:
        """Health-plane bytes and row capacity (`tables.struct.footprint`)."""
        return footprint(self, self.capacity_rows)

    def stamp_batch(self, traces, spans, stages, kinds, lanes, wave_seqs, sampled=True) -> None:
        """Append B stamps at the cursor, IN PLACE. Each column is [B]
        integers (u32 words as their values or as int32 bits); `seq` is
        each row's pre-wrap cursor position. `sampled` is the wave's
        host-resolved sample bit: an unsampled wave writes nothing and
        leaves the cursor in place."""
        if not sampled:
            return
        dev = self.words.device
        cols = [torch.as_tensor(c, device=dev).to(torch.int64)
                for c in (traces, spans, stages, kinds, lanes, wave_seqs)]
        b = cols[0].shape[0]
        pos = self.cursor.to(torch.int64) + torch.arange(b, dtype=torch.int64, device=dev)
        rows = u32.narrow(torch.stack(cols + [pos], dim=1))
        self.words[pos % self.words.shape[0]] = rows
        self.cursor += b
