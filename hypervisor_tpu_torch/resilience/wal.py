"""Write-ahead intent log for the batched device state.

Crash consistency for the gap BETWEEN checkpoints: every state-mutating
dispatch in `hypervisor_tpu_torch.state` journals an INTENT record before it
touches the tables and a COMMIT record once the mutation lands (an
exception writes ABORT instead — functional waves leave the tables
unchanged when they raise, so an aborted intent had no effect). Restore
is `recovery.recover`: load the newest durable checkpoint, then replay
the committed WAL suffix past the checkpoint's watermark. Only ops with
an intact COMMIT replay — a transition is either fully in the restored
state or it never happened; nothing is lost or doubled (pinned by the
kill-at-arbitrary-offset property test in tests/unit/test_resilience.py).

On-disk format — human-greppable, torn-tail-safe::

    <crc32 hex, 8 chars> <compact json>\n
    json := {"s": seq, "k": "I"|"C"|"A", "op": name?, "a": {...}?}

Readers validate each line's CRC and stop at the first short or corrupt
line: everything after a torn write is untrusted by construction. The
writer resumes an existing log by scanning it, truncating any torn
tail, and continuing the seq numbering — so one WAL file spans process
restarts.

Payloads are JSON with numpy coercion (arrays -> lists, scalars ->
Python numbers); non-finite floats use Python json's Infinity/NaN
literals, which this module's own reader round-trips.
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Iterable, Optional

_INTENT, _COMMIT, _ABORT = "I", "C", "A"


def _jsonable(value: Any) -> Any:
    """numpy -> builtin coercion for WAL payloads."""
    import numpy as np

    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, np.generic):
        return value.item()
    raise TypeError(f"not WAL-serializable: {type(value).__name__}")


def _frame(doc: dict) -> bytes:
    body = json.dumps(
        doc, default=_jsonable, separators=(",", ":")
    ).encode()
    return b"%08x " % (zlib.crc32(body) & 0xFFFFFFFF,) + body + b"\n"


def _parse_line(line: bytes) -> Optional[dict]:
    """One framed record, or None when the line is short/corrupt."""
    if not line.endswith(b"\n") or len(line) < 10 or line[8:9] != b" ":
        return None
    body = line[9:-1]
    try:
        if int(line[:8], 16) != (zlib.crc32(body) & 0xFFFFFFFF):
            return None
        doc = json.loads(body)
    except (ValueError, json.JSONDecodeError):
        return None
    return doc if isinstance(doc, dict) and "s" in doc and "k" in doc else None


@dataclass(frozen=True)
class WalRecord:
    """One committed operation, ready to replay."""

    seq: int
    op: str
    args: dict


@dataclass(frozen=True)
class WalScan:
    """Everything one pass over a WAL file yields."""

    committed: tuple[WalRecord, ...]
    aborted: int
    open_intents: int          # intent seen, no commit/abort (crash window)
    last_seq: int
    valid_bytes: int           # offset of the first torn/corrupt byte
    torn_bytes: int


def scan(path: str | Path, after_seq: int = 0) -> WalScan:
    """Parse a WAL file, stopping at the first torn line.

    Returns the committed records with seq > `after_seq` in seq order
    (seq order IS append order: the writer allocates seqs under its
    append lock).
    """
    path = Path(path)
    raw = path.read_bytes() if path.exists() else b""
    intents: dict[int, tuple[str, dict]] = {}
    committed: list[WalRecord] = []
    aborted = 0
    last_seq = 0
    offset = 0
    for line in raw.splitlines(keepends=True):
        doc = _parse_line(line)
        if doc is None:
            break
        offset += len(line)
        seq = int(doc["s"])
        last_seq = max(last_seq, seq)
        kind = doc["k"]
        if kind == _INTENT:
            intents[seq] = (doc.get("op", "?"), doc.get("a") or {})
        elif kind == _COMMIT:
            pending = intents.pop(seq, None)
            if pending is not None and seq > after_seq:
                committed.append(WalRecord(seq, pending[0], pending[1]))
        elif kind == _ABORT:
            if intents.pop(seq, None) is not None:
                aborted += 1
        else:
            break
    committed.sort(key=lambda r: r.seq)
    return WalScan(
        committed=tuple(committed),
        aborted=aborted,
        open_intents=len(intents),
        last_seq=last_seq,
        valid_bytes=offset,
        torn_bytes=len(raw) - offset,
    )


class _Txn:
    """One intent/commit bracket (`WriteAheadLog.txn`)."""

    __slots__ = ("_wal", "_op", "_payload", "_cancelled", "seq")

    def __init__(self, wal: "WriteAheadLog", op: str, payload: dict) -> None:
        self._wal = wal
        self._op = op
        self._payload = payload
        self._cancelled = False
        self.seq = -1

    def cancel(self) -> None:
        """Downgrade a clean exit to ABORT: the op turned out to have
        no effect (e.g. a full staging queue refusing the push) and
        must not replay."""
        self._cancelled = True

    def __enter__(self) -> "_Txn":
        # Depth bookkeeping must survive I/O failures: a raise from the
        # intent append (disk full, fsync error) without the matching
        # _exit_txn would leave the thread's depth stuck, silently
        # suppressing EVERY later bracket as "nested".
        try:
            self.seq = self._wal.append_intent(self._op, self._payload)
        except BaseException:
            self._wal._exit_txn()
            raise
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            if self.seq >= 0:
                if exc_type is None and not self._cancelled:
                    self._wal.append_commit(self.seq)
                else:
                    self._wal.append_abort(self.seq)
        finally:
            self._wal._exit_txn()
        return False


class _NullTxn:
    """Nested-bracket suppressor: an op journaled inside an already
    journaled op (e.g. the gateway phase inside a governance wave) must
    not double-log — the OUTER record replays the whole composite."""

    __slots__ = ("_wal",)

    def __init__(self, wal: "WriteAheadLog") -> None:
        self._wal = wal

    def cancel(self) -> None:
        pass

    def __enter__(self) -> "_NullTxn":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._wal._exit_txn()
        return False


class WriteAheadLog:
    """Append-only intent journal with torn-tail recovery.

    `fsync=True` (the default) makes every commit durable before the
    dispatch result is observable — the correctness setting; set False
    for benchmarks where the OS page cache is an acceptable window.
    Thread-safe: seqs allocate and lines append under one lock.
    """

    def __init__(self, path: str | Path, fsync: bool = True) -> None:
        self.path = Path(path)
        self.fsync = fsync
        self._lock = threading.Lock()
        self._local = threading.local()
        self.records_written = 0
        # Optional write gate consulted BEFORE any byte is framed or
        # appended: raising here refuses the record with the file
        # untouched. The failover plane's fencing check hangs off this
        # hook (`fleet.failover.FencedWal`) — a stale-epoch zombie's
        # append must refuse loudly with ZERO bytes reaching disk.
        self.pre_append = None
        self.path.parent.mkdir(parents=True, exist_ok=True)
        seq = 0
        if self.path.exists():
            s = scan(self.path)
            seq = s.last_seq
            if s.torn_bytes:
                # Truncate the torn tail so fresh appends never
                # concatenate onto garbage a reader would stop at.
                with open(self.path, "r+b") as f:
                    f.truncate(s.valid_bytes)
        self._seq = seq
        self._f = open(self.path, "ab")

    # -- write side -----------------------------------------------------

    def _append(self, doc: dict) -> None:
        gate = self.pre_append
        if gate is not None:
            gate(doc)
        data = _frame(doc)
        with self._lock:
            self._f.write(data)
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            self.records_written += 1

    def append_intent(self, op: str, args: dict) -> int:
        with self._lock:
            self._seq += 1
            seq = self._seq
        self._append({"s": seq, "k": _INTENT, "op": op, "a": args})
        return seq

    def append_commit(self, seq: int) -> None:
        self._append({"s": seq, "k": _COMMIT})

    def append_abort(self, seq: int) -> None:
        self._append({"s": seq, "k": _ABORT})

    def txn(self, op: str, args: dict):
        """Intent/commit bracket as a context manager. Re-entrant per
        thread: nested brackets are suppressed (outer op owns replay)."""
        depth = getattr(self._local, "depth", 0)
        self._local.depth = depth + 1
        if depth:
            return _NullTxn(self)
        return _Txn(self, op, args)

    def _exit_txn(self) -> None:
        self._local.depth = getattr(self._local, "depth", 1) - 1

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def committed(self, after_seq: int = 0) -> Iterable[WalRecord]:
        self.flush()
        return scan(self.path, after_seq).committed

    def flush(self) -> None:
        with self._lock:
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())

    def close(self) -> None:
        with self._lock:
            self._f.close()

    def status(self) -> dict:
        return {
            "path": str(self.path),
            "last_seq": self.last_seq,
            "records_written": self.records_written,
            "bytes": self.path.stat().st_size if self.path.exists() else 0,
            "fsync": self.fsync,
        }


__all__ = ["WalRecord", "WalScan", "WriteAheadLog", "scan"]
