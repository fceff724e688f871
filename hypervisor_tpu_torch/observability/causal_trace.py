"""Causal trace spans encoding the agent spawn/delegation tree.

Capability parity with reference `observability/causal_trace.py:16-68`
(span ids formatted `trace_id/span_id[/parent_span_id]`, child/sibling
derivation, parsing, ancestor checks), re-built around an explicit
*lineage path*: each span carries the tuple of span ids it knows between
the oldest recorded ancestor and itself, so depth and parentage fall out
of the path instead of being four independent fields. `device_key()`
folds the span into the pair of u32 words the device `EventLog` stores
(`tables/logs.py`), keeping trace joins on-device.
"""

from __future__ import annotations

import secrets

_TRACE_HEX = 12  # 48-bit trace ids
_SPAN_HEX = 8    # 32-bit span ids

_FNV32_SEED = 0x811C9DC5
_FNV32_PRIME = 0x01000193


def _fresh(width: int) -> str:
    return secrets.token_hex(width // 2)


def fnv1a32(text: str) -> int:
    """32-bit FNV-1a of a string — the device-column hash for trace ids."""
    acc = _FNV32_SEED
    for byte in text.encode():
        acc = ((acc ^ byte) * _FNV32_PRIME) & 0xFFFFFFFF
    return acc


def device_key_of(causal_trace_id: str | None) -> tuple[int, int]:
    """(u32 trace, u32 span) device-join words for any trace-id string.

    The one rule every plane shares (host event bus, device `EventLog`,
    `TraceLog` stamps): a full `trace/span[/parent]` id keys as
    `CausalTraceId.device_key()`; a bare opaque id hashes whole as the
    trace word with span 0; absent ids key as (0, 0). Rows fed from the
    same traffic therefore join on identical word pairs by construction.
    """
    if not causal_trace_id:
        return 0, 0
    if "/" in causal_trace_id:
        try:
            return CausalTraceId.from_string(causal_trace_id).device_key()
        except ValueError:
            pass
    return fnv1a32(causal_trace_id), 0


class CausalTraceId:
    """One span in a causal trace tree, backed by its known lineage path.

    `_path` holds span ids oldest-first ending at this span; `_above`
    counts ancestors older than the path records (so depth survives
    constructing a span from its flat string form, where grandparents are
    unknown). Immutable by convention: every derivation returns a new span.
    """

    __slots__ = ("_trace", "_path", "_above")

    def __init__(
        self,
        trace_id: str | None = None,
        span_id: str | None = None,
        parent_span_id: str | None = None,
        depth: int = 0,
        *,
        _path: tuple[str, ...] | None = None,
        _above: int = 0,
    ) -> None:
        self._trace = trace_id if trace_id is not None else _fresh(_TRACE_HEX)
        if _path is not None:
            self._path = _path
            self._above = _above
        else:
            tail = span_id if span_id is not None else _fresh(_SPAN_HEX)
            if parent_span_id is None:
                self._path = (tail,)
                self._above = depth
            else:
                self._path = (parent_span_id, tail)
                self._above = max(depth - 1, 0)

    # ── identity views ──────────────────────────────────────────────────

    @property
    def trace_id(self) -> str:
        return self._trace

    @property
    def span_id(self) -> str:
        return self._path[-1]

    @property
    def parent_span_id(self) -> str | None:
        return self._path[-2] if len(self._path) > 1 else None

    @property
    def depth(self) -> int:
        return self._above + len(self._path) - 1

    @property
    def full_id(self) -> str:
        head = f"{self._trace}/{self.span_id}"
        parent = self.parent_span_id
        return f"{head}/{parent}" if parent else head

    # ── derivations ─────────────────────────────────────────────────────

    def child(self) -> "CausalTraceId":
        """Span for a spawned sub-agent / delegated operation."""
        return CausalTraceId(
            self._trace, _path=self._path + (_fresh(_SPAN_HEX),), _above=self._above
        )

    def sibling(self) -> "CausalTraceId":
        """Span at the same level: same parent, new operation."""
        return CausalTraceId(
            self._trace,
            _path=self._path[:-1] + (_fresh(_SPAN_HEX),),
            _above=self._above,
        )

    @classmethod
    def from_string(cls, s: str) -> "CausalTraceId":
        pieces = s.split("/")
        if len(pieces) < 2 or not all(pieces[:2]):
            raise ValueError(f"Invalid causal trace ID: {s!r}")
        return cls(
            trace_id=pieces[0],
            span_id=pieces[1],
            parent_span_id=pieces[2] if len(pieces) > 2 else None,
        )

    # ── relations ───────────────────────────────────────────────────────

    def is_ancestor_of(self, other: "CausalTraceId") -> bool:
        """Same trace, strictly shallower (reference semantics)."""
        return self._trace == other._trace and other.depth > self.depth

    def is_lineal_ancestor_of(self, other: "CausalTraceId") -> bool:
        """Stricter check: this span id appears in `other`'s known lineage."""
        return (
            self._trace == other._trace
            and self.span_id in other._path[:-1]
        )

    # ── device bridge ───────────────────────────────────────────────────

    def device_key(self) -> tuple[int, int]:
        """(u32 trace hash, u32 span hash) for the device event log."""
        return fnv1a32(self._trace), fnv1a32(self.span_id)

    # ── value semantics ─────────────────────────────────────────────────

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, CausalTraceId):
            return NotImplemented
        return (
            self._trace == other._trace
            and self.span_id == other.span_id
            and self.parent_span_id == other.parent_span_id
        )

    def __hash__(self) -> int:
        return hash((self._trace, self.span_id, self.parent_span_id))

    def __str__(self) -> str:
        return self.full_id

    def __repr__(self) -> str:
        return f"CausalTraceId({self.full_id!r}, depth={self.depth})"
