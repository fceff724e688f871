"""Causal trace ids: the parts of `hypervisor_tpu.observability.causal_trace`
the tracer needs — `fnv1a32`, and a `CausalTraceId` with its trace and span
ids and `device_key()`, the pair of u32 words a TraceLog row stores (same
ids, same words). Fresh ids come from `secrets.token_hex`, the trace id
first, as in the reference.
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


class CausalTraceId:
    """One root span of a causal trace: a trace id and a span id."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str | None = None, span_id: str | None = None) -> None:
        self.trace_id = trace_id if trace_id is not None else _fresh(_TRACE_HEX)
        self.span_id = span_id if span_id is not None else _fresh(_SPAN_HEX)

    def device_key(self) -> tuple[int, int]:
        """(u32 trace hash, u32 span hash): the words a TraceLog row keys on."""
        return fnv1a32(self.trace_id), fnv1a32(self.span_id)

    def __repr__(self) -> str:
        return f"CausalTraceId({self.trace_id}/{self.span_id})"
