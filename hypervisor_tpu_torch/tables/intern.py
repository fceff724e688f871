"""Host-boundary string interning: DIDs / session ids -> int32 handles
(a copy of `hypervisor_tpu.tables.intern.InternTable`)."""

from __future__ import annotations


class InternTable:
    """Bidirectional string <-> dense int32 handle registry (host side).
    Handles are never reused."""

    __slots__ = ("_to_handle", "_to_string")

    def __init__(self) -> None:
        self._to_handle: dict[str, int] = {}
        self._to_string: list[str] = []

    def intern(self, s: str) -> int:
        """Return the handle for `s`, allocating one if new."""
        h = self._to_handle.get(s)
        if h is None:
            h = len(self._to_string)
            self._to_handle[s] = h
            self._to_string.append(s)
        return h

    def lookup(self, s: str) -> int:
        """The handle for `s`, or -1 if it was never interned."""
        return self._to_handle.get(s, -1)

    def string(self, handle: int) -> str:
        """Reverse lookup; raises IndexError on unknown handle."""
        if handle < 0:
            raise IndexError(f"invalid handle {handle}")
        return self._to_string[handle]
