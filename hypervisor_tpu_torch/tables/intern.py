"""Host-boundary string interning: DIDs / session ids / paths -> int32 handles.

The device plane never sees strings. Every externally-visible identifier
(agent DID, session id, vouch id, action id, VFS path) is interned to a dense
int32 handle at the host boundary; device tables index by handle. This is the
TPU-native replacement for the reference's string-keyed dicts (e.g.
`session/__init__.py:46`, `liability/vouching.py:58`).

`ColumnStore` pairs an InternTable with named, auto-growing numpy columns —
the shared substrate for host-side SoA stores (classifier, rate limiter,
reversibility registry) whose rows are keyed by interned strings.
"""

from __future__ import annotations

import numpy as np


class InternTable:
    """Bidirectional string <-> dense int32 handle registry (host side).

    Handles are never reused; freeing is a mask-flip in the owning table,
    not an intern-table operation, so handle -> string lookups stay valid
    for audit/event queries after an entity dies.
    """

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
        """Return the handle for `s`, or -1 if never interned."""
        return self._to_handle.get(s, -1)

    def string(self, handle: int) -> str:
        """Reverse lookup; raises IndexError on unknown handle."""
        if handle < 0:
            raise IndexError(f"invalid handle {handle}")
        return self._to_string[handle]

    def __len__(self) -> int:
        return len(self._to_string)

    def __contains__(self, s: str) -> bool:
        return s in self._to_handle


class ColumnStore:
    """Interned rows over named, auto-growing numpy columns (host SoA).

    `row_for(key)` interns the key and guarantees every registered column
    has capacity for the returned row; `is_new` on the same call tells the
    caller to initialize the row. Columns keep their declared dtypes
    across grows. Access columns as attributes: `store.tokens[row]`.
    """

    def __init__(self, grow: int = 32, **dtypes: np.dtype) -> None:
        self._grow = grow
        self._dtypes = {name: np.dtype(dt) for name, dt in dtypes.items()}
        self._ids = InternTable()
        for name, dt in self._dtypes.items():
            setattr(self, name, np.zeros(0, dt))

    def row_for(self, key: str) -> tuple[int, bool]:
        """(row, is_new) for key, growing every column as needed."""
        before = len(self._ids)
        row = self._ids.intern(key)
        is_new = len(self._ids) > before
        first = next(iter(self._dtypes), None)
        if first is not None and row >= len(getattr(self, first)):
            extra = max(self._grow, row + 1 - len(getattr(self, first)))
            for name, dt in self._dtypes.items():
                col = getattr(self, name)
                setattr(self, name, np.concatenate([col, np.zeros(extra, dt)]))
        return row, is_new

    def lookup(self, key: str) -> int:
        """Row for key, or -1 if never seen."""
        return self._ids.lookup(key)

    def key_of(self, row: int) -> str:
        return self._ids.string(row)

    def filled(self, name: str) -> np.ndarray:
        """The column truncated to real (interned) rows — no grow padding."""
        return getattr(self, name)[: len(self._ids)]

    def __len__(self) -> int:
        return len(self._ids)
