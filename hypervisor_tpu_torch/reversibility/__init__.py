"""Reversibility registry: action -> (Execute_API, Undo_API, omega).

Capability parity with reference `reversibility/registry.py:31-107`
(session-scoped entries populated from IATP manifests, undo lookup for
saga rollback, non-reversible detection driving STRONG-mode forcing in
the facade, undo-API health marking) — stored columnar: action ids are
interned to dense rows and every per-action attribute lives in a
parallel column, so the facade's hot checks (`has_non_reversible_actions`
at join time) and the device plane's omega/ring gathers read vectors,
not object graphs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from hypervisor_tpu_torch.models import ActionDescriptor, ReversibilityLevel
from hypervisor_tpu_torch.tables.intern import ColumnStore

__all__ = ["ReversibilityEntry", "ReversibilityRegistry"]

_LEVELS = (ReversibilityLevel.FULL, ReversibilityLevel.PARTIAL, ReversibilityLevel.NONE)
_LEVEL_CODE = {lvl: i for i, lvl in enumerate(_LEVELS)}
_NONE_CODE = _LEVEL_CODE[ReversibilityLevel.NONE]


@dataclass
class ReversibilityEntry:
    action_id: str
    execute_api: str
    undo_api: Optional[str]
    reversibility: ReversibilityLevel
    undo_window_seconds: int
    compensation_method: Optional[str]
    risk_weight: float
    undo_api_healthy: bool = True
    last_health_check: Optional[str] = None


class ReversibilityRegistry:
    """Session-scoped reversibility table (interned rows, parallel columns)."""

    def __init__(self, session_id: str) -> None:
        self.session_id = session_id
        self._non_reversible = 0  # running count: O(1) hot-path check
        self._t = ColumnStore(
            grow=16,
            rev=np.int8,
            omega=np.float32,
            window=np.int32,
            healthy=np.bool_,
        )
        self._execute: list[str] = []
        self._undo: list[Optional[str]] = []
        self._comp: list[Optional[str]] = []

    # ── registration ────────────────────────────────────────────────────

    def register(self, action: ActionDescriptor) -> ReversibilityEntry:
        row, is_new = self._t.row_for(action.action_id)
        while len(self._execute) <= row:
            self._execute.append("")
            self._undo.append(None)
            self._comp.append(None)
        if not is_new and int(self._t.rev[row]) == _NONE_CODE:
            self._non_reversible -= 1  # re-registering an existing action
        self._t.rev[row] = _LEVEL_CODE[action.reversibility]
        if _LEVEL_CODE[action.reversibility] == _NONE_CODE:
            self._non_reversible += 1
        self._t.omega[row] = action.risk_weight
        self._t.window[row] = action.undo_window_seconds
        self._t.healthy[row] = True
        self._execute[row] = action.execute_api
        self._undo[row] = action.undo_api
        self._comp[row] = action.compensation_method
        return self._view(row)

    def register_from_manifest(self, actions: list[ActionDescriptor]) -> int:
        for action in actions:
            self.register(action)
        return len(actions)

    # ── lookups ─────────────────────────────────────────────────────────

    def get(self, action_id: str) -> Optional[ReversibilityEntry]:
        row = self._t.lookup(action_id)
        return self._view(row) if row >= 0 else None

    def get_undo_api(self, action_id: str) -> Optional[str]:
        row = self._t.lookup(action_id)
        return self._undo[row] if row >= 0 else None

    def is_reversible(self, action_id: str) -> bool:
        row = self._t.lookup(action_id)
        return row >= 0 and int(self._t.rev[row]) != _NONE_CODE

    def get_risk_weight(self, action_id: str) -> float:
        row = self._t.lookup(action_id)
        if row < 0:
            return ReversibilityLevel.NONE.default_risk_weight
        return float(self._t.omega[row])

    def has_non_reversible_actions(self) -> bool:
        return self._non_reversible > 0

    def mark_undo_unhealthy(self, action_id: str) -> None:
        row = self._t.lookup(action_id)
        if row >= 0:
            self._t.healthy[row] = False

    # ── bulk views ──────────────────────────────────────────────────────

    @property
    def entries(self) -> list[ReversibilityEntry]:
        return [self._view(row) for row in range(len(self._t))]

    @property
    def non_reversible_actions(self) -> list[str]:
        rows = np.nonzero(self._t.filled("rev") == _NONE_CODE)[0]
        return [self._t.key_of(int(row)) for row in rows]

    def omega_column(self) -> np.ndarray:
        """f32[N] risk weights in row order — the device gather source."""
        return self._t.filled("omega").copy()

    def _view(self, row: int) -> ReversibilityEntry:
        return ReversibilityEntry(
            action_id=self._t.key_of(row),
            execute_api=self._execute[row],
            undo_api=self._undo[row],
            reversibility=_LEVELS[int(self._t.rev[row])],
            undo_window_seconds=int(self._t.window[row]),
            compensation_method=self._comp[row],
            risk_weight=float(self._t.omega[row]),
            undo_api_healthy=bool(self._t.healthy[row]),
        )
