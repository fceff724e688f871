"""Action risk classifier: manifest actions -> (ring, omega, reversibility).

Capability parity with reference `rings/classifier.py:27-77` (derivation
from the ActionDescriptor, per-action caching, session-level overrides at
confidence 0.9), re-built on the shared `ColumnStore`: action ids are
interned to dense rows and the classification lives in parallel ring/
omega/reversibility/confidence columns, with override rows shadowing
derived rows via a source mark. `classify_batch` classifies a whole
manifest in one pass over the columns — the host-side twin of the
vectorized `ops.rings.required_rings`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np

from hypervisor_tpu_torch.models import ActionDescriptor, ExecutionRing, ReversibilityLevel
from hypervisor_tpu_torch.tables.intern import ColumnStore

_REV_BY_CODE = (
    ReversibilityLevel.FULL,
    ReversibilityLevel.PARTIAL,
    ReversibilityLevel.NONE,
)
_CODE_BY_REV = {lvl: i for i, lvl in enumerate(_REV_BY_CODE)}

# Row source marks.
_EMPTY, _DERIVED, _OVERRIDE = 0, 1, 2


@dataclass
class ClassificationResult:
    action_id: str
    ring: ExecutionRing
    risk_weight: float
    reversibility: ReversibilityLevel
    confidence: float = 1.0


class ActionClassifier:
    """Columnar classification table; override rows shadow derived rows."""

    OVERRIDE_CONFIDENCE = 0.9

    def __init__(self) -> None:
        self._t = ColumnStore(
            ring=np.int8,
            omega=np.float32,
            rev=np.int8,
            conf=np.float64,
            source=np.int8,  # _EMPTY/_DERIVED/_OVERRIDE
        )
        # Materialized result per row, dropped whenever the row is refilled,
        # so repeat classify() calls return the identical object.
        self._views: dict[int, ClassificationResult] = {}

    # ── single-action path ──────────────────────────────────────────────

    def classify(self, action: ActionDescriptor) -> ClassificationResult:
        row, _ = self._t.row_for(action.action_id)
        if self._t.source[row] == _EMPTY:
            self._fill(row, _DERIVED, action.required_ring.value,
                       action.risk_weight, _CODE_BY_REV[action.reversibility], 1.0)
        return self._materialize(row, action.action_id)

    def set_override(
        self,
        action_id: str,
        ring: Optional[ExecutionRing] = None,
        risk_weight: Optional[float] = None,
    ) -> None:
        """Install a session-level override (confidence 0.9).

        Unset fields inherit the current row (or sandbox/0.5/NONE when the
        action was never classified).
        """
        row, _ = self._t.row_for(action_id)
        known = self._t.source[row] != _EMPTY
        self._fill(
            row,
            _OVERRIDE,
            ring.value if ring is not None
            else (int(self._t.ring[row]) if known else ExecutionRing.RING_3_SANDBOX.value),
            risk_weight if risk_weight is not None
            else (float(self._t.omega[row]) if known else 0.5),
            int(self._t.rev[row]) if known else _CODE_BY_REV[ReversibilityLevel.NONE],
            self.OVERRIDE_CONFIDENCE,
        )

    def clear_cache(self) -> None:
        """Drop derived rows; override rows survive (they are policy)."""
        live = self._t.filled("source")
        for row in np.nonzero(live == _DERIVED)[0]:
            self._views.pop(int(row), None)
        live[live == _DERIVED] = _EMPTY

    # ── batch path (manifest tables) ────────────────────────────────────

    def classify_batch(
        self, actions: Iterable[ActionDescriptor]
    ) -> list[ClassificationResult]:
        """Classify a manifest in one column pass (fills empty rows first)."""
        actions = list(actions)
        rows = [self._t.row_for(a.action_id)[0] for a in actions]
        for a, row in zip(actions, rows):
            if self._t.source[row] == _EMPTY:
                self._fill(row, _DERIVED, a.required_ring.value,
                           a.risk_weight, _CODE_BY_REV[a.reversibility], 1.0)
        return [
            self._materialize(row, a.action_id)
            for a, row in zip(actions, rows)
        ]

    def columns(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(ring i8[N], omega f32[N], reversibility i8[N]) device-ready views.

        N is the interned row count — grow padding never leaks out.
        """
        return (
            self._t.filled("ring").copy(),
            self._t.filled("omega").copy(),
            self._t.filled("rev").copy(),
        )

    # ── row plumbing ────────────────────────────────────────────────────

    def _fill(
        self, row: int, source: int, ring: int, omega: float, rev: int, conf: float
    ) -> None:
        self._t.ring[row] = ring
        self._t.omega[row] = omega
        self._t.rev[row] = rev
        self._t.conf[row] = conf
        self._t.source[row] = source
        self._views.pop(row, None)

    def _materialize(self, row: int, action_id: str) -> ClassificationResult:
        view = self._views.get(row)
        if view is None:
            view = self._views[row] = ClassificationResult(
                action_id=action_id,
                ring=ExecutionRing(int(self._t.ring[row])),
                risk_weight=float(self._t.omega[row]),
                reversibility=_REV_BY_CODE[int(self._t.rev[row])],
                confidence=float(self._t.conf[row]),
            )
        return view
