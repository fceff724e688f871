"""Vouching & bonding: Joint Liability's sigma_eff = sigma_L + omega * sum(bonds).

Capability parity with reference `liability/vouching.py:41-230` (min voucher
sigma 0.50, default 20% bond, 80% max exposure, direct+indirect cycle
rejection, per-vouch and per-session bond release, sigma_eff capped at 1.0).

Array-native re-design: the engine's authoritative store is SoA numpy
columns (voucher/vouchee/session handles, bond, active, expiry) — the host
mirror of the device `VouchTable`. Exposure and sigma_eff queries are
vectorized masked sums; cycle detection is an iterative frontier sweep over
the edge arrays (bounded by node count) instead of per-record dict scans.
`to_device()` exports the columns as the port's `VouchTable` (torch
tensors on a given device) for the batched ops in `ops.liability`.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import datetime, timezone
from typing import Optional

import numpy as np

from hypervisor_tpu_torch.config import DEFAULT_CONFIG
from hypervisor_tpu_torch.models import new_id
from hypervisor_tpu_torch.tables.intern import InternTable
from hypervisor_tpu_torch.utils.clock import Clock, utc_now


class VouchingError(Exception):
    """Vouching protocol violation."""


@dataclass
class VouchRecord:
    """View of one vouch edge (reference `vouching.py:19-38` shape)."""

    vouch_id: str
    voucher_did: str
    vouchee_did: str
    session_id: str
    bonded_sigma_pct: float
    bonded_amount: float
    created_at: datetime
    expiry: Optional[datetime] = None
    is_active: bool = True
    released_at: Optional[datetime] = None

    @property
    def is_expired(self) -> bool:
        if self.expiry is None:
            return False
        return datetime.now(timezone.utc) > self.expiry


_GROW = 256


class VouchingEngine:
    """Edge-array vouching engine with vectorized exposure/sigma_eff."""

    SCORE_SCALE = DEFAULT_CONFIG.trust.score_scale
    MIN_VOUCHER_SCORE = DEFAULT_CONFIG.trust.min_voucher_sigma
    DEFAULT_BOND_PCT = DEFAULT_CONFIG.trust.default_bond_pct
    DEFAULT_MAX_EXPOSURE = DEFAULT_CONFIG.trust.max_exposure

    def __init__(
        self,
        max_exposure: Optional[float] = None,
        clock: Clock = utc_now,
        on_vouch=None,
        on_release=None,
    ) -> None:
        self.max_exposure = max_exposure or self.DEFAULT_MAX_EXPOSURE
        self._clock = clock
        # Optional mirrors: the facade wires these so every bond created
        # or released here lands in the device VouchTable too (the
        # liability analog of the DeltaEngine sink).
        self._on_vouch = on_vouch
        self._on_release = on_release
        self.agents = InternTable()
        self.sessions = InternTable()
        # SoA edge columns (host mirror of tables.state.VouchTable)
        self._n = 0
        self._voucher = np.empty(_GROW, np.int32)
        self._vouchee = np.empty(_GROW, np.int32)
        self._session = np.empty(_GROW, np.int32)
        self._pct = np.empty(_GROW, np.float64)
        self._bond = np.empty(_GROW, np.float64)
        self._active = np.empty(_GROW, bool)
        self._expiry = np.empty(_GROW, np.float64)
        # row metadata kept host-side only
        self._ids: list[str] = []
        self._created: list[datetime] = []
        self._released: list[Optional[datetime]] = []
        self._row_of: dict[str, int] = {}

    # ── public API ───────────────────────────────────────────────────

    def vouch(
        self,
        voucher_did: str,
        vouchee_did: str,
        session_id: str,
        voucher_sigma: float,
        bond_pct: Optional[float] = None,
        expiry: Optional[datetime] = None,
    ) -> VouchRecord:
        """Create a bond; raises VouchingError on any protocol violation."""
        if voucher_did == vouchee_did:
            raise VouchingError("Cannot vouch for yourself")
        # Byzantine-input gate: NaN sigma/pct compare false against
        # every threshold below and would land a NaN bond in the edge
        # table (an escrow-conservation violation the sanitizer then
        # flags) — refuse non-finite inputs at the protocol boundary.
        if not np.isfinite(voucher_sigma):
            raise VouchingError(
                f"Voucher σ must be finite; got {voucher_sigma!r}"
            )
        if bond_pct is not None and not np.isfinite(bond_pct):
            raise VouchingError(f"bond_pct must be finite; got {bond_pct!r}")
        if voucher_sigma < self.MIN_VOUCHER_SCORE:
            raise VouchingError(
                f"Voucher σ ({voucher_sigma:.2f}) below minimum "
                f"({self.MIN_VOUCHER_SCORE:.2f})"
            )

        hr = self.agents.intern(voucher_did)
        he = self.agents.intern(vouchee_did)
        hs = self.sessions.intern(session_id)

        if self._reachable(frm=he, to=hr, session=hs):
            raise VouchingError(
                f"Circular vouching detected: {vouchee_did} already vouches for "
                f"{voucher_did} in session {session_id}"
            )

        pct = self.DEFAULT_BOND_PCT if bond_pct is None else bond_pct
        pct = float(np.clip(pct, 0.0, 1.0))
        bonded = voucher_sigma * pct

        current = self.get_total_exposure(voucher_did, session_id)
        limit = voucher_sigma * self.max_exposure
        if current + bonded > limit:
            raise VouchingError(
                f"Voucher {voucher_did} would exceed max exposure "
                f"({self.max_exposure:.0%} of σ). Current: {current:.3f}, "
                f"requested: {bonded:.3f}, limit: {limit:.3f}"
            )

        row = self._append(
            hr, he, hs, pct, bonded,
            np.inf if expiry is None else expiry.timestamp(),
        )
        record = self._view(row, expiry)
        if self._on_vouch is not None:
            self._on_vouch(record)
        return record

    def compute_sigma_eff(
        self,
        vouchee_did: str,
        session_id: str,
        vouchee_sigma: float,
        risk_weight: float,
    ) -> float:
        """sigma_eff = sigma_L + omega * sum(active bonds), capped at 1.0."""
        contribution = float(
            self._bond[: self._n][self._mask_vouchee(vouchee_did, session_id)].sum()
        )
        return min(vouchee_sigma + risk_weight * contribution, 1.0)

    def get_vouchers_for(self, agent_did: str, session_id: str) -> list[VouchRecord]:
        """All live vouch edges pointing at an agent in a session."""
        rows = np.nonzero(self._mask_vouchee(agent_did, session_id))[0]
        return [self._view(int(r)) for r in rows]

    def get_total_exposure(self, voucher_did: str, session_id: str) -> float:
        """Vectorized masked sum of a voucher's bonded sigma in a session."""
        hr = self.agents.lookup(voucher_did)
        hs = self.sessions.lookup(session_id)
        if hr < 0 or hs < 0:
            return 0.0
        n = self._n
        m = (
            (self._voucher[:n] == hr)
            & (self._session[:n] == hs)
            & self._live_mask()
        )
        return float(self._bond[:n][m].sum())

    def release_bond(self, vouch_id: str) -> None:
        row = self._row_of.get(vouch_id)
        if row is None:
            raise VouchingError(f"Vouch {vouch_id} not found")
        self._active[row] = False
        self._released[row] = self._clock()
        if self._on_release is not None:
            self._on_release(vouch_id)

    def release_session_bonds(self, session_id: str) -> int:
        """Release every live bond in the session; returns the count."""
        hs = self.sessions.lookup(session_id)
        if hs < 0:
            return 0
        n = self._n
        m = (self._session[:n] == hs) & self._active[:n]
        rows = np.nonzero(m)[0]
        now = self._clock()
        self._active[rows] = False
        for r in rows:
            self._released[int(r)] = now
            if self._on_release is not None:
                self._on_release(self._ids[int(r)])
        return int(len(rows))

    # ── record iteration (API/stats surface) ─────────────────────────

    @property
    def vouch_count(self) -> int:
        """Total edges ever created (active or released)."""
        return self._n

    def all_records(self) -> list[VouchRecord]:
        return [self._view(r) for r in range(self._n)]

    def record(self, vouch_id: str):
        """The record for one vouch id, or None (O(1) row lookup)."""
        row = self._row_of.get(vouch_id)
        return None if row is None else self._view(row)

    def session_records(self, session_id: str) -> list[VouchRecord]:
        hs = self.sessions.lookup(session_id)
        if hs < 0:
            return []
        rows = np.nonzero(self._session[: self._n] == hs)[0]
        return [self._view(int(r)) for r in rows]

    def agent_records(self, agent_did: str) -> list[VouchRecord]:
        """Every edge where the agent is voucher or vouchee."""
        h = self.agents.lookup(agent_did)
        if h < 0:
            return []
        n = self._n
        rows = np.nonzero((self._voucher[:n] == h) | (self._vouchee[:n] == h))[0]
        return [self._view(int(r)) for r in rows]

    # ── device export ────────────────────────────────────────────────

    def to_device(self, capacity: Optional[int] = None, device="cuda"):
        """Snapshot the edge columns as the port's `VouchTable` on `device`
        ("cuda" by default; it raises without CUDA)."""
        import torch

        from hypervisor_tpu_torch import resolve_device
        from hypervisor_tpu_torch.tables.state import VouchTable

        dev = resolve_device(device)
        n = self._n
        cap = capacity or max(1, 1 << (n - 1).bit_length() if n else 1)
        if cap < n:
            raise ValueError(f"capacity {cap} < live edges {n}")

        def col(src, fill, dtype):
            out = np.full(cap, fill, dtype)
            out[:n] = src[:n]
            return torch.from_numpy(out).to(dev)

        return VouchTable(
            voucher=col(self._voucher, -1, np.int32),
            vouchee=col(self._vouchee, -1, np.int32),
            session=col(self._session, -1, np.int32),
            bond_pct=col(self._pct, 0, np.float32),
            bond=col(self._bond, 0, np.float32),
            active=col(self._active, False, bool),
            expiry=col(self._expiry[:n].astype(np.float32), np.inf, np.float32),
        )

    # ── internals ────────────────────────────────────────────────────

    def _live_mask(self) -> np.ndarray:
        n = self._n
        return self._active[:n] & (self._expiry[:n] >= self._clock().timestamp())

    def _mask_vouchee(self, vouchee_did: str, session_id: str) -> np.ndarray:
        he = self.agents.lookup(vouchee_did)
        hs = self.sessions.lookup(session_id)
        n = self._n
        if he < 0 or hs < 0:
            return np.zeros(n, bool)
        return (self._vouchee[:n] == he) & (self._session[:n] == hs) & self._live_mask()

    def _reachable(self, frm: int, to: int, session: int) -> bool:
        """Is `to` reachable from `frm` along live voucher->vouchee edges?

        Rejects both direct cycles (to vouches frm already ... ) and indirect
        chains, mirroring `vouching.py:199-230`. Iterative frontier expansion
        over the edge arrays; each step is a vectorized isin.
        """
        n = self._n
        if n == 0:
            return False
        live = self._live_mask() & (self._session[:n] == session)
        src = self._voucher[:n][live]
        dst = self._vouchee[:n][live]
        if len(src) == 0:
            return False
        frontier = np.array([frm], np.int32)
        seen = {int(frm)}
        for _ in range(len(self.agents)):
            step = dst[np.isin(src, frontier)]
            if len(step) == 0:
                return False
            if np.any(step == to):
                return True
            nxt = [int(x) for x in np.unique(step) if int(x) not in seen]
            if not nxt:
                return False
            seen.update(nxt)
            frontier = np.array(nxt, np.int32)
        return False

    def _append(
        self, hr: int, he: int, hs: int, pct: float, bond: float, expiry_ts: float
    ) -> int:
        n = self._n
        if n == len(self._voucher):
            grow = lambda a: np.concatenate([a, np.empty(len(a), a.dtype)])
            self._voucher = grow(self._voucher)
            self._vouchee = grow(self._vouchee)
            self._session = grow(self._session)
            self._pct = grow(self._pct)
            self._bond = grow(self._bond)
            self._active = grow(self._active)
            self._expiry = grow(self._expiry)
        self._voucher[n] = hr
        self._vouchee[n] = he
        self._session[n] = hs
        self._pct[n] = pct
        self._bond[n] = bond
        self._active[n] = True
        self._expiry[n] = expiry_ts
        vid = new_id("vouch")
        self._ids.append(vid)
        self._created.append(self._clock())
        self._released.append(None)
        self._row_of[vid] = n
        self._n = n + 1
        return n

    def _view(self, row: int, expiry: Optional[datetime] = None) -> VouchRecord:
        exp_ts = self._expiry[row]
        if expiry is None and np.isfinite(exp_ts):
            expiry = datetime.fromtimestamp(float(exp_ts), tz=timezone.utc)
        return VouchRecord(
            vouch_id=self._ids[row],
            voucher_did=self.agents.string(int(self._voucher[row])),
            vouchee_did=self.agents.string(int(self._vouchee[row])),
            session_id=self.sessions.string(int(self._session[row])),
            bonded_sigma_pct=float(self._pct[row]),
            bonded_amount=float(self._bond[row]),
            created_at=self._created[row],
            expiry=expiry,
            is_active=bool(self._active[row]),
            released_at=self._released[row],
        )
