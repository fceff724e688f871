"""Collateral slashing: blacklist the vouchee, clip the vouchers, cascade.

Capability parity with reference `liability/slashing.py:43-147`: vouchee
sigma -> 0, each voucher clipped to sigma*(1-omega) with floor 0.05, bonds
released, recursive cascade to wiped vouchers bounded at depth 2, full slash
history retained.

This host engine is the exception-faithful scalar path; the batched
equivalent over the whole agent table is `ops.liability.slash_cascade`
(waves of masked edge passes — see that module for the equivalence
argument).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime
from typing import Optional

from hypervisor_tpu_torch.config import DEFAULT_CONFIG
from hypervisor_tpu_torch.liability.vouching import VouchingEngine
from hypervisor_tpu_torch.models import new_id
from hypervisor_tpu_torch.utils.clock import Clock, utc_now


@dataclass
class VoucherClip:
    """One collateral clip applied to a voucher."""

    voucher_did: str
    sigma_before: float
    sigma_after: float
    risk_weight: float
    vouch_id: str


@dataclass
class SlashResult:
    """Outcome of one slashing event (and its direct clips)."""

    slash_id: str
    vouchee_did: str
    vouchee_sigma_before: float
    vouchee_sigma_after: float  # always 0.0
    voucher_clips: list[VoucherClip]
    reason: str
    session_id: str
    timestamp: datetime = field(default_factory=utc_now)
    cascade_depth: int = 0


class SlashingEngine:
    """Joint-liability penalty enforcement over the vouch edge table.

    Cascade hardening (the slash-cascade adversarial scenario,
    `testing.scenarios`): a diamond in the vouch graph — W vouching for
    two agents that both wipe in one cascade — used to clip and even
    re-slash W once per path, double-charging its ledger and making the
    blast radius a function of graph multiplicity rather than depth.
    With `dedupe_cascade` (default ON) each agent settles AT MOST ONCE
    per root slash event: duplicate edges still release their bonds
    (the collateral genuinely backed the rogue) but produce no second
    clip, no second ledger charge, and no second cascade entry.
    Settlement order is canonical — vouchers clip in sorted-DID order,
    and the cascade recurses in that same order — so one seed replays
    one settlement sequence regardless of edge insertion order.
    `max_depth` overrides the config bound per call (drills probe the
    bound without rebuilding engines); `dedupe_cascade=False`
    reproduces the legacy per-path behavior for before/after scoring.
    """

    MAX_CASCADE_DEPTH = DEFAULT_CONFIG.trust.max_cascade_depth
    SIGMA_FLOOR = DEFAULT_CONFIG.trust.sigma_floor

    def __init__(
        self,
        vouching_engine: VouchingEngine,
        clock: Clock = utc_now,
        dedupe_cascade: bool = True,
    ) -> None:
        self._vouching = vouching_engine
        self._clock = clock
        self._history: list[SlashResult] = []
        self.dedupe_cascade = dedupe_cascade
        #: Duplicate per-agent clip/slash events suppressed by the
        #: visited-set guard (cumulative; the facade mirrors it into
        #: `hv_slash_cascade_deduped_total`).
        self.cascade_dedupes = 0

    def slash(
        self,
        vouchee_did: str,
        session_id: str,
        vouchee_sigma: float,
        risk_weight: float,
        reason: str,
        agent_scores: dict[str, float],
        cascade_depth: int = 0,
        max_depth: Optional[int] = None,
        _settled: Optional[set[str]] = None,
    ) -> SlashResult:
        """Blacklist `vouchee_did`, clip its vouchers, cascade to wiped ones.

        `agent_scores` (did -> sigma) is mutated in place, mirroring the
        reference contract. `_settled` threads the per-root-event
        visited set through the recursion — callers never pass it.
        """
        limit = self.MAX_CASCADE_DEPTH if max_depth is None else max_depth
        settled = _settled if _settled is not None else set()
        settled.add(vouchee_did)
        agent_scores[vouchee_did] = 0.0

        vouchers = self._vouching.get_vouchers_for(vouchee_did, session_id)
        if self.dedupe_cascade:
            # Canonical settlement order: clips apply (and the cascade
            # recurses) in sorted-DID order, independent of edge
            # insertion order. Legacy mode keeps insertion order.
            vouchers.sort(key=lambda v: (v.voucher_did, v.vouch_id))
        clips: list[VoucherClip] = []
        for vouch in vouchers:
            duplicate = (
                self.dedupe_cascade and vouch.voucher_did in settled
            )
            self._vouching.release_bond(vouch.vouch_id)
            if duplicate:
                # The bond is consumed but the voucher already settled
                # this cascade (clipped, slashed, or IS the rogue) —
                # a second penalty would double-charge it per edge.
                self.cascade_dedupes += 1
                continue
            settled.add(vouch.voucher_did)
            before = agent_scores.get(vouch.voucher_did, 0.0)
            after = max(before * (1.0 - risk_weight), self.SIGMA_FLOOR)
            agent_scores[vouch.voucher_did] = after
            clips.append(
                VoucherClip(
                    voucher_did=vouch.voucher_did,
                    sigma_before=before,
                    sigma_after=after,
                    risk_weight=risk_weight,
                    vouch_id=vouch.vouch_id,
                )
            )

        result = SlashResult(
            slash_id=new_id("slash"),
            vouchee_did=vouchee_did,
            vouchee_sigma_before=vouchee_sigma,
            vouchee_sigma_after=0.0,
            voucher_clips=clips,
            reason=reason,
            session_id=session_id,
            timestamp=self._clock(),
            cascade_depth=cascade_depth,
        )
        self._history.append(result)

        if cascade_depth < limit:
            wipe_line = self.SIGMA_FLOOR + DEFAULT_CONFIG.trust.cascade_wipe_epsilon
            for clip in clips:
                if clip.sigma_after < wipe_line and self._vouching.get_vouchers_for(
                    clip.voucher_did, session_id
                ):
                    self.slash(
                        vouchee_did=clip.voucher_did,
                        session_id=session_id,
                        vouchee_sigma=clip.sigma_after,
                        risk_weight=risk_weight,
                        reason=f"Cascade from {vouchee_did}: {reason}",
                        agent_scores=agent_scores,
                        cascade_depth=cascade_depth + 1,
                        max_depth=max_depth,
                        _settled=settled if self.dedupe_cascade else None,
                    )

        return result

    @property
    def history(self) -> list[SlashResult]:
        return list(self._history)
