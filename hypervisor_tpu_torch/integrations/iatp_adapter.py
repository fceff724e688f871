"""IATP adapter: capability manifests -> actions, ring hints, sigma hints.

Capability parity with reference `integrations/iatp_adapter.py:94-253`:
trust level -> ring hint map, IATP 0-10 trust score -> sigma hint,
capabilities -> ActionDescriptor extraction (object and dict forms — the
dict form exists for testing/standalone use), reversible/non-reversible
flags, per-agent analysis caching.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Optional, Protocol

from hypervisor_tpu_torch.models import ActionDescriptor, ExecutionRing, ReversibilityLevel
from hypervisor_tpu_torch.utils.clock import Clock, utc_now


class IATPManifest(Protocol):
    """Contract of an IATP CapabilityManifest."""

    agent_id: str
    trust_level: Any
    capabilities: Any
    scopes: list[str]

    def calculate_trust_score(self) -> int: ...


class IATPTrustLevel(str, enum.Enum):
    VERIFIED_PARTNER = "verified_partner"
    TRUSTED = "trusted"
    STANDARD = "standard"
    UNKNOWN = "unknown"
    UNTRUSTED = "untrusted"


TRUST_LEVEL_RING_HINTS = {
    IATPTrustLevel.VERIFIED_PARTNER: ExecutionRing.RING_1_PRIVILEGED,
    IATPTrustLevel.TRUSTED: ExecutionRing.RING_2_STANDARD,
    IATPTrustLevel.STANDARD: ExecutionRing.RING_2_STANDARD,
    IATPTrustLevel.UNKNOWN: ExecutionRing.RING_3_SANDBOX,
    IATPTrustLevel.UNTRUSTED: ExecutionRing.RING_3_SANDBOX,
}

REVERSIBILITY_MAP = {
    "full": ReversibilityLevel.FULL,
    "partial": ReversibilityLevel.PARTIAL,
    "none": ReversibilityLevel.NONE,
}

IATP_SCORE_SCALE = 10.0


@dataclass
class ManifestAnalysis:
    agent_did: str
    trust_level: IATPTrustLevel
    ring_hint: ExecutionRing
    iatp_trust_score: int
    sigma_hint: float
    actions: list[ActionDescriptor]
    scopes: list[str]
    has_reversible_actions: bool
    has_non_reversible_actions: bool
    analyzed_at: datetime = field(default_factory=utc_now)


class IATPAdapter:
    """Manifest analysis for session handshake enrichment."""

    def __init__(self, clock: Clock = utc_now) -> None:
        self._clock = clock
        self._cache: dict[str, ManifestAnalysis] = {}

    def analyze_manifest(self, manifest: IATPManifest) -> ManifestAnalysis:
        """Analyze a manifest object (IATP module or compatible)."""
        trust_level = _parse_trust_level(
            getattr(manifest.trust_level, "value", manifest.trust_level)
        )
        iatp_score = manifest.calculate_trust_score()
        actions = self._actions_from_capabilities(manifest)
        return self._finish(
            agent_did=manifest.agent_id,
            trust_level=trust_level,
            iatp_score=iatp_score,
            actions=actions,
            scopes=list(manifest.scopes) if manifest.scopes else [],
        )

    def analyze_manifest_dict(self, manifest_dict: dict) -> ManifestAnalysis:
        """Analyze a plain-dict manifest (testing / standalone)."""
        trust_level = _parse_trust_level(manifest_dict.get("trust_level", "unknown"))
        actions = [
            ActionDescriptor(
                action_id=cap.get("action_id", "unknown"),
                name=cap.get("name", ""),
                execute_api=cap.get("execute_api", ""),
                undo_api=cap.get("undo_api"),
                reversibility=REVERSIBILITY_MAP.get(
                    cap.get("reversibility", "none"), ReversibilityLevel.NONE
                ),
                is_read_only=cap.get("is_read_only", False),
                is_admin=cap.get("is_admin", False),
            )
            # "actions" is the primary key (`iatp_adapter.py:183`); a
            # "capabilities" list may also appear but can hold bare strings
            # (`examples/demo.py:340` in the reference), so only dict
            # entries there describe actions.
            for cap in (
                manifest_dict.get("actions")
                or [
                    c
                    for c in manifest_dict.get("capabilities") or []
                    if isinstance(c, dict)
                ]
            )
            if isinstance(cap, dict)
        ]
        return self._finish(
            agent_did=manifest_dict.get("agent_id", "unknown"),
            trust_level=trust_level,
            iatp_score=manifest_dict.get("trust_score", 5),
            actions=actions,
            scopes=manifest_dict.get("scopes", []),
        )

    def get_cached_analysis(self, agent_did: str) -> Optional[ManifestAnalysis]:
        return self._cache.get(agent_did)

    # ── internals ────────────────────────────────────────────────────

    def _finish(
        self,
        agent_did: str,
        trust_level: IATPTrustLevel,
        iatp_score: int,
        actions: list[ActionDescriptor],
        scopes: list[str],
    ) -> ManifestAnalysis:
        analysis = ManifestAnalysis(
            agent_did=agent_did,
            trust_level=trust_level,
            ring_hint=TRUST_LEVEL_RING_HINTS.get(
                trust_level, ExecutionRing.RING_3_SANDBOX
            ),
            iatp_trust_score=iatp_score,
            sigma_hint=min(max(iatp_score / IATP_SCORE_SCALE, 0.0), 1.0),
            actions=actions,
            scopes=scopes,
            has_reversible_actions=any(
                a.reversibility is not ReversibilityLevel.NONE for a in actions
            ),
            has_non_reversible_actions=any(
                a.reversibility is ReversibilityLevel.NONE and not a.is_read_only
                for a in actions
            ),
            analyzed_at=self._clock(),
        )
        self._cache[agent_did] = analysis
        return analysis

    @staticmethod
    def _actions_from_capabilities(manifest: IATPManifest) -> list[ActionDescriptor]:
        caps = manifest.capabilities
        if caps is None:
            return []
        rev_raw = getattr(caps, "reversibility", "none")
        rev_str = getattr(rev_raw, "value", rev_raw)
        rev_level = REVERSIBILITY_MAP.get(str(rev_str), ReversibilityLevel.NONE)

        undo_seconds = 0
        undo_window = getattr(caps, "undo_window", None)
        if undo_window:
            try:
                undo_seconds = int(str(undo_window).rstrip("smh"))
            except ValueError:
                pass

        return [
            ActionDescriptor(
                action_id=f"{manifest.agent_id}:default",
                name=f"Default action for {manifest.agent_id}",
                execute_api=f"/api/{manifest.agent_id}/execute",
                undo_api=(
                    f"/api/{manifest.agent_id}/undo"
                    if rev_level is not ReversibilityLevel.NONE
                    else None
                ),
                reversibility=rev_level,
                undo_window_seconds=undo_seconds,
            )
        ]


def _parse_trust_level(raw: Any) -> IATPTrustLevel:
    try:
        return IATPTrustLevel(str(raw))
    except ValueError:
        return IATPTrustLevel.UNKNOWN
