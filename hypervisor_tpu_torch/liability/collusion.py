"""Vouch-collusion clique detection over the liability graph.

The sigma-pump attack: a clique of agents joins with just-admissible
sigma, bonds aggressively WITHIN the clique to pump each member's
sigma_eff (sigma_L + omega * sum(bonds)), then the most-pumped member
defects — the cascade clips only fellow conspirators (who never had
honest collateral at stake) and the clique re-forms under fresh DIDs.
Cycle rejection (`vouching._reachable`) does not stop it: a layered DAG
clique pumps just as well as a cycle would.

`CollusionDetector` scans the live vouch graph for exactly that
structure. Per session, the active edges partition into undirected
connected components; each component of at least `min_size` members is
scored on three normalized signals:

  * **density** — internal edges / C(n, 2). Honest vouching is sparse
    (a sponsor per newcomer); a pump clique needs many internal edges
    to move sigma_eff.
  * **dual-role fraction** — members who BOTH give and receive bonds
    inside the component. The honest dense shape (a reputable hub
    vouching for many newcomers) scores ~0 here: the hub only gives,
    the leaves only receive. A pump ring needs most members on both
    sides of the ledger.
  * **internal bond fraction** — of the members' total bonded sigma in
    the session, the share that stays inside the component. Colluders
    concentrate their collateral on each other.

A component is flagged when every signal clears its threshold; the
finding's score is the mean of the three. Pure host numpy over the
`VouchingEngine` SoA columns — the same mirror the device VouchTable is
exported from — so a scan is cheap enough for sweep cadence
(`docs/OPERATIONS.md` "Ticks the operator owns"). The facade wires
scans via `Hypervisor.detect_collusion` (ledger risk charge + event).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class CollusionFinding:
    """One suspicious component of the session's vouch graph."""

    session_id: str
    members: tuple[str, ...]
    density: float
    dual_role_fraction: float
    internal_bond_fraction: float
    edges: int
    score: float

    def to_dict(self) -> dict:
        return {
            "session_id": self.session_id,
            "members": list(self.members),
            "density": round(self.density, 4),
            "dual_role_fraction": round(self.dual_role_fraction, 4),
            "internal_bond_fraction": round(self.internal_bond_fraction, 4),
            "edges": self.edges,
            "score": round(self.score, 4),
        }


@dataclass
class CollusionDetector:
    """Threshold scanner for sigma-pump cliques.

    Defaults are tuned so the honest shapes in the test corpus (sparse
    sponsor chains, reputable hubs fanning out) never flag while a
    4-member layered pump clique always does; drills can arm them
    tighter. All three thresholds must clear for a finding.
    """

    min_size: int = 3
    density_threshold: float = 0.5
    dual_role_threshold: float = 0.5
    internal_bond_threshold: float = 0.75
    scans: int = field(default=0, init=False)
    findings_total: int = field(default=0, init=False)

    def scan(self, vouching, session_id: str | None = None):
        """Scan the engine's live edges; returns [CollusionFinding].

        `session_id` narrows to one session; None scans every session
        with live edges. Deterministic: members and findings sort by
        DID / session string, so a seeded drill replays identically.
        """
        self.scans += 1
        n = vouching._n
        if n == 0:
            return []
        live = vouching._live_mask()
        sessions = vouching._session[:n]
        findings: list[CollusionFinding] = []
        if session_id is not None:
            hs = vouching.sessions.lookup(session_id)
            if hs < 0:
                return []
            session_handles = [int(hs)]
        else:
            session_handles = sorted(
                int(s) for s in np.unique(sessions[live])
            )
        for hs in session_handles:
            mask = live & (sessions == hs)
            if not mask.any():
                continue
            findings.extend(
                self._scan_session(
                    vouching,
                    vouching.sessions.string(hs),
                    vouching._voucher[:n][mask],
                    vouching._vouchee[:n][mask],
                    vouching._bond[:n][mask],
                )
            )
        findings.sort(key=lambda f: (f.session_id, f.members))
        self.findings_total += len(findings)
        return findings

    def _scan_session(
        self, vouching, session_id: str, src, dst, bond
    ) -> list[CollusionFinding]:
        # Union-find over the session's undirected vouch graph.
        parent: dict[int, int] = {}

        def find(x: int) -> int:
            while parent.setdefault(x, x) != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for a, b in zip(src, dst):
            ra, rb = find(int(a)), find(int(b))
            if ra != rb:
                parent[ra] = rb

        components: dict[int, set[int]] = {}
        for node in parent:
            components.setdefault(find(node), set()).add(node)

        # Per-voucher total bonded sigma in the SESSION (the
        # internal-fraction denominator — colluders may also bond
        # outward as cover; that lowers the fraction, as it should).
        total_out: dict[int, float] = {}
        for a, w in zip(src, bond):
            total_out[int(a)] = total_out.get(int(a), 0.0) + float(w)

        out = []
        for members in components.values():
            m = len(members)
            if m < self.min_size:
                continue
            internal = [
                (int(a), int(b), float(w))
                for a, b, w in zip(src, dst, bond)
                if int(a) in members and int(b) in members
            ]
            density = len(internal) / (m * (m - 1) / 2)
            gives = {a for a, _, _ in internal}
            takes = {b for _, b, _ in internal}
            dual = len(gives & takes) / m
            internal_out = sum(w for _, _, w in internal)
            member_out = sum(total_out.get(node, 0.0) for node in members)
            internal_frac = (
                internal_out / member_out if member_out > 0 else 0.0
            )
            if (
                density >= self.density_threshold
                and dual >= self.dual_role_threshold
                and internal_frac >= self.internal_bond_threshold
            ):
                out.append(
                    CollusionFinding(
                        session_id=session_id,
                        members=tuple(
                            sorted(
                                vouching.agents.string(node)
                                for node in members
                            )
                        ),
                        density=min(density, 1.0),
                        dual_role_fraction=dual,
                        internal_bond_fraction=min(internal_frac, 1.0),
                        edges=len(internal),
                        score=(
                            min(density, 1.0)
                            + dual
                            + min(internal_frac, 1.0)
                        )
                        / 3.0,
                    )
                )
        return out


__all__ = ["CollusionDetector", "CollusionFinding"]
