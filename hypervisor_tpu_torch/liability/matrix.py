"""Liability matrix: the session's voucher->vouchee graph with path queries.

Capability parity with reference `liability/__init__.py:24-139` (edge
add/remove, who-vouches queries, exposure totals, cascade-path enumeration
bounded by depth, cycle detection). Re-designed around adjacency indices so
queries are O(degree) instead of O(edges), and cycle detection is an
iterative Kahn peel (no recursion) — the same bounded-iteration shape the
device-plane reachability op uses.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class LiabilityEdge:
    voucher_did: str
    vouchee_did: str
    bonded_amount: float
    vouch_id: str


class LiabilityMatrix:
    """Directed bond graph for one session."""

    def __init__(self, session_id: str) -> None:
        self.session_id = session_id
        self._edges: dict[str, LiabilityEdge] = {}          # vouch_id -> edge
        self._out: dict[str, list[str]] = {}                # voucher -> [vouch_id]
        self._in: dict[str, list[str]] = {}                 # vouchee -> [vouch_id]

    def add_edge(
        self, voucher_did: str, vouchee_did: str, bonded_amount: float, vouch_id: str
    ) -> LiabilityEdge:
        edge = LiabilityEdge(voucher_did, vouchee_did, bonded_amount, vouch_id)
        self._edges[vouch_id] = edge
        self._out.setdefault(voucher_did, []).append(vouch_id)
        self._in.setdefault(vouchee_did, []).append(vouch_id)
        return edge

    def remove_edge(self, vouch_id: str) -> None:
        edge = self._edges.pop(vouch_id, None)
        if edge is None:
            return
        self._out.get(edge.voucher_did, []).remove(vouch_id)
        self._in.get(edge.vouchee_did, []).remove(vouch_id)

    def who_vouches_for(self, agent_did: str) -> list[LiabilityEdge]:
        return [self._edges[v] for v in self._in.get(agent_did, ())]

    def who_is_vouched_by(self, agent_did: str) -> list[LiabilityEdge]:
        return [self._edges[v] for v in self._out.get(agent_did, ())]

    def total_exposure(self, voucher_did: str) -> float:
        return sum(self._edges[v].bonded_amount for v in self._out.get(voucher_did, ()))

    def cascade_path(self, agent_did: str, max_depth: int = 2) -> list[list[str]]:
        """All voucher->vouchee paths out of `agent_did` up to max_depth hops.

        A slash of `agent_did` would propagate along these paths.
        """
        paths: list[list[str]] = []
        stack: list[tuple[str, list[str]]] = [(agent_did, [agent_did])]
        while stack:
            node, path = stack.pop()
            if len(path) > max_depth + 1:
                continue
            nexts = [
                self._edges[v].vouchee_did
                for v in self._out.get(node, ())
                if self._edges[v].vouchee_did not in path
            ]
            if len(path) > 1 and (not nexts or len(path) == max_depth + 1):
                paths.append(path)
            for nxt in nexts:
                stack.append((nxt, path + [nxt]))
        return paths

    def has_cycle(self) -> bool:
        """Kahn's algorithm: a cycle exists iff the peel leaves nodes behind."""
        indeg: dict[str, int] = {}
        adj: dict[str, list[str]] = {}
        for e in self._edges.values():
            indeg.setdefault(e.voucher_did, 0)
            indeg[e.vouchee_did] = indeg.get(e.vouchee_did, 0) + 1
            adj.setdefault(e.voucher_did, []).append(e.vouchee_did)
        frontier = [n for n, d in indeg.items() if d == 0]
        removed = 0
        while frontier:
            n = frontier.pop()
            removed += 1
            for m in adj.get(n, ()):
                indeg[m] -= 1
                if indeg[m] == 0:
                    frontier.append(m)
        return removed < len(indeg)

    def clear(self) -> None:
        self._edges.clear()
        self._out.clear()
        self._in.clear()

    @property
    def edges(self) -> list[LiabilityEdge]:
        return list(self._edges.values())
