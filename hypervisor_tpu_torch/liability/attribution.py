"""Shapley-inspired proportional fault attribution for saga failures.

Capability parity with reference `liability/attribution.py:66-207`: causal
DAG construction from per-agent action lists, raw scores weighted 50% direct
cause / 30% split among enabling failures / 20% proximity*risk, normalized
to sum 1.0, sorted most-liable-first, with history retained.

The scoring core is expressed over numpy arrays (one row per causal node)
so a batch of failed sagas can be attributed in one vectorized pass.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from datetime import datetime
from typing import Optional

import numpy as np

from hypervisor_tpu_torch.utils.clock import utc_now


@dataclass
class CausalNode:
    node_id: str = field(default_factory=lambda: uuid.uuid4().hex[:8])
    agent_did: str = ""
    action_id: str = ""
    step_id: str = ""
    timestamp: datetime = field(default_factory=utc_now)
    success: bool = True
    is_root_cause: bool = False
    dependencies: list[str] = field(default_factory=list)


@dataclass
class FaultAttribution:
    agent_did: str
    liability_score: float
    causal_contribution: float
    is_direct_cause: bool = False
    reason: str = ""


@dataclass
class AttributionResult:
    attribution_id: str = field(default_factory=lambda: f"attr:{uuid.uuid4().hex[:8]}")
    saga_id: str = ""
    session_id: str = ""
    timestamp: datetime = field(default_factory=utc_now)
    attributions: list[FaultAttribution] = field(default_factory=list)
    causal_chain_length: int = 0
    root_cause_agent: Optional[str] = None

    @property
    def agents_involved(self) -> list[str]:
        return [a.agent_did for a in self.attributions]

    def get_liability(self, agent_did: str) -> float:
        for a in self.attributions:
            if a.agent_did == agent_did:
                return a.liability_score
        return 0.0


class CausalAttributor:
    """Proportional liability: direct 0.5 + enabling 0.3 + proximity*risk 0.2."""

    DIRECT_CAUSE_WEIGHT = 0.5
    ENABLING_WEIGHT = 0.3
    PROXIMITY_WEIGHT = 0.2

    def __init__(self) -> None:
        self._history: list[AttributionResult] = []

    def build_causal_dag(
        self,
        agent_actions: dict[str, list[dict]],
        failure_step_id: str,
        failure_agent_did: str,
    ) -> list[CausalNode]:
        """Flatten {agent: [action dicts]} into causal nodes, marking the root."""
        nodes = []
        for agent_did, actions in agent_actions.items():
            for a in actions:
                nodes.append(
                    CausalNode(
                        agent_did=agent_did,
                        action_id=a.get("action_id", ""),
                        step_id=a.get("step_id", ""),
                        success=a.get("success", True),
                        is_root_cause=(
                            a.get("step_id") == failure_step_id
                            and agent_did == failure_agent_did
                        ),
                        dependencies=a.get("dependencies", []),
                    )
                )
        return nodes

    def attribute(
        self,
        saga_id: str,
        session_id: str,
        agent_actions: dict[str, list[dict]],
        failure_step_id: str,
        failure_agent_did: str,
        risk_weights: Optional[dict[str, float]] = None,
    ) -> AttributionResult:
        """Score every involved agent's share of the failure (sums to 1.0)."""
        risk_weights = risk_weights or {}
        nodes = self.build_causal_dag(agent_actions, failure_step_id, failure_agent_did)
        agents = list(agent_actions.keys())

        # Array form: one row per node.
        agent_idx = {a: i for i, a in enumerate(agents)}
        owner = np.array([agent_idx[n.agent_did] for n in nodes], np.int32)
        root = np.array([n.is_root_cause for n in nodes], bool)
        failed = np.array([not n.success for n in nodes], bool)
        risk = np.array([risk_weights.get(n.action_id, 0.5) for n in nodes], np.float32)

        n_agents = len(agents)
        per_agent_nodes = np.bincount(owner, minlength=n_agents).astype(np.float32)
        enabling = failed & ~root
        n_enabling = max(1, int(enabling.sum()))

        contrib = (
            self.DIRECT_CAUSE_WEIGHT * root.astype(np.float32)
            + (self.ENABLING_WEIGHT / n_enabling) * enabling.astype(np.float32)
            + self.PROXIMITY_WEIGHT * risk / np.maximum(1.0, per_agent_nodes[owner])
        )
        raw = np.bincount(owner, weights=contrib, minlength=n_agents)
        total = float(raw.sum()) or 1.0
        norm = raw / total

        attributions = [
            FaultAttribution(
                agent_did=a,
                liability_score=round(float(norm[i]), 4),
                causal_contribution=round(float(raw[i]), 4),
                is_direct_cause=(a == failure_agent_did),
                reason=(
                    "Direct cause of failure"
                    if a == failure_agent_did
                    else "Contributing factor"
                ),
            )
            for i, a in enumerate(agents)
        ]
        attributions.sort(key=lambda x: x.liability_score, reverse=True)

        result = AttributionResult(
            saga_id=saga_id,
            session_id=session_id,
            attributions=attributions,
            causal_chain_length=len(nodes),
            root_cause_agent=failure_agent_did,
        )
        self._history.append(result)
        return result

    @property
    def attribution_history(self) -> list[AttributionResult]:
        return list(self._history)
