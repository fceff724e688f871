"""Declarative saga DSL (`hypervisor_tpu.saga.dsl`, copied): dict/YAML
definitions -> a validated saga topology.

One `_distill` pass walks a definition against small spec tables and
either raises at the first problem (`parse`) or accumulates every
problem (`validate`), so the two entry points cannot drift apart.
`HypervisorState.create_saga_from_dsl` turns a parsed definition into a
SagaTable row.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass, field
from typing import Any, Optional

from hypervisor_tpu_torch.saga.fan_out import FanOutPolicy
from hypervisor_tpu_torch.saga.state_machine import SagaStep


class SagaDSLError(Exception):
    """Invalid saga DSL definition."""


def _fresh_saga_id() -> str:
    return f"saga:{secrets.token_hex(5)}"


# ── value types ─────────────────────────────────────────────────────────


@dataclass
class SagaDSLStep:
    id: str = ""
    action_id: str = ""
    agent: str = ""
    execute_api: str = ""
    undo_api: Optional[str] = None
    timeout: int = 300
    retries: int = 0
    checkpoint_goal: Optional[str] = None


@dataclass
class SagaDSLFanOut:
    policy: FanOutPolicy = FanOutPolicy.ALL_MUST_SUCCEED
    branch_step_ids: list[str] = field(default_factory=list)


@dataclass
class SagaDefinition:
    name: str = ""
    session_id: str = ""
    saga_id: str = field(default_factory=_fresh_saga_id)
    steps: list[SagaDSLStep] = field(default_factory=list)
    fan_outs: list[SagaDSLFanOut] = field(default_factory=list)
    metadata: dict[str, Any] = field(default_factory=dict)

    @property
    def step_ids(self) -> list[str]:
        return [s.id for s in self.steps]

    @property
    def fan_out_step_ids(self) -> set[str]:
        return {sid for fo in self.fan_outs for sid in fo.branch_step_ids}

    @property
    def sequential_steps(self) -> list[SagaDSLStep]:
        """Steps outside every fan-out group (run in declaration order)."""
        grouped = self.fan_out_step_ids
        return [s for s in self.steps if s.id not in grouped]


# ── schema tables ───────────────────────────────────────────────────────

#: Required string fields of the top-level definition.
_ROOT_REQUIRED = ("name", "session_id")

#: Required string fields of each step entry.
_STEP_REQUIRED = ("id", "action_id", "agent")

#: Optional step fields with their defaults (copied into SagaDSLStep).
_STEP_DEFAULTS: dict[str, Any] = {
    "execute_api": "",
    "undo_api": None,
    "timeout": 300,
    "retries": 0,
    "checkpoint_goal": None,
}


class _Problems:
    """Either raises at the first problem or accumulates all of them."""

    def __init__(self, accumulate: bool) -> None:
        self.accumulate = accumulate
        self.found: list[str] = []

    def report(self, message: str) -> None:
        if not self.accumulate:
            raise SagaDSLError(message)
        self.found.append(message)


def _distill(
    definition: dict[str, Any], problems: _Problems
) -> Optional[SagaDefinition]:
    """Single validation+construction pass shared by parse and validate."""
    for key in _ROOT_REQUIRED:
        if not definition.get(key):
            problems.report(f"Missing '{key}'")

    raw_steps = definition.get("steps") or []
    if not raw_steps:
        problems.report("Saga needs at least one step")
        return None  # nothing below is checkable

    steps: list[SagaDSLStep] = []
    declared: set[str] = set()
    for position, raw in enumerate(raw_steps):
        label = raw.get("id") or f"step[{position}]"
        ok = True
        for key in _STEP_REQUIRED:
            if not raw.get(key):
                problems.report(f"{label}: missing '{key}'")
                ok = False
        sid = raw.get("id")
        if sid:
            if sid in declared:
                problems.report(f"Duplicate step ID: {sid}")
                ok = False
            declared.add(sid)
        if ok:
            values = {k: raw.get(k, dflt) for k, dflt in _STEP_DEFAULTS.items()}
            steps.append(
                SagaDSLStep(
                    id=raw["id"],
                    action_id=raw["action_id"],
                    agent=raw["agent"],
                    **values,
                )
            )

    fan_outs: list[SagaDSLFanOut] = []
    for raw in definition.get("fan_out") or []:
        wanted = raw.get("policy", FanOutPolicy.ALL_MUST_SUCCEED.value)
        policy = next((p for p in FanOutPolicy if p.value == wanted), None)
        if policy is None:
            problems.report(
                f"Invalid fan-out policy: {wanted} "
                f"(one of {[p.value for p in FanOutPolicy]})"
            )
            continue
        branches = list(raw.get("branches") or ())
        if len(branches) < 2:
            problems.report("Fan-out needs at least 2 branches")
            continue
        unknown = [b for b in branches if b not in declared]
        for bad in unknown:
            problems.report(f"Fan-out branch '{bad}' is not a valid step ID")
        if not unknown:
            fan_outs.append(SagaDSLFanOut(policy=policy, branch_step_ids=branches))

    if problems.found:
        return None
    return SagaDefinition(
        name=definition["name"],
        session_id=definition["session_id"],
        saga_id=definition.get("saga_id") or _fresh_saga_id(),
        steps=steps,
        fan_outs=fan_outs,
        metadata=definition.get("metadata") or {},
    )


# ── entry points ────────────────────────────────────────────────────────


class SagaDSLParser:
    """Validating parser from plain dicts (YAML-loaded or literal)."""

    def parse(self, definition: dict[str, Any]) -> SagaDefinition:
        """Parse, raising SagaDSLError at the first structural problem."""
        spec = _distill(definition, _Problems(accumulate=False))
        if spec is None:  # unreachable: _Problems raises on any problem
            raise SagaDSLError("invalid saga definition")
        return spec

    def parse_yaml(self, text: str) -> SagaDefinition:
        """Parse a YAML document with yaml.safe_load (definitions are
        data, never code)."""
        try:
            import yaml
        except ImportError as e:
            raise SagaDSLError(
                "YAML definitions need pyyaml; pass a dict to parse() instead"
            ) from e
        try:
            loaded = yaml.safe_load(text)
        except yaml.YAMLError as e:
            raise SagaDSLError(f"Invalid YAML: {e}") from e
        if not isinstance(loaded, dict):
            raise SagaDSLError(
                f"YAML document must be a mapping, got {type(loaded).__name__}"
            )
        return self.parse(loaded)

    @staticmethod
    def validate(definition: dict[str, Any]) -> list[str]:
        """Collect every structural problem without raising (empty = valid)."""
        problems = _Problems(accumulate=True)
        _distill(definition, problems)
        return problems.found

    @staticmethod
    def to_saga_steps(definition: SagaDefinition) -> list[SagaStep]:
        return [
            SagaStep(
                step_id=s.id,
                action_id=s.action_id,
                agent_did=s.agent,
                execute_api=s.execute_api,
                undo_api=s.undo_api,
                timeout_seconds=s.timeout,
                max_retries=s.retries,
            )
            for s in definition.steps
        ]
