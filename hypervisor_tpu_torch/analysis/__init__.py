"""hvlint — the static contract analyzer, retargeted at the port.

The counterpart of `hypervisor_tpu.analysis`. The port's runtime
contracts (a WAL bracket around every state-mutating dispatch, per-call
`HV_*` env arming, the staging/policy lock discipline, append-only
registries, a plain twin beside every Hopper kernel, no host sync inside
a dispatched wave, a version counter that moves for every in-place
kernel write, the one-program fused wave) are proven over the whole
port tree:

  * **Tier A** (`rules_ast`) — pure-AST rules, no torch, no imports of
    the analyzed modules: WAL coverage (HVA001, in-place mutations
    included), env-arming (HVA002), lock discipline (HVA003),
    append-only registries vs `baseline.json` (HVA004), kernel/plain
    twin parity (HVA005).
  * **Tier B** (`dispatch_lint`, the counterpart of `jaxpr_lint`) — runs
    the dispatched functions at tiny shapes on a device and lints what
    they did: no host sync inside a wave (HVB001), every in-place kernel
    write moves its version counter (HVB002), the fused wave enters no
    other instrumented entry (HVB003).

CLI: `python -m hypervisor_tpu_torch.analysis --tier a|b|all
[--device cuda|cpu] [--json]`. Exceptions live in `suppressions.json`,
each with a mandatory justification; the registries' append-only
baseline in `baseline.json`.
"""

from hypervisor_tpu_torch.analysis.findings import (
    Finding,
    Suppression,
    apply_suppressions,
    load_suppressions,
    unsuppressed,
)
from hypervisor_tpu_torch.analysis.rules_ast import (
    TIER_A_RULES,
    PortProject,
    current_registries,
    derive_entry_points,
    derive_journal_ops,
    derive_replay_ops,
    run_tier_a,
)
from hypervisor_tpu_torch.analysis.walker import ModuleAst, Project

__all__ = [
    "Finding",
    "ModuleAst",
    "PortProject",
    "Project",
    "Suppression",
    "TIER_A_RULES",
    "apply_suppressions",
    "current_registries",
    "derive_entry_points",
    "derive_journal_ops",
    "derive_replay_ops",
    "derived_wal_ops",
    "load_suppressions",
    "run_tier_a",
    "unsuppressed",
]


def derived_wal_ops() -> set[str]:
    """The journal-op set hvlint derives from state.py's AST: the static
    half of the WAL/REPLAY correspondence pin (the port's tests assert it
    equals the runtime REPLAY registry, so neither can drift from the
    checker)."""
    from pathlib import Path

    project = Project.load(Path(__file__).resolve().parent.parent)
    state_mod = project.module("state.py")
    assert state_mod is not None
    return set(derive_journal_ops(state_mod))
