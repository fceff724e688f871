"""The port's hvlint (`hypervisor_tpu_torch.analysis`), on the CPU.

Mirrors `tests/unit/test_hvlint.py` class for class, with fixtures in the
port's idiom (tables written in place, `_plain` twins, `instrument`
without `jit`): per-rule fixtures (violating, clean, suppressed), the
zero-findings pin on the port tree, the seeded mutations (each yields
exactly its rule at the expected `file:line`, HVA001-HVA005 and
HVB001-HVB003), the dispatch linter's detection proofs (the counterpart
of the jaxpr linter's), the CLI, the twin surface (every kernel wrapper's
CPU route is exactly its plain twin), and the cross-package checks: the
copied `findings` and `walker` give the reference's results, and the
port's derived registries equal the reference's baseline name for name.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch

from hypervisor_tpu_torch.analysis import cli as hv_cli
from hypervisor_tpu_torch.analysis import dispatch_lint
from hypervisor_tpu_torch.analysis.findings import (
    RULE_BAD_SUPPRESSION,
    RULE_STALE_SUPPRESSION,
    Suppression,
    apply_suppressions,
    load_suppressions,
    unsuppressed,
)
from hypervisor_tpu_torch.analysis.rules_ast import PortProject, run_tier_a
from hypervisor_tpu_torch.analysis.walker import Project

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "hypervisor_tpu_torch"
ANALYSIS = PACKAGE / "analysis"
REF_ANALYSIS = REPO / "hypervisor_tpu" / "analysis"


def build_pkg(tmp_path: Path, files: dict[str, str]) -> Path:
    pkg = tmp_path / "pkg"
    for rel, src in files.items():
        path = pkg / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
    return pkg


def rules_of(findings):
    return sorted({f.rule for f in findings})


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def head_report():
    """One Tier A pass over the port tree (shared: it takes seconds)."""
    return hv_cli.run(tier="a")


@pytest.fixture(scope="module")
def tier_b_head():
    """One Tier B run on the CPU over the port's programs."""
    findings = dispatch_lint.run_tier_b(device="cpu")
    return (findings, list(dispatch_lint.run_tier_b.last_programs),
            dict(dispatch_lint.run_tier_b.last_wrappers))


# ── HVA001: WAL coverage, in-place mutations ─────────────────────────

STATE_JOURNALED = '''
class HypervisorState:
    def apply_thing(self, x):
        with self._journal("apply_thing", x=x):
            self.agents.f32[x, 0] = 1.0

    def _apply_helper(self):
        self.sessions.i32.copy_(self.sessions.i32 + 1)
'''

RECOVERY_OK = '''
REPLAY = {
    "apply_thing": lambda st, a: None,
}
'''

OPS_MOD = '''
def writes(agents, x):
    agents.f32[x] = 0.0
    return agents

def reads(agents):
    return agents.f32.sum()
'''

KERNEL_MOD = '''
def _wrote(*ts):
    pass

def frob(agents, x):
    if not _route(x):
        return frob_plain(agents, x)
    _wrote(agents.i32)
    return x

def frob_plain(agents, x):
    agents.i32[0] = 1
    return x
'''


def hva001(pkg, **kw):
    return [f for f in run_tier_a(pkg, **kw) if f.rule == "HVA001"]


class TestWalCoverage:
    def test_clean_when_journaled_and_handled(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "state.py": STATE_JOURNALED.replace(
                "def _apply_helper", "def unused_helper"
            ).replace("self.sessions.i32.copy_(self.sessions.i32 + 1)", "pass"),
            "resilience/recovery.py": RECOVERY_OK,
        })
        assert hva001(pkg) == []

    def test_unjournaled_column_store_flagged(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "state.py": (
                "class HypervisorState:\n"
                "    def clobber(self, row):\n"
                "        n = row + 1\n"
                "        self.agents.f32[row, 0] = 0.0\n"
            ),
            "resilience/recovery.py": "REPLAY = {}\n",
        })
        hits = hva001(pkg)
        assert [(f.anchor, f.line) for f in hits] == [("HypervisorState.clobber", 4)]
        assert "stores into a table column" in hits[0].message

    def test_unjournaled_inplace_method_through_a_local_alias_flagged(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "state.py": (
                "class HypervisorState:\n"
                "    def tick(self, new):\n"
                "        g = self.sagas\n"
                "        g.cursor.copy_(new)\n"
            ),
            "resilience/recovery.py": "REPLAY = {}\n",
        })
        hits = hva001(pkg)
        assert [(f.anchor, f.line) for f in hits] == [("HypervisorState.tick", 4)]
        assert "`copy_`" in hits[0].message

    def test_instrumented_entry_that_writes_a_table_flagged(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "ops/mod.py": OPS_MOD,
            "state.py": (
                "from pkg.ops import mod as m\n"
                "from pkg.observability import health as health_plane\n"
                '_WRITES = health_plane.instrument("writes", m.writes)\n'
                '_READS = health_plane.instrument("reads", m.reads)\n'
                "class HypervisorState:\n"
                "    def peek(self):\n"
                "        return _READS(self.agents)\n"
                "    def clobber(self):\n"
                "        _WRITES(self.agents, 3)\n"
            ),
            "resilience/recovery.py": "REPLAY = {}\n",
        })
        hits = hva001(pkg)
        assert [(f.anchor, f.line) for f in hits] == [("HypervisorState.clobber", 9)]
        assert "`_WRITES`" in hits[0].message

    def test_kernel_wrapper_that_marks_its_writes_flagged(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "kernels/k.py": KERNEL_MOD,
            "state.py": (
                "from pkg.kernels import k\n"
                "class HypervisorState:\n"
                "    def launch(self, x):\n"
                "        return k.frob(self.agents, x)\n"
            ),
            "resilience/recovery.py": "REPLAY = {}\n",
        })
        assert [(f.anchor, f.line) for f in hva001(pkg)] == [("HypervisorState.launch", 4)]

    def test_local_closure_given_a_whole_table_flagged(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "state.py": (
                "class HypervisorState:\n"
                "    def fold(self, mesh):\n"
                "        fn = self._fold_fn(mesh)\n"
                "        fn(self.sessions, 1)\n"
                "    def _fold_fn(self, mesh):\n"
                "        return mesh\n"
            ),
            "resilience/recovery.py": "REPLAY = {}\n",
        })
        assert [(f.anchor, f.line) for f in hva001(pkg)] == [("HypervisorState.fold", 4)]

    def test_rebind_still_flagged(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "state.py": (
                "class HypervisorState:\n"
                "    def clobber(self):\n"
                "        self.agents = None\n"
            ),
            "resilience/recovery.py": "REPLAY = {}\n",
        })
        hits = hva001(pkg)
        assert [(f.anchor, f.line) for f in hits] == [("HypervisorState.clobber", 3)]

    def test_helper_covered_through_journaled_caller(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "state.py": (
                "class HypervisorState:\n"
                "    def outer(self):\n"
                '        with self._journal("outer"):\n'
                "            self._inner()\n"
                "    def _inner(self):\n"
                "        self.agents.ring[0] = 1\n"
            ),
            "resilience/recovery.py": 'REPLAY = {"outer": None}\n',
        })
        assert hva001(pkg) == []

    def test_journaled_op_without_replay_handler(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "state.py": STATE_JOURNALED,
            "resilience/recovery.py": "REPLAY = {}\n",
        })
        assert "journal:apply_thing" in {f.anchor for f in hva001(pkg)}

    def test_dead_replay_handler_flagged(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "state.py": "class HypervisorState:\n    pass\n",
            "resilience/recovery.py": 'REPLAY = {"ghost_op": None}\n',
        })
        assert "replay:ghost_op" in {f.anchor for f in hva001(pkg)}


# ── HVA002: env-arming ───────────────────────────────────────────────


class TestEnvArming:
    def test_module_level_read_flagged(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "mod.py": "import os\nX = os.environ.get('HV_X', '1')\n",
        })
        hits = [f for f in run_tier_a(pkg) if f.rule == "HVA002"]
        assert [(f.line, f.anchor) for f in hits] == [(2, "env:HV_X")]

    def test_dataclass_field_default_flagged(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "mod.py": (
                "import dataclasses, os\n"
                "@dataclasses.dataclass\n"
                "class Cfg:\n"
                "    t: float = float(os.environ.get('HV_T', 1.0))\n"
            ),
        })
        hits = [f for f in run_tier_a(pkg) if f.rule == "HVA002"]
        assert [f.anchor for f in hits] == ["env:HV_T"]

    def test_argument_default_flagged(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "mod.py": (
                "import os\n"
                "def f(t=os.getenv('HV_T', '1')):\n"
                "    return t\n"
            ),
        })
        assert [f.anchor for f in run_tier_a(pkg) if f.rule == "HVA002"] == ["env:HV_T"]

    def test_function_body_and_factory_clean(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "mod.py": (
                "import dataclasses, os\n"
                "def f():\n"
                "    return os.environ.get('HV_X', '1')\n"
                "@dataclasses.dataclass\n"
                "class Cfg:\n"
                "    t: float = dataclasses.field(\n"
                "        default_factory=lambda: float(\n"
                "            os.environ.get('HV_T', 1.0)))\n"
            ),
        })
        assert [f for f in run_tier_a(pkg) if f.rule == "HVA002"] == []

    def test_non_hv_env_ignored(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "mod.py": "import os\nX = os.environ.get('CUDA_VISIBLE_DEVICES')\n",
        })
        assert [f for f in run_tier_a(pkg) if f.rule == "HVA002"] == []


# ── HVA003: lock discipline ──────────────────────────────────────────


class TestLockDiscipline:
    def test_unguarded_staging_mutation_flagged(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "mod.py": (
                "def leak(state, key, slot):\n"
                "    state._slot_of_member[key] = slot\n"
            ),
        })
        hits = [f for f in run_tier_a(pkg) if f.rule == "HVA003"]
        assert [(f.line, f.anchor) for f in hits] == [(2, "leak._slot_of_member")]

    def test_guarded_mutation_clean(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "mod.py": (
                "def ok(state, key, slot):\n"
                "    with state._enqueue_lock:\n"
                "        state._slot_of_member[key] = slot\n"
                "        state._free_agent_slots.append(slot)\n"
            ),
        })
        assert [f for f in run_tier_a(pkg) if f.rule == "HVA003"] == []

    def test_policy_swap_needs_policy_lock(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "mod.py": (
                "def swap(state, p):\n"
                "    with state._enqueue_lock:\n"
                "        state.degraded_policy = p\n"
            ),
        })
        hits = [f for f in run_tier_a(pkg) if f.rule == "HVA003"]
        assert [f.anchor for f in hits] == ["swap.degraded_policy"]

    def test_lock_alias_taint_recognized(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "mod.py": (
                "def swap(state, p, fallback):\n"
                "    lock = getattr(state, '_policy_lock', None) or fallback\n"
                "    with lock:\n"
                "        state.degraded_policy = p\n"
            ),
        })
        assert [f for f in run_tier_a(pkg) if f.rule == "HVA003"] == []

    def test_constructor_exempt(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "mod.py": (
                "class S:\n"
                "    def __init__(self):\n"
                "        self._members = set()\n"
                "        self.degraded_policy = None\n"
            ),
        })
        assert [f for f in run_tier_a(pkg) if f.rule == "HVA003"] == []

    def test_mutator_call_flagged(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "mod.py": "def leak(state, k):\n    state._members.add(k)\n",
        })
        assert [f.anchor for f in run_tier_a(pkg) if f.rule == "HVA003"] == ["leak._members"]


# ── HVA004: append-only registries ───────────────────────────────────

EVENT_BUS = '''
import enum
class EventType(str, enum.Enum):
    A = "plane.a"
    B = "plane.b"
'''

METRICS = '''
REGISTRY = object()
X = REGISTRY.counter("hv_x_total", "")
Y = REGISTRY.gauge("hv_y", "")
'''


class TestAppendOnly:
    def _baseline(self, tmp_path, doc) -> Path:
        p = tmp_path / "baseline.json"
        p.write_text(json.dumps(doc))
        return p

    def _pkg(self, tmp_path, event_bus=EVENT_BUS, metrics=METRICS,
             state="class HypervisorState:\n    pass\n"):
        return build_pkg(tmp_path, {
            "observability/event_bus.py": event_bus,
            "observability/metrics.py": metrics,
            "state.py": state,
            "resilience/recovery.py": "REPLAY = {}\n",
        })

    def _base_doc(self):
        return {
            "event_types": [["A", "plane.a"], ["B", "plane.b"]],
            "metric_series": [["counter", "hv_x_total"], ["gauge", "hv_y"]],
            "wal_ops": [],
        }

    def hva004(self, pkg, base):
        return [f for f in run_tier_a(pkg, baseline_path=base) if f.rule == "HVA004"]

    def test_clean_against_matching_baseline(self, tmp_path):
        assert self.hva004(self._pkg(tmp_path), self._baseline(tmp_path, self._base_doc())) == []

    def test_appending_is_allowed(self, tmp_path):
        pkg = self._pkg(
            tmp_path,
            event_bus=EVENT_BUS + '    C = "plane.c"\n',
            metrics=METRICS + 'Z = REGISTRY.histogram("hv_z", "")\n',
        )
        assert self.hva004(pkg, self._baseline(tmp_path, self._base_doc())) == []

    def test_reordered_event_codes_flagged(self, tmp_path):
        pkg = self._pkg(tmp_path, event_bus=EVENT_BUS.replace(
            'A = "plane.a"\n    B = "plane.b"', 'B = "plane.b"\n    A = "plane.a"'))
        hits = [f for f in self.hva004(pkg, self._baseline(tmp_path, self._base_doc()))
                if f.anchor.startswith("event_types")]
        assert hits and "plane.a" in hits[0].anchor

    def test_removed_metric_series_flagged(self, tmp_path):
        pkg = self._pkg(tmp_path,
                        metrics='REGISTRY = object()\nY = REGISTRY.gauge("hv_y", "")\n')
        hits = [f for f in self.hva004(pkg, self._baseline(tmp_path, self._base_doc()))
                if f.anchor.startswith("metric_series")]
        assert hits and "hv_x_total" in hits[0].anchor

    def test_removed_wal_op_flagged(self, tmp_path):
        doc = self._base_doc()
        doc["wal_ops"] = ["gone_op"]
        hits = [f for f in self.hva004(self._pkg(tmp_path), self._baseline(tmp_path, doc))
                if f.anchor == "wal_ops:gone_op"]
        assert len(hits) == 1

    def test_missing_baseline_is_a_finding(self, tmp_path):
        hits = self.hva004(self._pkg(tmp_path), tmp_path / "nope.json")
        assert hits and hits[0].anchor == "baseline"


# ── HVA005: twin parity, the port's `_plain` twins ──────────────────

WRAPPER = "def frob(x):\n    if not _route(x):\n        return frob_plain(x)\n    return x\n"


class TestTwinParity:
    def hva005(self, pkg, tests=None):
        return [f for f in run_tier_a(pkg, tests_dir=tests) if f.rule == "HVA005"]

    def _tests(self, tmp_path, files: dict[str, str]) -> Path:
        tests = tmp_path / "tests"
        tests.mkdir()
        for name, src in files.items():
            (tests / name).write_text(src)
        return tests

    def test_missing_twin_flagged(self, tmp_path):
        pkg = build_pkg(tmp_path, {"kernels/k.py": WRAPPER})
        hits = self.hva005(pkg)
        assert [(f.anchor, f.line) for f in hits] == [("frob", 1)]

    def test_a_function_without_the_cuda_route_is_no_kernel(self, tmp_path):
        pkg = build_pkg(tmp_path, {"kernels/k.py": "def frob(x):\n    return x\n"})
        assert self.hva005(pkg) == []

    def test_twin_without_test_reference_flagged(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "kernels/k.py": WRAPPER + "def frob_plain(x):\n    return x\n"})
        tests = self._tests(tmp_path, {"test_torch_other.py": "def test_x():\n    pass\n"})
        assert [f.anchor for f in self.hva005(pkg, tests)] == ["frob:test"]

    def test_named_pair_with_test_clean(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "kernels/k.py": WRAPPER + "def frob_plain(x):\n    return x\n"})
        tests = self._tests(tmp_path, {"test_torch_k.py": "# parity: frob vs frob_plain\n"})
        assert self.hva005(pkg, tests) == []

    def test_module_level_alias_is_a_twin(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "kernels/k.py": "from pkg.ops import other\n" + WRAPPER
            + "frob_plain = other.plain_frob\n"})
        tests = self._tests(tmp_path, {"test_torch_k.py": "# frob, frob_plain\n"})
        assert self.hva005(pkg, tests) == []

    def test_only_the_ports_tests_count(self, tmp_path):
        # A reference test naming the pair must not satisfy the port's rule.
        pkg = build_pkg(tmp_path, {
            "kernels/k.py": WRAPPER + "def frob_plain(x):\n    return x\n"})
        tests = self._tests(tmp_path, {"test_k.py": "# parity: frob vs frob_plain\n",
                                       "test_torch_other.py": "def test_x():\n    pass\n"})
        assert [f.anchor for f in self.hva005(pkg, tests)] == ["frob:test"]

    def test_naming_only_the_twin_does_not_name_the_kernel(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "kernels/k.py": WRAPPER + "def frob_plain(x):\n    return x\n"})
        tests = self._tests(tmp_path, {"test_torch_k.py": "# frob_plain only\n"})
        assert [f.anchor for f in self.hva005(pkg, tests)] == ["frob:test"]

    def test_private_kernels_ignored(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "kernels/k.py": "def _helper(x):\n    if not _route(x):\n        return x\n"})
        assert self.hva005(pkg) == []


# ── suppressions machinery ───────────────────────────────────────────


class TestSuppressions:
    def test_valid_suppression_silences_and_is_not_stale(self, tmp_path):
        pkg = build_pkg(tmp_path, {"mod.py": "import os\nX = os.environ.get('HV_X', '1')\n"})
        raw = [f for f in run_tier_a(pkg) if f.rule == "HVA002"]
        sups = [Suppression(
            rule="HVA002", file="pkg/mod.py", anchor="env:HV_X",
            justification="fixture: proves the suppression machinery works",
        )]
        out = apply_suppressions(raw, sups)
        assert unsuppressed(out) == []
        assert any(f.suppressed for f in out)

    def test_stale_suppression_is_a_finding(self):
        sups = [Suppression(
            rule="HVA002", file="pkg/ghost.py", anchor="env:HV_NOPE",
            justification="matches nothing on purpose (fixture)",
        )]
        assert rules_of(apply_suppressions([], sups)) == [RULE_STALE_SUPPRESSION]

    def test_staleness_scoped_to_active_rules(self):
        sups = [Suppression(
            rule="HVA002", file="pkg/ghost.py", anchor="env:HV_NOPE",
            justification="tier A entry during a tier B run (fixture)",
        )]
        assert apply_suppressions([], sups, active_rules={"HVB001"}) == []

    def test_justification_required_and_substantive(self, tmp_path):
        p = tmp_path / "s.json"
        p.write_text(json.dumps({"suppressions": [
            {"rule": "HVA002", "file": "x.py", "anchor": "env:HV_X",
             "justification": "legacy"},
            {"rule": "HVA002", "file": "x.py", "anchor": "env:HV_Y"},
        ]}))
        sups, findings = load_suppressions(p)
        assert sups == []
        assert rules_of(findings) == [RULE_BAD_SUPPRESSION]
        assert len(findings) == 2


# ── the port tree at HEAD ────────────────────────────────────────────


class TestRepoAtHead:
    def test_tier_a_zero_unsuppressed_findings(self, head_report):
        open_findings = [f for f in head_report["findings"] if not f["suppressed"]]
        assert open_findings == [], open_findings
        # Every suppression on file is used AND justified.
        assert head_report["counts"]["suppressed"] == \
            head_report["counts"]["suppressions_on_file"] == 4

    def test_suppressions_are_the_references_carried_to_the_port(self):
        """The reference's HVA001 mesh-reconcile and HVA003 `_rebuild`
        entries apply to the port's code with the same reasoning; its
        HVA005 `slash_cascade_pallas` entry does not (the port's B8
        wrapper has its `slash_cascade_plain` twin)."""
        port = json.loads((ANALYSIS / "suppressions.json").read_text())["suppressions"]
        ref = json.loads((REF_ANALYSIS / "suppressions.json").read_text())["suppressions"]
        carried = [(s["rule"], s["file"].replace("hypervisor_tpu/", "hypervisor_tpu_torch/"),
                    s["anchor"]) for s in ref if s["rule"] != "HVA005"]
        assert [(s["rule"], s["file"], s["anchor"]) for s in port] == carried

    def test_derived_registries_match_committed_baseline(self):
        from hypervisor_tpu_torch.analysis.rules_ast import current_registries

        cur = current_registries(Project.load(PACKAGE))
        base = json.loads((ANALYSIS / "baseline.json").read_text())
        for key in ("event_types", "metric_series", "wal_ops"):
            assert [tuple(x) if isinstance(x, list) else x for x in base[key]] == \
                [tuple(x) if isinstance(x, list) else x for x in cur[key]], key
        assert len(cur["event_types"]) >= 55
        assert len(cur["metric_series"]) >= 60
        assert len(cur["wal_ops"]) >= 31

    def test_derived_registries_equal_the_references_baseline(self):
        """Name for name and in order: the event codes, the metric rows
        and the WAL tags are wire formats both packages share (the WAL
        bytes are already equal, `tests/test_torch_resilience.py`)."""
        from hypervisor_tpu_torch.analysis.rules_ast import current_registries

        cur = current_registries(Project.load(PACKAGE))
        ref = json.loads((REF_ANALYSIS / "baseline.json").read_text())
        for key in ("event_types", "metric_series", "wal_ops"):
            assert cur[key] == ref[key], key

    def test_derived_wal_ops_equal_the_replay_registry(self):
        from hypervisor_tpu_torch.analysis import derived_wal_ops
        from hypervisor_tpu_torch.resilience.recovery import REPLAY

        assert derived_wal_ops() == set(REPLAY)
        assert len(REPLAY) == 31

    def test_entry_points_are_the_instrumented_dispatches_of_state(self):
        from hypervisor_tpu_torch import state as port_state
        from hypervisor_tpu_torch.analysis.rules_ast import derive_entry_points
        from hypervisor_tpu_torch.observability.health import CompileWatch

        entries = derive_entry_points(Project.load(PACKAGE).module("state.py"))
        assert len(entries) == 19
        watched = {v.name for v in vars(port_state).values() if isinstance(v, CompileWatch)}
        assert set(entries) == watched
        assert {"governance_wave", "gateway_check_actions", "update_gauges",
                "tenant_governance_wave_donated"} <= set(entries)

    def test_every_inplace_wrapper_is_a_registered_kernel(self):
        from hypervisor_tpu_torch import kernels
        from hypervisor_tpu_torch.analysis.rules_ast import (
            derive_inplace_wrappers, derive_kernel_wrappers,
        )

        project = PortProject.load(PACKAGE)
        assert {n for _, n, _ in derive_kernel_wrappers(project)} == set(kernels.WRAPPERS)
        assert {n for _, n, _ in derive_inplace_wrappers(project)} == {
            "admission_block", "admission_block_tenants", "fsm_saga_block",
            "fsm_saga_block_tenants", "chain_digests_ring", "chain_digests_ring_tenants",
            "saga_tick_block", "slash_cascade",
        }


class TestSeededMutations:
    """Each seeded mutation yields EXACTLY the expected rule id at the
    expected file:line."""

    def test_deleting_one_wal_bracket_is_caught(self, tmp_path):
        src = (PACKAGE / "state.py").read_text()
        needle = 'with self._journal("breach_sweep_tick", now=float(now)):'
        assert needle in src
        mutated = src.replace(needle, "if True:  # bracket deleted")
        pkg = build_pkg(tmp_path, {
            "state.py": mutated,
            "resilience/recovery.py": (PACKAGE / "resilience/recovery.py").read_text(),
        })
        # The tree's one raw HVA001 finding (suppressed on file) stands;
        # the mutation adds exactly the de-bracketed method and its
        # now-dead REPLAY handler.
        baseline = {f.anchor for f in hva001(build_pkg(tmp_path / "head", {
            "state.py": src,
            "resilience/recovery.py": (PACKAGE / "resilience/recovery.py").read_text(),
        }))}
        assert baseline == {"HypervisorState.reconcile_session_partials"}
        hits = [f for f in hva001(pkg) if f.anchor not in baseline]
        lines = mutated.splitlines()
        def_line = next(i for i, l in enumerate(lines, 1)
                        if l.lstrip().startswith("def breach_sweep_tick"))
        # `_BREACH_SWEEP` reads the table; the first write is the store
        # of its flags column.
        first_write = next(i for i, l in enumerate(lines, 1)
                           if i > def_line and l.strip().startswith("self.agents.i32["))
        assert {(f.anchor, f.file) for f in hits} == {
            ("HypervisorState.breach_sweep_tick", "pkg/state.py"),
            ("replay:breach_sweep_tick", "pkg/resilience/recovery.py"),
        }
        got = next(f for f in hits if f.anchor == "HypervisorState.breach_sweep_tick")
        assert got.line == first_write

    def test_import_time_hv_read_is_caught(self, tmp_path):
        src = (PACKAGE / "serving/front_door.py").read_text()
        mutated = src + "\n_SEEDED = os.environ.get('HV_SEEDED_BAD', '0')\n"
        pkg = build_pkg(tmp_path, {"serving/front_door.py": mutated})
        hits = [f for f in run_tier_a(pkg) if f.rule == "HVA002"]
        assert [(f.file, f.line, f.anchor) for f in hits] == [(
            "pkg/serving/front_door.py", len(mutated.splitlines()), "env:HV_SEEDED_BAD",
        )]

    def test_unguarded_staging_write_is_caught(self, tmp_path):
        src = (PACKAGE / "state.py").read_text()
        needle = "        with self._enqueue_lock:\n"
        i = src.index(needle)
        # Unlock the first staging-locked block: its body runs unguarded.
        mutated = src[:i] + "        if True:  # lock deleted\n" + src[i + len(needle):]
        pkg = build_pkg(tmp_path, {"state.py": mutated})
        hits = [f for f in run_tier_a(pkg) if f.rule == "HVA003"]
        assert rules_of(hits) == ["HVA003"]
        line = mutated[:i].count("\n") + 1
        assert all(f.file == "pkg/state.py" and f.line > line for f in hits)
        # `_claim_wave_rows`: its first guarded write is the bump cursor.
        assert [(f.anchor, f.line) for f in hits] == [(
            "_claim_wave_rows._next_agent_slot",
            next(j for j, l in enumerate(mutated.splitlines(), 1)
                 if j > line and "self._next_agent_slot += fresh_n" in l),
        )]

    def test_reordered_event_code_is_caught(self, tmp_path):
        src = (PACKAGE / "observability/event_bus.py").read_text()
        a, b = '    SESSION_CREATED = "session.created"\n', '    SESSION_JOINED = "session.joined"\n'
        mutated = src.replace(a + b, b + a)
        assert mutated != src
        pkg = build_pkg(tmp_path, {"observability/event_bus.py": mutated})
        hits = [f for f in run_tier_a(pkg, baseline_path=ANALYSIS / "baseline.json")
                if f.rule == "HVA004"]
        assert [(f.file, f.line, f.anchor) for f in hits] == [
            ("pkg/observability/event_bus.py", 1, "event_types:session.created")]

    def test_deleting_a_twin_alias_is_caught(self, tmp_path):
        src = (PACKAGE / "kernels/sha256.py").read_text()
        mutated = src.replace("sha256_words_plain = sha256_blocks\n", "")
        assert mutated != src
        pkg = build_pkg(tmp_path, {"kernels/sha256.py": mutated})
        hits = [f for f in run_tier_a(pkg) if f.rule == "HVA005"]
        line = next(i for i, l in enumerate(mutated.splitlines(), 1)
                    if l.startswith("def sha256_words("))
        assert [(f.file, f.line, f.anchor) for f in hits] == [
            ("pkg/kernels/sha256.py", line, "sha256_words")]

    def test_host_sync_in_a_wave_is_caught(self, tmp_path):
        path = tmp_path / "seeded_wave.py"
        path.write_text(
            "import torch\n"
            "def wave(x):\n"
            "    y = x * 2\n"
            "    n = int(y.sum())\n"
            "    return y[y > 2], n\n"
        )
        mod = load_module(path, "seeded_wave_hvb001")
        findings, _ = dispatch_lint.lint_program(
            "seeded", lambda: mod.wave(torch.arange(4)), lints={"host_sync"}, root=REPO)
        assert [(f.rule, f.file, f.line) for f in findings] == [
            ("HVB001", path.as_posix(), 4), ("HVB001", path.as_posix(), 5)]

    def test_raw_pointer_write_without_a_version_bump_is_caught(self, tmp_path):
        path = tmp_path / "seeded_wrapper.py"
        path.write_text(
            "import torch\n"
            "def frob(t):\n"
            "    t.numpy()[0] = 7\n"
            "    return t\n"
            "def frob_marked(t):\n"
            "    t.numpy()[0] = 7\n"
            "    torch.autograd.graph.increment_version(t)\n"
            "    return t\n"
        )
        mod = load_module(path, "seeded_wrapper_hvb002")
        wrappers = {"frob": mod.frob, "frob_marked": mod.frob_marked}
        findings, wrote = dispatch_lint.lint_program(
            "seeded", lambda: (mod.frob(torch.zeros(4)), mod.frob_marked(torch.zeros(4))),
            lints={"versions"}, root=REPO, wrappers=wrappers)
        assert [(f.rule, f.file, f.line, f.anchor) for f in findings] == [
            ("HVB002", path.as_posix(), 2, "frob:t")]
        assert wrote == {"frob": {"t"}, "frob_marked": {"t"}}

    def test_nested_instrumented_entry_is_caught(self, tmp_path, monkeypatch):
        from hypervisor_tpu_torch.observability import health

        # A private compile log: the seeded watch stays out of the
        # process-global one other tests read.
        monkeypatch.setattr(health, "_LOG", health._CompileLog())
        path = tmp_path / "seeded_nested.py"
        path.write_text(
            "from hypervisor_tpu_torch.observability import health\n"
            "INNER = health.instrument('check_actions_seeded', lambda x: x + 1)\n"
            "def wave(x):\n"
            "    y = x * 2\n"
            "    return INNER(y)\n"
        )
        mod = load_module(path, "seeded_nested_hvb003")
        findings, _ = dispatch_lint.lint_program(
            "seeded", lambda: mod.wave(torch.ones(4)), lints={"one_program"}, root=REPO)
        assert [(f.rule, f.file, f.line, f.anchor) for f in findings] == [
            ("HVB003", path.as_posix(), 5, "seeded:check_actions_seeded")]

    def test_host_reads_in_a_wrappers_cuda_route_and_csrc_are_caught(self, tmp_path):
        pkg = build_pkg(tmp_path, {
            "kernels/k.py": (
                "def frob(x):\n"
                "    if not _route(x):\n"
                "        return frob_plain(x)\n"
                "    n = x.sum().item()\n"
                "    with work.paused():\n"
                "        cs = x.tolist()\n"
                "    return x\n"
                "def frob_plain(x):\n"
                "    return x.tolist()\n"
            ),
            "csrc/k.cu": (
                "// cudaDeviceSynchronize() in a comment is fine\n"
                "int hv_frob(void* s) {\n"
                "  cudaDeviceSynchronize();\n"
                "  return 0;\n"
                "}\n"
            ),
        })
        findings = dispatch_lint.lint_wrapper_sources(pkg)
        assert [(f.rule, f.file, f.line) for f in findings] == [
            ("HVB001", "pkg/kernels/k.py", 4), ("HVB001", "pkg/csrc/k.cu", 3)]


# ── the dispatch linter (the jaxpr linter's counterpart) ─────────────


class TestDispatchLint:
    @pytest.mark.parametrize("body, what", [
        ("x.sum().item()", "Tensor.item"),
        ("bool(x.any())", "aten._local_scalar_dense"),
        ("torch.nonzero(x)", "aten.nonzero"),
        ("x[x > 1]", "aten.index[bool mask]"),
        ("torch.unique(x)", "aten._unique2"),
        ("x.cpu()", "Tensor.cpu"),
        ("x.tolist()", "Tensor.tolist"),
        ("x.numpy()", "Tensor.numpy"),
    ])
    def test_each_host_sync_is_detected(self, body, what):
        findings, _ = dispatch_lint.lint_program(
            "synthetic", lambda: eval(body, {"torch": torch, "x": torch.arange(4)}),
            lints={"host_sync"}, root=REPO)
        assert [f.rule for f in findings] == ["HVB001"]
        assert findings[0].anchor == f"synthetic:{what}"

    def test_device_ops_are_clean(self):
        x = torch.arange(8, dtype=torch.int32)
        findings, _ = dispatch_lint.lint_program(
            "synthetic", lambda: torch.where(x > 2, x * 3, x).cumsum(0).to(torch.int64),
            lints={"host_sync"}, root=REPO)
        assert findings == []

    def test_ops_inside_a_kernel_wrapper_stand_for_its_launch(self):
        def frob(x):  # a wrapper's plain route may read the host
            return x[torch.nonzero(x).squeeze(1)].sum().item()

        findings, _ = dispatch_lint.lint_program(
            "synthetic", lambda: frob(torch.arange(4)), lints={"host_sync"}, root=REPO,
            wrappers={"frob": frob})
        assert findings == []

    def test_a_scope_limits_the_sync_rule_to_its_entry(self, monkeypatch):
        from hypervisor_tpu_torch.observability import health

        monkeypatch.setattr(health, "_LOG", health._CompileLog())
        wave = health.instrument("seeded_scope", lambda x: x * 2)
        x = torch.arange(4)

        def program():
            staged = x.tolist()  # host staging before the dispatch: not the wave
            return wave(torch.tensor(staged)).sum().item()

        findings, _ = dispatch_lint.lint_program(
            "synthetic", program, lints={"host_sync", "one_program"}, root=REPO,
            scope="seeded_scope")
        assert findings == []

    def test_stray_entry_point_detected(self, monkeypatch):
        from hypervisor_tpu_torch.observability import health

        monkeypatch.setattr(health, "_LOG", health._CompileLog())
        stray = health.instrument("check_actions", lambda x: x + 1)
        findings, _ = dispatch_lint.lint_program(
            "fused", lambda: stray(torch.ones(4)) * 2, lints={"one_program"}, root=REPO,
            forbidden={"check_actions"})
        assert [f.rule for f in findings] == ["HVB003"]
        assert "state.py dispatch entry" in findings[0].message
        # Module functions the wave calls directly are not findings.
        findings, _ = dispatch_lint.lint_program(
            "fused", lambda: torch.ones(4) * 2, lints={"one_program"}, root=REPO)
        assert findings == []

    def test_tier_b_clean_on_head_programs(self, tier_b_head):
        findings, programs, wrote = tier_b_head
        assert findings == []
        assert programs == [
            "governance_wave",
            "governance_wave_sanitized",
            "governance_wave_gateway",
            "governance_wave_state_call",
            "tenant_governance_wave_donated_call",
            "saga_table_tick",
            "slash_cascade",
        ]
        # Every in-place wrapper ran and wrote; the read-only ones wrote nothing.
        assert {k for k, v in wrote.items() if v} == {
            "admission_block", "admission_block_tenants", "fsm_saga_block",
            "fsm_saga_block_tenants", "chain_digests_ring", "chain_digests_ring_tenants",
            "saga_tick_block", "slash_cascade",
        }
        assert wrote["slash_cascade"] == ["counters"]
        assert {"contribution_toward", "tree_roots"} <= set(wrote)

    def test_enable_audit_is_a_python_bool_and_the_row_mask_is_the_sync(self):
        """`ops/pipeline.tenant_sessions_create`'s `bool(enable_audit)` is
        a cast of the Python bool the arena passes: no aten op, no sync.
        Its boolean row mask (`[valid]`) is the one host sync of that
        dispatch (ROADMAP C.2; it is no wave)."""
        from hypervisor_tpu_torch.ops import pipeline
        from hypervisor_tpu_torch.tables import struct
        from hypervisor_tpu_torch.tables.state import SessionTable

        sessions = struct.stack([SessionTable.create(8, "cpu") for _ in range(2)])
        rows = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
        valid = torch.tensor([[True, False], [True, True]])
        findings, _ = dispatch_lint.lint_program(
            "tenant_sessions_create",
            lambda: pipeline.tenant_sessions_create(
                sessions, rows, rows + 10, valid, 1, 0, 8, 0.5, True),
            lints={"host_sync"}, root=REPO)
        src = (PACKAGE / "ops/pipeline.py").read_text().splitlines()
        enable_line = next(i for i, l in enumerate(src, 1) if "bool(enable_audit)" in l)
        flat_line = next(i for i, l in enumerate(src, 1) if l.strip().startswith("flat = ("))
        sids_line = next(i for i, l in enumerate(src, 1) if l.endswith("= sids[valid]"))
        assert [(f.anchor, f.line) for f in findings] == [
            ("tenant_sessions_create:aten.index[bool mask]", flat_line),
            ("tenant_sessions_create:aten.index[bool mask]", sids_line),
        ]
        assert enable_line not in {f.line for f in findings}

    def test_the_card_is_the_default_and_never_replaced(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default runs there")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dispatch_lint.run_tier_b()


# ── the twin surface: each wrapper's CPU route is its plain twin ─────


def _captured_calls() -> dict:
    """The first call of every kernel wrapper the Tier B programs make
    (arguments deep-copied at entry), plus B1 and B2 on small inputs."""
    from hypervisor_tpu_torch import kernels

    codes = {fn.__code__: (name, fn) for name, fn in kernels.WRAPPERS.items()}
    calls: dict = {}

    def profile(frame, event, arg):
        if event == "call" and frame.f_code in codes:
            name, fn = codes[frame.f_code]
            if name not in calls:
                code = fn.__code__
                params = code.co_varnames[:code.co_argcount + code.co_kwonlyargcount]
                calls[name] = copy.deepcopy({p: frame.f_locals[p] for p in params})

    old = sys.getprofile()
    sys.setprofile(profile)
    try:
        for name, _, _ in dispatch_lint.PROGRAMS:
            dispatch_lint._program(name, "cpu")()
    finally:
        sys.setprofile(old)
    words = torch.arange(3 * 32, dtype=torch.int32).reshape(3, 32)
    calls["sha256_words"] = {"words": words, "n_blocks": 2}
    calls["chain_digests"] = {"bodies": torch.arange(2 * 3 * 16, dtype=torch.int32)
                              .reshape(2, 3, 16), "seeds": torch.zeros((3, 8), dtype=torch.int32)}
    assert set(calls) == set(kernels.WRAPPERS), set(kernels.WRAPPERS) - set(calls)
    return calls


def _twin_table():
    from hypervisor_tpu_torch.kernels import liability, mtu, saga, sha256, wave

    return {
        "sha256_words": (sha256.sha256_words, sha256.sha256_words_plain),
        "chain_digests": (mtu.chain_digests, mtu.chain_digests_plain),
        "chain_digests_ring": (mtu.chain_digests_ring, mtu.chain_digests_ring_plain),
        "chain_digests_ring_tenants": (mtu.chain_digests_ring_tenants,
                                       mtu.chain_digests_ring_tenants_plain),
        "tree_roots": (mtu.tree_roots, mtu.tree_roots_plain),
        "contribution_toward": (wave.contribution_toward, wave.contribution_toward_plain),
        "contribution_toward_tenants": (wave.contribution_toward_tenants,
                                        wave.contribution_toward_tenants_plain),
        "admission_block": (wave.admission_block, wave.admission_block_plain),
        "admission_block_tenants": (wave.admission_block_tenants,
                                    wave.admission_block_tenants_plain),
        "fsm_saga_block": (wave.fsm_saga_block, wave.fsm_saga_block_plain),
        "fsm_saga_block_tenants": (wave.fsm_saga_block_tenants,
                                   wave.fsm_saga_block_tenants_plain),
        "saga_tick_block": (saga.saga_tick_block, saga.saga_tick_block_plain),
        "slash_cascade": (liability.slash_cascade, liability.slash_cascade_plain),
    }


@pytest.fixture(scope="module")
def captured():
    return _captured_calls()


def _tensors(v, path="x"):
    import dataclasses

    if isinstance(v, torch.Tensor):
        yield path, v
    elif dataclasses.is_dataclass(v) and not isinstance(v, type):
        for f in dataclasses.fields(v):
            yield from _tensors(getattr(v, f.name), f"{path}.{f.name}")
    elif isinstance(v, (tuple, list)):
        for i, x in enumerate(v):
            yield from _tensors(x, f"{path}[{i}]")
    elif isinstance(v, dict):
        for k, x in v.items():
            yield from _tensors(x, f"{path}[{k}]")


class TestTwinSurface:
    """HVA005's test half: one case per kernel wrapper, held at tolerance
    0 against its plain twin on the arguments the wave programs gave it:
    on CPU tensors the wrapper must BE its twin (same results, same
    in-place writes)."""

    @pytest.mark.parametrize("name", sorted([
        "sha256_words", "chain_digests", "chain_digests_ring", "chain_digests_ring_tenants",
        "tree_roots", "contribution_toward", "contribution_toward_tenants",
        "admission_block", "admission_block_tenants", "fsm_saga_block",
        "fsm_saga_block_tenants", "saga_tick_block", "slash_cascade",
    ]))
    def test_cpu_route_is_the_plain_twin(self, captured, name):
        kernel, twin = _twin_table()[name]
        # Positionally: a twin may name its parameters its own way.
        args_k, args_t = (list(copy.deepcopy(captured[name]).values()) for _ in range(2))
        out_k, out_t = kernel(*args_k), twin(*args_t)
        got = dict(_tensors((out_k, args_k)))
        want = dict(_tensors((out_t, args_t)))
        assert got.keys() == want.keys()
        for path in want:
            assert torch.equal(got[path], want[path]), (name, path)


# ── cross-package: the copies give the reference's results ──────────


class TestCrossPackage:
    def test_copied_findings_and_walker_match_the_reference(self, tmp_path):
        from hypervisor_tpu.analysis import findings as ref_findings
        from hypervisor_tpu.analysis import walker as ref_walker
        from hypervisor_tpu_torch.analysis import findings as port_findings
        from hypervisor_tpu_torch.analysis import walker as port_walker

        pkg = build_pkg(tmp_path, {
            "state.py": (PACKAGE / "state.py").read_text(),
            "mod.py": (
                "import os, threading\n"
                "X = os.environ.get('HV_X')\n"
                "def f(state, p, fallback):\n"
                "    lock = getattr(state, '_policy_lock', None) or fallback\n"
                "    with lock, state._enqueue_lock:\n"
                "        state.degraded_policy = p\n"
                "    def g():\n"
                "        state._members.add(1)\n"
            ),
        })
        sup = tmp_path / "s.json"
        sup.write_text(json.dumps({"suppressions": [
            {"rule": "HVA002", "file": "pkg/mod.py", "anchor": "env:HV_X",
             "justification": "fixture: a justified suppression of the read"},
            {"rule": "HVA002", "file": "pkg/mod.py", "anchor": "env:HV_Y",
             "justification": "short"},
            {"rule": "HVA003", "file": "pkg/ghost.py", "anchor": "ghost.x",
             "justification": "matches nothing at all, on purpose here"},
        ]}))

        def run(findings_mod, walker_mod):
            proj = walker_mod.Project.load(pkg)
            sups, bad = findings_mod.load_suppressions(sup)
            raw = [findings_mod.Finding(rule="HVA002", file="pkg/mod.py", line=2,
                                        anchor="env:HV_X", message="m")]
            applied = findings_mod.apply_suppressions(raw, sups)
            walks = {}
            lock_walker = walker_mod.LockScopeWalker(("_enqueue_lock", "_policy_lock"))
            for rel, m in sorted(proj.modules.items()):
                parents = walker_mod.parent_map(m.tree)
                walks[rel] = [
                    (stmt.lineno, sorted(held)) for node in m.tree.body
                    for fn in ([node] if hasattr(node, "body") else [])
                    for stmt, held in lock_walker.walk(fn)
                ] + [walker_mod.runs_at_import_time(n, parents)
                     for n in list(walker_mod.ast.walk(m.tree))[:400]]
            cls = walker_mod.class_def(proj.module("state.py").tree, "HypervisorState")
            return (
                sorted(proj.modules), [s.key() for s in sups],
                [(f.rule, f.anchor) for f in bad],
                [f.render() for f in applied], walks,
                sorted(walker_mod.self_calls(cls)),
                [m.name for m in walker_mod.methods_of(cls)],
            )

        assert run(port_findings, port_walker) == run(ref_findings, ref_walker)


# ── CLI surface ──────────────────────────────────────────────────────


class TestCli:
    def test_json_payload_shape(self, head_report):
        assert head_report["tool"] == "hvlint"
        assert head_report["tiers"] == ["A"]
        assert set(head_report["counts"]) == {
            "findings", "suppressed", "suppressions_on_file",
        }
        assert head_report["ok"] is True
        assert head_report["files_analyzed"] > 100
        json.dumps(head_report)

    def test_exit_codes(self, tmp_path, capsys):
        pkg = build_pkg(tmp_path, {
            "mod.py": "import os\nX = os.environ.get('HV_X', '1')\n",
        })
        rc = hv_cli.main([
            "--tier", "a", "--package", str(pkg),
            "--tests", str(tmp_path / "no_tests"),
            "--baseline", str(ANALYSIS / "baseline.json"),
            "--suppressions", str(tmp_path / "none.json"),
        ])
        out = capsys.readouterr().out
        assert rc == 1
        assert "HVA002 pkg/mod.py:2 (env:HV_X)" in out

    def test_tier_b_on_the_cpu_exits_zero_and_lists_its_programs(self, tier_b_head, capsys,
                                                                monkeypatch):
        # The Tier B run itself is the module's shared one; the CLI's
        # report and exit code over it are what is held here.
        findings, programs, wrote = tier_b_head
        monkeypatch.setattr(dispatch_lint, "run_tier_b", _replay(findings, programs, wrote))
        assert hv_cli.main(["--tier", "b", "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "hvlint tier B: 0 finding(s), 0 suppressed" in out
        assert "7 programs run on cpu: " + ", ".join(programs) in out
        report = hv_cli.run(tier="b", device="cpu")
        assert report["tier_b_programs"] == programs
        assert report["tier_b_device"] == "cpu"

    def test_write_baseline_round_trips(self, tmp_path):
        path = hv_cli.write_baseline(path=tmp_path / "b.json")
        doc = json.loads(path.read_text())
        committed = json.loads((ANALYSIS / "baseline.json").read_text())
        for key in ("event_types", "metric_series", "wal_ops"):
            assert doc[key] == committed[key]


def _replay(findings, programs, wrote):
    def run_tier_b(package_dir=None, device="cuda"):
        assert device == "cpu"
        run_tier_b.last_programs = programs
        run_tier_b.last_wrappers = wrote
        run_tier_b.last_device = device
        return list(findings)

    return run_tier_b
