"""hvlint Tier A over the port: AST contract rules in the port's idiom.

The counterpart of `hypervisor_tpu.analysis.rules_ast`. The rule ids,
the catalog and the suppression mechanism are the reference's; the
vocabulary follows the port where the port's code differs, since a
rule copied word for word would pass vacuously here:

  HVA001 wal-coverage      every HypervisorState method that MUTATES a
                           device table must run under a `_journal`
                           bracket (directly or via a journaled
                           caller), every journaled op must have a
                           `resilience.recovery.REPLAY` handler, and
                           every REPLAY handler a live journal site.
                           The port updates its tables in place, so a
                           method mutates when it rebinds a table
                           attribute (the reference's only form), stores
                           into one of its columns, calls an in-place
                           torch method (`*_`) on one, or passes one to a
                           function that writes a parameter in place: an
                           instrumented dispatch entry
                           (`health_plane.instrument(label, fn)`) or a
                           kernel wrapper (which moves the version
                           counters of what it wrote, `kernels.mtu._wrote`).
  HVA002 env-arming        `HV_*` environment variables are read
                           per-call inside function bodies, never at
                           import time.
  HVA003 lock-discipline   mutations of the join-staging structures
                           happen under `_enqueue_lock` (an RLock in the
                           port); swaps of `degraded_policy` under
                           `_policy_lock`.
  HVA004 append-only       EventType codes, metric series registration
                           order, and WAL record tags only grow,
                           checked against `analysis/baseline.json`.
  HVA005 twin-parity       every public kernel wrapper in `kernels/`
                           (a function that takes the CUDA route,
                           `_route(...)`) has a `<name>_plain` twin in
                           the same module (a def or a module-level
                           alias), and some port test
                           (`tests/test_torch_*.py`) names both.

Everything here is pure `ast` over source text: the analyzed modules
are never imported (Tier A needs no torch and no device).
"""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path
from typing import Iterator, Optional

from hypervisor_tpu_torch.analysis.findings import Finding
from hypervisor_tpu_torch.analysis.walker import (
    LockScopeWalker,
    ModuleAst,
    Project,
    class_def,
    const_str,
    methods_of,
    parent_map,
    runs_at_import_time,
    self_calls,
)

# ── contract vocabulary ──────────────────────────────────────────────

#: Device-table attributes on HypervisorState whose mutations are
#: state-mutating dispatches (the WAL contract's object set).
TABLE_ATTRS = frozenset({
    "agents", "sessions", "vouches", "sagas", "elevations",
    "delta_log", "event_log",
})

#: Join-staging host structures guarded by `_enqueue_lock` (the port's
#: own attributes, `HypervisorState.__init__`). Reads are not checked:
#: the contract is writer-side (every mutation serialized).
STAGING_ATTRS = frozenset({
    "_members", "_slot_of_member", "_staged_members", "_pending_rows",
    "_free_agent_slots", "_next_agent_slot",
})

#: Attributes swapped only under `_policy_lock`.
POLICY_ATTRS = frozenset({"degraded_policy"})

STAGING_LOCK = "_enqueue_lock"
POLICY_LOCK = "_policy_lock"

#: Container methods that mutate their receiver.
_MUTATORS = frozenset({
    "append", "extend", "pop", "popitem", "add", "discard", "remove",
    "clear", "update", "setdefault", "insert",
})

#: Methods exempt from HVA001/HVA003: constructors run on an object no
#: other thread can see yet.
_CONSTRUCTORS = frozenset({"__init__", "__post_init__"})

#: Tensor methods whose result shares the receiver's memory: a store
#: through the result is a store into the receiver.
_VIEW_METHODS = frozenset({
    "view", "view_as", "reshape", "transpose", "permute", "select", "narrow",
    "unsqueeze", "squeeze", "flatten", "unflatten", "expand", "expand_as",
    "as_strided", "movedim", "diagonal", "unbind", "split", "chunk", "detach",
})

#: Calls that mark their arguments written (the version-counter bump
#: every in-place kernel wrapper makes, `kernels.mtu._wrote`).
_WROTE_CALLS = frozenset({"_wrote", "increment_version"})

#: The port's own tests. The shared `tests/` directory holds the
#: reference's tests too, and a reference test naming a kernel must not
#: satisfy the port's twin rule.
TEST_GLOB = "test_torch_*.py"

#: Suffix of a kernel wrapper's plain twin.
TWIN_SUFFIX = "_plain"


class PortProject(Project):
    """`Project` whose test sources are the port's tests only."""

    def test_sources(self) -> Iterator[tuple[str, str]]:
        if self.tests_dir is None or not self.tests_dir.exists():
            return
        for path in sorted(self.tests_dir.rglob(TEST_GLOB)):
            try:
                yield path.as_posix(), path.read_text()
            except OSError:  # pragma: no cover
                continue


# ── derivations (shared with tests, Tier B and the REPLAY pin) ───────


def derive_journal_ops(state_mod: ModuleAst) -> dict[str, int]:
    """op name -> first lineno for every `*._journal("op", ...)` site."""
    ops: dict[str, int] = {}
    for node in ast.walk(state_mod.tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "_journal" and node.args:
            name = const_str(node.args[0])
            if name is not None:
                ops.setdefault(name, node.lineno)
    return ops


def derive_replay_ops(recovery_mod: ModuleAst) -> dict[str, int]:
    """op name -> lineno for every key of the REPLAY handler table."""
    ops: dict[str, int] = {}
    for node in ast.walk(recovery_mod.tree):
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign):
            target = node.target
        if not (isinstance(target, ast.Name) and target.id == "REPLAY"):
            continue
        value = node.value
        if isinstance(value, ast.Dict):
            for key in value.keys:
                name = const_str(key) if key is not None else None
                if name is not None:
                    ops.setdefault(name, key.lineno)
    return ops


def derive_event_types(event_bus_mod: ModuleAst) -> list[tuple[str, str]]:
    """Ordered (NAME, value) pairs of the EventType enum: order IS the
    device-log wire format (codes are enumeration order)."""
    cls = class_def(event_bus_mod.tree, "EventType")
    out: list[tuple[str, str]] = []
    if cls is None:
        return out
    for node in cls.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            value = const_str(node.value)
            if value is not None:
                out.append((node.targets[0].id, value))
    return out


def derive_metric_series(metrics_mod: ModuleAst) -> list[tuple[str, str]]:
    """Ordered (kind, series-name) per REGISTRY.{counter,gauge,histogram}
    call site, in source order: registration order is the device-table
    row layout, so reordering IS renumbering."""
    calls: list[tuple[int, str, str]] = []
    for node in ast.walk(metrics_mod.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("counter", "gauge", "histogram")):
            continue
        recv = node.func.value
        if not (isinstance(recv, ast.Name) and recv.id == "REGISTRY"):
            continue
        name = const_str(node.args[0]) if node.args else None
        if name is not None:
            calls.append((node.lineno, node.func.attr, name))
    calls.sort()
    return [(kind, name) for _, kind, name in calls]


def _instrument_call(node: ast.AST) -> Optional[ast.Call]:
    """`<x>.instrument("label", fn, ...)` / `instrument(...)`, else None."""
    if isinstance(node, ast.Call) and node.args and const_str(node.args[0]) is not None:
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr == "instrument") or \
                (isinstance(f, ast.Name) and f.id == "instrument"):
            return node
    return None


def derive_entry_points(state_mod: ModuleAst) -> dict[str, int]:
    """Watch label -> lineno for every module-level
    `health_plane.instrument("label", <mod>.<fn>, ...)` dispatch entry in
    state.py (the reference wraps a `jax.jit` there; the port wraps the
    function itself). Tier B's one-program rule forbids these entries
    from running nested inside the fused wave."""
    out: dict[str, int] = {}
    for node in state_mod.tree.body:
        value = node.value if isinstance(node, (ast.Assign, ast.AnnAssign)) else None
        call = _instrument_call(value) if value is not None else None
        if call is not None:
            out.setdefault(const_str(call.args[0]), node.lineno)
    return out


def derive_kernel_wrappers(project: Project) -> list[tuple[ModuleAst, str, int]]:
    """(module, name, lineno) for every public top-level function under
    `kernels/` that takes the CUDA route (calls `_route(...)`)."""
    out = []
    for mod in project.modules_under("kernels"):
        for node in mod.tree.body:
            if isinstance(node, ast.FunctionDef) and not node.name.startswith("_") \
                    and any(isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                            and n.func.id == "_route" for n in ast.walk(node)):
                out.append((mod, node.name, node.lineno))
    return out


def derive_inplace_wrappers(project: Project) -> list[tuple[ModuleAst, str, int]]:
    """The kernel wrappers that write a tensor in place: those whose CUDA
    route marks what it wrote (`_wrote(...)`). Tier B's version-counter
    rule runs each of them."""
    return [
        (mod, name, line) for mod, name, line in derive_kernel_wrappers(project)
        if any(isinstance(n, ast.Call) and _call_name(n) in _WROTE_CALLS
               for fn in mod.tree.body if isinstance(fn, ast.FunctionDef) and fn.name == name
               for n in ast.walk(fn))
    ]


# ── in-place writes: which functions write which parameters ──────────


def _call_name(call: ast.Call) -> Optional[str]:
    f = call.func
    return f.attr if isinstance(f, ast.Attribute) else f.id if isinstance(f, ast.Name) else None


def _is_inplace_method(name: str) -> bool:
    return name.endswith("_") and not name.startswith("_") and name != "requires_grad_"


def _chain(expr: ast.AST) -> Optional[list[str]]:
    """Names along an access path down to its root, root first:
    `self.agents.f32[i].view(-1)` -> ["self", "agents", "f32"]. None when
    the expression is not a path (a call that makes a new tensor)."""
    names: list[str] = []
    while True:
        if isinstance(expr, ast.Name):
            return [expr.id] + names[::-1]
        if isinstance(expr, ast.Attribute):
            names.append(expr.attr)
            expr = expr.value
        elif isinstance(expr, (ast.Subscript, ast.Starred)):
            expr = expr.value
        elif isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute) \
                and expr.func.attr in _VIEW_METHODS:
            expr = expr.func.value
        else:
            return None


class _Resolver:
    """Maps a call inside a module to the project function it calls:
    same-module defs, names imported from project modules, `mod.fn` over
    an imported project module, and module-level aliases (`x = fn`,
    `X = health_plane.instrument("label", fn)`)."""

    def __init__(self, project: Project) -> None:
        self.project = project
        self.pkg = project.package_dir.name
        self.defs: dict[tuple[str, str], ast.FunctionDef] = {}
        self.aliases: dict[tuple[str, str], ast.AST] = {}
        self.imports: dict[str, dict[str, tuple[str, Optional[str]]]] = {}
        for rel, mod in project.modules.items():
            for node in mod.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.defs[(rel, node.name)] = node
                elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    call = _instrument_call(node.value)
                    target = call.args[1] if call is not None and len(call.args) > 1 else node.value
                    if isinstance(target, (ast.Name, ast.Attribute)):
                        self.aliases[(rel, node.targets[0].id)] = target
            self.imports[rel] = self._imports_of(mod)

    def _module_rel(self, dotted: str) -> Optional[str]:
        parts = dotted.split(".")
        if not parts or parts[0] != self.pkg:
            return None
        base = "/".join(parts)
        for cand in (f"{base}.py", f"{base}/__init__.py"):
            if cand in self.project.modules:
                return cand
        return None

    def _imports_of(self, mod: ModuleAst) -> dict[str, tuple[str, Optional[str]]]:
        out: dict[str, tuple[str, Optional[str]]] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ImportFrom) and node.module and not node.level:
                for alias in node.names:
                    local = alias.asname or alias.name
                    sub = self._module_rel(f"{node.module}.{alias.name}")
                    if sub is not None:
                        out[local] = (sub, None)
                    else:
                        owner = self._module_rel(node.module)
                        if owner is not None:
                            out[local] = (owner, alias.name)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    rel = self._module_rel(alias.name)
                    if rel is not None and alias.asname:
                        out[alias.asname] = (rel, None)
        return out

    def resolve(self, rel: str, func: ast.AST, depth: int = 0) -> Optional[tuple[str, str]]:
        """(module rel, def name) of the function `func` names in module
        `rel`, or None (a method, a builtin, a library call)."""
        if depth > 8:
            return None
        if isinstance(func, ast.Name):
            key = (rel, func.id)
            if key in self.defs:
                return key
            if key in self.aliases:
                return self.resolve(rel, self.aliases[key], depth + 1)
            imp = self.imports.get(rel, {}).get(func.id)
            if imp is not None and imp[1] is not None:
                return self.resolve(imp[0], ast.Name(id=imp[1]), depth + 1)
            return None
        if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
            imp = self.imports.get(rel, {}).get(func.value.id)
            if imp is not None and imp[1] is None:
                return self.resolve(imp[0], ast.Name(id=func.attr), depth + 1)
        return None


def _params(fn: ast.FunctionDef) -> tuple[list[str], Optional[str], Optional[str], set[str]]:
    """(positional names, *vararg, **kwarg, every parameter name)."""
    a = fn.args
    pos = [x.arg for x in a.posonlyargs + a.args]
    names = set(pos) | {x.arg for x in a.kwonlyargs}
    var = a.vararg.arg if a.vararg else None
    kw = a.kwarg.arg if a.kwarg else None
    names |= {n for n in (var, kw) if n}
    return pos, var, kw, names


def _bound_params(callee: ast.FunctionDef, call: ast.Call) -> list[tuple[str, ast.AST]]:
    """(callee parameter, argument expression) pairs a call binds; a
    starred or double-starred argument binds the callee's catch-alls."""
    pos, var, kw, names = _params(callee)
    out: list[tuple[str, ast.AST]] = []
    for i, arg in enumerate(call.args):
        if isinstance(arg, ast.Starred):
            out += [(p, arg) for p in pos[i:]] + ([(var, arg)] if var else [])
        elif i < len(pos):
            out.append((pos[i], arg))
        elif var:
            out.append((var, arg))
    for k in call.keywords:
        if k.arg is None:
            out += [(p, k.value) for p in pos] + ([(kw, k.value)] if kw else [])
        else:
            out.append((k.arg if k.arg in names or not kw else kw, k.value))
    return out


class InPlaceWrites:
    """Which parameters each project function writes in place, to a
    fixpoint over the resolvable call graph: a store into a subscript or
    attribute of the parameter (or of a view of it), an in-place torch
    method on it, `_wrote(...)` on it, or passing it where a callee
    writes."""

    def __init__(self, project: Project) -> None:
        self.resolver = _Resolver(project)
        self.writes: dict[tuple[str, str], set[str]] = {}
        calls: list[tuple[tuple[str, str], tuple[str, str], ast.Call, dict[str, str]]] = []
        for key, fn in self.resolver.defs.items():
            _, _, _, names = _params(fn)
            roots = self._aliases(fn, names)
            direct = set()
            for node in ast.walk(fn):
                for target in _store_targets(node):
                    r = _root_of(target, roots)
                    if r is not None and not (isinstance(target, ast.Name)):
                        direct.add(r)
                if isinstance(node, ast.Call):
                    name = _call_name(node)
                    if isinstance(node.func, ast.Attribute) and name and _is_inplace_method(name):
                        r = _root_of(node.func.value, roots)
                        if r is not None:
                            direct.add(r)
                    if name in _WROTE_CALLS:
                        direct |= {r for a in node.args if (r := _root_of(a, roots))}
                    callee = self.resolver.resolve(key[0], node.func)
                    if callee is not None and callee != key:
                        calls.append((key, callee, node, roots))
            self.writes[key] = direct
        changed = True
        while changed:
            changed = False
            for key, callee, node, roots in calls:
                written = self.writes.get(callee)
                if not written:
                    continue
                for param, arg in _bound_params(self.resolver.defs[callee], node):
                    r = _root_of(arg, roots)
                    if param in written and r is not None and r not in self.writes[key]:
                        self.writes[key].add(r)
                        changed = True

    @staticmethod
    def _aliases(fn: ast.FunctionDef, params: set[str]) -> dict[str, str]:
        """local name -> the parameter it is a view of (parameters map to
        themselves). A parameter rebound to a new tensor is dropped."""
        roots = {p: p for p in params}
        rebound: set[str] = set()
        assigns = [
            (node.targets[0].id, node.value) for node in ast.walk(fn)
            if isinstance(node, ast.Assign) and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
        ]
        for _ in range(3):
            for name, value in assigns:
                r = _root_of(value, roots)
                if r is not None and r != name:
                    roots.setdefault(name, r)
                elif r is None and name in params:
                    rebound.add(name)
        return {k: v for k, v in roots.items() if v not in rebound and k not in rebound}


def _store_targets(node: ast.AST) -> list[ast.AST]:
    if isinstance(node, ast.Assign):
        out = []
        for t in node.targets:
            out += list(t.elts) if isinstance(t, ast.Tuple) else [t]
        return out
    if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        return [node.target]
    return []


def _root_of(expr: ast.AST, roots: dict[str, str]) -> Optional[str]:
    chain = _chain(expr)
    return roots.get(chain[0]) if chain else None


def _table_of(expr: ast.AST, aliases: dict[str, str]) -> Optional[str]:
    """The HypervisorState table an expression reaches: `self.<table>...`
    or a local bound to one."""
    chain = _chain(expr)
    if not chain:
        return None
    if chain[0] == "self" and len(chain) > 1 and chain[1] in TABLE_ATTRS:
        return chain[1]
    return aliases.get(chain[0])


def _whole_table(expr: ast.AST, aliases: dict[str, str]) -> Optional[str]:
    """The table an expression IS (`self.agents`, or a local bound to it)."""
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) \
            and expr.value.id == "self" and expr.attr in TABLE_ATTRS:
        return expr.attr
    if isinstance(expr, ast.Name) and expr.id in aliases:
        return aliases[expr.id]
    return None


def _table_aliases(fn: ast.AST) -> dict[str, str]:
    out: dict[str, str] = {}
    for _ in range(2):
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                t = _table_of(node.value, out)
                if t is not None:
                    out.setdefault(node.targets[0].id, t)
    return out


def table_mutations(
    fn: ast.AST, rel: str, writes: InPlaceWrites
) -> list[tuple[int, str, str]]:
    """(line, table, how) for every mutation of a HypervisorState table
    in one method: a rebind, a column store, an in-place method, or a
    call that writes a table it is passed."""
    aliases = _table_aliases(fn)
    local_names = {t.id for node in ast.walk(fn) for t in _store_targets(node)
                   if isinstance(t, ast.Name)}
    whole = {
        node.targets[0].id: t for node in ast.walk(fn)
        if isinstance(node, ast.Assign) and len(node.targets) == 1
        and isinstance(node.targets[0], ast.Name)
        and (t := _whole_table(node.value, {})) is not None
    }
    out: list[tuple[int, str, str]] = []
    for node in ast.walk(fn):
        for target in _store_targets(node):
            if isinstance(target, ast.Attribute) and isinstance(target.value, ast.Name) \
                    and target.value.id == "self" and target.attr in TABLE_ATTRS:
                out.append((node.lineno, target.attr, "rebinds a table"))
            elif not isinstance(target, ast.Name):
                t = _table_of(target, aliases)
                if t is not None:
                    out.append((node.lineno, t, "stores into a table column"))
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if isinstance(node.func, ast.Attribute) and name and _is_inplace_method(name):
            t = _table_of(node.func.value, aliases)
            if t is not None:
                out.append((node.lineno, t, f"calls `{name}` on a table"))
                continue
        callee = writes.resolver.resolve(rel, node.func)
        if callee is None and isinstance(node.func, ast.Name) and name in local_names:
            # A local callable the AST cannot follow (a closure a factory
            # made) taking a whole table: the port's table ops update the
            # tables they are given in place.
            for arg in list(node.args) + [k.value for k in node.keywords]:
                t = _whole_table(arg, whole)
                if t is not None:
                    out.append((node.lineno, t, f"passes a table to the local callable "
                                f"`{name}`, taken as an in-place writer"))
            continue
        written = writes.writes.get(callee)
        if written:
            for param, arg in _bound_params(writes.resolver.defs[callee], node):
                t = _table_of(arg, aliases)
                if param in written and t is not None:
                    out.append((node.lineno, t, f"passes a table to the in-place writer `{name}`"))
    return out


# ── HVA001: WAL coverage ─────────────────────────────────────────────


def rule_wal_coverage(project: Project, writes: Optional[InPlaceWrites] = None) -> list[Finding]:
    state_mod = project.module("state.py")
    if state_mod is None:
        return []
    findings: list[Finding] = []
    journal_ops = derive_journal_ops(state_mod)

    cls = class_def(state_mod.tree, "HypervisorState")
    if cls is not None:
        writes = writes or InPlaceWrites(project)
        methods = {m.name: m for m in methods_of(cls)}
        journaled = {
            name for name, m in methods.items()
            if any(
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "_journal"
                for n in ast.walk(m)
            )
        }
        mutating: dict[str, tuple[int, set[str], str]] = {}
        for name, m in methods.items():
            if name in _CONSTRUCTORS:
                continue
            hits = sorted(table_mutations(m, state_mod.rel, writes))
            if hits:
                line, _, how = hits[0]
                mutating[name] = (line, {t for _, t, _ in hits}, how)

        callers: dict[str, set[str]] = {name: set() for name in methods}
        for name, m in methods.items():
            for callee in self_calls(m):
                if callee in callers:
                    callers[callee].add(name)

        # Fixpoint: covered = journals itself, or every intra-class
        # caller is covered (helpers running inside the outer bracket).
        covered = set(journaled)
        changed = True
        while changed:
            changed = False
            for name in methods:
                if name in covered:
                    continue
                cs = callers[name]
                if cs and cs <= covered:
                    covered.add(name)
                    changed = True

        for name, (line, tables, how) in sorted(mutating.items()):
            if name not in covered:
                findings.append(Finding(
                    rule="HVA001", file=state_mod.rel, line=line,
                    anchor=f"HypervisorState.{name}",
                    message=(
                        f"method mutates device table(s) {sorted(tables)} "
                        f"(first: {how}) with no `_journal` bracket "
                        "on any path (crash between dispatch and the next "
                        "checkpoint loses the transition)"
                    ),
                    hint=(
                        "wrap the mutation in `with self._journal(\"<op>\","
                        " ...)` and add the op's replay handler to "
                        "resilience.recovery.REPLAY"
                    ),
                ))

    recovery_mod = project.module("resilience/recovery.py")
    if recovery_mod is not None:
        replay_ops = derive_replay_ops(recovery_mod)
        for op, line in sorted(journal_ops.items()):
            if op not in replay_ops:
                findings.append(Finding(
                    rule="HVA001", file=state_mod.rel, line=line,
                    anchor=f"journal:{op}",
                    message=(
                        f'journaled op "{op}" has no handler in '
                        "resilience.recovery.REPLAY — a WAL carrying it "
                        "cannot be replayed"
                    ),
                    hint="add a REPLAY row (or remove the dead bracket)",
                ))
        for op, line in sorted(replay_ops.items()):
            if op not in journal_ops:
                findings.append(Finding(
                    rule="HVA001", file=recovery_mod.rel, line=line,
                    anchor=f"replay:{op}",
                    message=(
                        f'REPLAY handler "{op}" matches no journal site in '
                        "state.py — the registry drifted from the checker"
                    ),
                    hint=(
                        "dead handlers hide renames: either re-journal the "
                        "op or delete the row (append-only WAL tags: keep "
                        "the baseline entry, see HVA004)"
                    ),
                ))
    return findings


# ── HVA002: env-arming discipline ────────────────────────────────────


def _env_reads(node: ast.AST) -> list[tuple[ast.AST, int, str]]:
    out = []
    for n in ast.walk(node):
        name = None
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in ("get", "getenv") and n.args:
            v = const_str(n.args[0])
            if v is not None and v.startswith("HV_"):
                name = v
        elif isinstance(n, ast.Subscript) \
                and isinstance(n.value, ast.Attribute) \
                and n.value.attr == "environ":
            v = const_str(n.slice)
            if v is not None and v.startswith("HV_"):
                name = v
        if name is not None:
            out.append((n, n.lineno, name))
    return out


def rule_env_arming(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for mod in project.modules.values():
        parents = parent_map(mod.tree)
        for node, line, name in _env_reads(mod.tree):
            if runs_at_import_time(node, parents):
                findings.append(Finding(
                    rule="HVA002", file=mod.rel, line=line,
                    anchor=f"env:{name}",
                    message=(
                        f"`{name}` is read at import time — the value "
                        "freezes at first import and per-call arming "
                        "(the HV_ROOFLINE / HV_SUP_* contract) silently "
                        "stops working"
                    ),
                    hint=(
                        "move the read inside the function that uses it "
                        "(or a default_factory); module/class bodies and "
                        "argument defaults all execute at import"
                    ),
                ))
    return findings


# ── HVA003: lock discipline ──────────────────────────────────────────


def _guarded_mutation(stmt: ast.stmt) -> list[tuple[int, str, str]]:
    """(line, attr, lock) mutations of guarded attrs in ONE statement
    (not recursing into compound bodies: the scope walker does that)."""
    hits: list[tuple[int, str, str]] = []

    def check_attr(t: ast.AST) -> Optional[str]:
        if isinstance(t, ast.Attribute) and t.attr in (STAGING_ATTRS | POLICY_ATTRS):
            return t.attr
        return None

    def lock_for(attr: str) -> str:
        return POLICY_LOCK if attr in POLICY_ATTRS else STAGING_LOCK

    targets: list[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, ast.Delete):
        targets = list(stmt.targets)
    for t in targets:
        if isinstance(t, ast.Tuple):
            targets.extend(t.elts)
    for t in targets:
        attr = check_attr(t)
        if attr is None and isinstance(t, ast.Subscript):
            attr = check_attr(t.value)
        if attr is not None:
            hits.append((stmt.lineno, attr, lock_for(attr)))
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
        f = stmt.value.func
        if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
            attr = check_attr(f.value)
            if attr is not None and attr not in POLICY_ATTRS:
                hits.append((stmt.lineno, attr, lock_for(attr)))
    return hits


def rule_lock_discipline(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    walker = LockScopeWalker((STAGING_LOCK, POLICY_LOCK))
    seen: set[tuple[str, str]] = set()
    for mod in project.modules.values():
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if node.name in _CONSTRUCTORS:
                continue
            for stmt, held in walker.walk(node):
                for line, attr, lock in _guarded_mutation(stmt):
                    anchor = f"{node.name}.{attr}"
                    # One finding per (file, anchor): the same method
                    # touching the same attr on several lines is one
                    # violation to fix, not five.
                    if lock in held or (mod.rel, anchor) in seen:
                        continue
                    seen.add((mod.rel, anchor))
                    plane = (
                        "policy swap" if attr in POLICY_ATTRS
                        else "join-staging structure"
                    )
                    findings.append(Finding(
                        rule="HVA003", file=mod.rel, line=line, anchor=anchor,
                        message=(
                            f"`{attr}` ({plane}) mutated outside "
                            f"`{lock}` — racing a concurrent holder "
                            "corrupts the staging/policy plane"
                        ),
                        hint=f"wrap the mutation in `with <state>.{lock}:`",
                    ))
    return findings


# ── HVA004: append-only registries ───────────────────────────────────


def current_registries(project: Project) -> dict:
    """The three append-only registries, AST-derived (no imports)."""
    reg: dict = {"event_types": [], "metric_series": [], "wal_ops": []}
    ev = project.module("observability/event_bus.py")
    if ev is not None:
        reg["event_types"] = [list(p) for p in derive_event_types(ev)]
    mx = project.module("observability/metrics.py")
    if mx is not None:
        reg["metric_series"] = [list(p) for p in derive_metric_series(mx)]
    st = project.module("state.py")
    if st is not None:
        reg["wal_ops"] = sorted(derive_journal_ops(st))
    return reg


def rule_append_only(
    project: Project, baseline_path: Optional[Path]
) -> list[Finding]:
    if baseline_path is None or not baseline_path.exists():
        return [Finding(
            rule="HVA004", file="analysis/baseline.json", line=1,
            anchor="baseline", tier="A",
            message="append-only baseline missing — registries unpinned",
            hint="run `python -m hypervisor_tpu_torch.analysis --write-baseline`",
        )]
    try:
        base = json.loads(baseline_path.read_text())
    except (OSError, json.JSONDecodeError) as exc:
        return [Finding(
            rule="HVA004", file="analysis/baseline.json", line=1,
            anchor="baseline", message=f"baseline unreadable: {exc}",
            hint="regenerate with --write-baseline after review",
        )]
    cur = current_registries(project)
    findings: list[Finding] = []

    def prefix_check(key: str, mod: Optional[ModuleAst], what: str) -> None:
        if mod is None:
            return
        b = [tuple(x) for x in base.get(key, [])]
        c = [tuple(x) for x in cur.get(key, [])]
        if c[: len(b)] == b:
            return
        # Name the FIRST divergence: that's the renumber/removal point.
        i = next(
            (i for i, pair in enumerate(b) if i >= len(c) or c[i] != pair),
            len(b),
        )
        missing = b[i]
        got = c[i] if i < len(c) else None
        findings.append(Finding(
            rule="HVA004", file=mod.rel, line=1,
            anchor=f"{key}:{missing[-1]}",
            message=(
                f"{what} is not append-only: baseline position {i} is "
                f"{missing} but the source now has "
                f"{got if got is not None else 'nothing'} — renumbering "
                "breaks replay of committed logs and every dashboard "
                "keyed on the old index"
            ),
            hint=(
                "append new entries at the end; if the removal is an "
                "intentional wire-format break, refresh the baseline "
                "(`--write-baseline`) in the same reviewed change"
            ),
        ))

    prefix_check(
        "event_types", project.module("observability/event_bus.py"),
        "EventType code order (device-log wire format)",
    )
    prefix_check(
        "metric_series", project.module("observability/metrics.py"),
        "metric registration order (device-table row layout)",
    )
    st = project.module("state.py")
    if st is not None:
        removed = set(base.get("wal_ops", [])) - set(cur.get("wal_ops", []))
        for op in sorted(removed):
            findings.append(Finding(
                rule="HVA004", file=st.rel, line=1, anchor=f"wal_ops:{op}",
                message=(
                    f'WAL record tag "{op}" disappeared from state.py — '
                    "committed WALs carrying it can no longer replay"
                ),
                hint=(
                    "keep a REPLAY handler for retired tags (or refresh "
                    "the baseline in a reviewed wire-format break)"
                ),
            ))
    return findings


# ── HVA005: twin parity ──────────────────────────────────────────────


def _module_names(mod: ModuleAst) -> set[str]:
    """Top-level defs and module-level assignment targets (an alias
    `x_plain = other_fn` is a twin as good as a def)."""
    out: set[str] = set()
    for n in mod.tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out |= {t.id for t in n.targets if isinstance(t, ast.Name)}
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
    return out


def _names_word(src: str, name: str) -> bool:
    """`name` appears in `src` as a whole identifier (`admission_block`
    is not named by `admission_block_plain`)."""
    return re.search(rf"(?<![\w]){re.escape(name)}(?![\w])", src) is not None


def rule_twin_parity(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    kernels = derive_kernel_wrappers(project)
    if not kernels:
        return findings
    tests = list(project.test_sources())
    for mod, name, line in kernels:
        twin = f"{name}{TWIN_SUFFIX}"
        if twin not in _module_names(mod):
            findings.append(Finding(
                rule="HVA005", file=mod.rel, line=line, anchor=name,
                message=(
                    f"kernel wrapper `{name}` has no `{twin}` twin in the "
                    "same module — without the plain version the kernel "
                    "is only testable on the card"
                ),
                hint=(
                    "add the plain PyTorch twin computing the same math "
                    "(or a module-level alias naming it), or suppress "
                    "with the named oracle if one exists under another name"
                ),
            ))
            continue
        if tests and not any(
            _names_word(src, name) and _names_word(src, twin) for _, src in tests
        ):
            findings.append(Finding(
                rule="HVA005", file=mod.rel, line=line,
                anchor=f"{name}:test",
                message=(
                    f"no port test names both `{name}` and `{twin}` — "
                    "twin drift would go unnoticed until a chip run "
                    "disagrees with the CPU"
                ),
                hint=(
                    "add a parity test naming the pair in "
                    f"tests/{TEST_GLOB}"
                ),
            ))
    return findings


# ── tier driver ──────────────────────────────────────────────────────

TIER_A_RULES = ("HVA001", "HVA002", "HVA003", "HVA004", "HVA005")


def run_tier_a(
    package_dir: Path,
    tests_dir: Optional[Path] = None,
    baseline_path: Optional[Path] = None,
) -> list[Finding]:
    """All Tier A findings over one package tree (unsuppressed, raw:
    the CLI applies the suppressions file on top)."""
    project = PortProject.load(package_dir, tests_dir=tests_dir)
    findings: list[Finding] = []
    for rel, err in project.parse_errors:  # pragma: no cover
        findings.append(Finding(
            rule="HVA000", file=rel, line=1, anchor="parse",
            message=f"unparseable module: {err}", hint="fix the syntax",
        ))
    findings += rule_wal_coverage(project)
    findings += rule_env_arming(project)
    findings += rule_lock_discipline(project)
    findings += rule_append_only(project, baseline_path)
    findings += rule_twin_parity(project)
    return findings
