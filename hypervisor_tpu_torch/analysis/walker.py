"""AST project model for hvlint Tier A.

Pure `ast` — the analyzed modules are never imported, so Tier A runs
identically with or without jax installed and can analyze fixture
trees (the test suite points it at synthetic mini-packages under
tmp_path). Helpers here are the shared vocabulary of the rules:

  * `Project` — parsed module set rooted at a package directory,
  * lexical lock-scope tracking (`with self._enqueue_lock: ...`,
    including multi-item withs and locally-bound lock aliases),
  * the intra-class call graph state.py's journal-coverage rule walks.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Iterator, Optional


@dataclasses.dataclass
class ModuleAst:
    rel: str                   #: path relative to the project root, posix
    path: Path
    tree: ast.Module
    source: str

    @property
    def lines(self) -> list[str]:
        return self.source.splitlines()


@dataclasses.dataclass
class Project:
    """Parsed view of one package tree (plus, optionally, its tests).

    `package_dir` is the directory whose *.py files are analyzed
    (normally `<repo>/hypervisor_tpu_torch`); `rel` paths are computed from
    its parent so findings read `hypervisor_tpu_torch/state.py:123` at HEAD
    and `<fixture>/state.py:7` under test fixtures alike.
    """

    package_dir: Path
    tests_dir: Optional[Path] = None
    modules: dict[str, ModuleAst] = dataclasses.field(default_factory=dict)
    parse_errors: list[tuple[str, str]] = dataclasses.field(
        default_factory=list
    )

    @classmethod
    def load(
        cls, package_dir: Path, tests_dir: Optional[Path] = None
    ) -> "Project":
        proj = cls(package_dir=package_dir, tests_dir=tests_dir)
        base = package_dir.parent
        for path in sorted(package_dir.rglob("*.py")):
            rel = path.relative_to(base).as_posix()
            try:
                src = path.read_text()
                proj.modules[rel] = ModuleAst(
                    rel=rel, path=path, tree=ast.parse(src), source=src
                )
            except (OSError, SyntaxError) as exc:  # pragma: no cover
                proj.parse_errors.append((rel, str(exc)))
        return proj

    def module(self, suffix: str) -> Optional[ModuleAst]:
        """The module at `<package>/<suffix>` (exact), else the unique
        module ending in `/<suffix>` — never an ambiguous match
        (`state.py` must not resolve to `tables/state.py`)."""
        want = f"{self.package_dir.name}/{suffix}"
        if want in self.modules:
            return self.modules[want]
        hits = [
            m for r, m in self.modules.items()
            if r == suffix or r.endswith("/" + suffix)
        ]
        return hits[0] if len(hits) == 1 else None

    def modules_under(self, subdir: str) -> list[ModuleAst]:
        return [
            m for r, m in self.modules.items()
            if f"/{subdir}/" in f"/{r}"
        ]

    def test_sources(self) -> Iterator[tuple[str, str]]:
        if self.tests_dir is None or not self.tests_dir.exists():
            return
        for path in sorted(self.tests_dir.rglob("*.py")):
            try:
                yield path.as_posix(), path.read_text()
            except OSError:  # pragma: no cover
                continue


# ── AST helpers ──────────────────────────────────────────────────────


def class_def(tree: ast.Module, name: str) -> Optional[ast.ClassDef]:
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    return None


def methods_of(cls: ast.ClassDef) -> list[ast.FunctionDef]:
    return [
        n for n in cls.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def attr_chain_tail(node: ast.AST) -> Optional[str]:
    """Final attribute name of `a.b.c` / bare name of `c`."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def self_calls(fn: ast.AST) -> set[str]:
    """Names of methods invoked as `self.<name>(...)` anywhere in fn."""
    out: set[str] = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
            recv = n.func.value
            if isinstance(recv, ast.Name) and recv.id == "self":
                out.add(n.func.attr)
    return out


def parent_map(tree: ast.AST) -> dict[ast.AST, ast.AST]:
    parents: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def runs_at_import_time(
    node: ast.AST, parents: dict[ast.AST, ast.AST]
) -> bool:
    """True when `node` EXECUTES during module import.

    Function/lambda *bodies* run at call time; everything else —
    module level, class bodies (dataclass field defaults!), default
    argument expressions, decorators, annotations — runs when the
    module is imported.
    """
    child: ast.AST = node
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # Inside the body statements -> call time. Inside
            # defaults / decorators / annotations -> import time.
            return child not in cur.body
        if isinstance(cur, ast.Lambda) and child is cur.body:
            # Lambda bodies are deferred (the default_factory idiom).
            return False
        child, cur = cur, parents.get(cur)
    return True


class LockScopeWalker:
    """Per-function lexical walk that tracks which named locks are held.

    A `with` item holds lock `L` when its context expression mentions
    `L` (`with self._enqueue_lock:`, `with self._lock,
    self._policy_lock():`) or is a bare name previously assigned from
    an expression mentioning `L` (`lock = getattr(state, "_policy_lock",
    None) or _FALLBACK; with lock:` — the resilience.policy idiom).
    Yields (stmt, held_locks) for every statement in the function.
    """

    def __init__(self, lock_names: tuple[str, ...]) -> None:
        self.lock_names = lock_names

    def _locks_in_expr(self, expr: ast.AST, aliases: dict[str, set[str]]):
        held: set[str] = set()
        text = ast.unparse(expr)
        for lock in self.lock_names:
            if lock in text:
                held.add(lock)
        for n in ast.walk(expr):
            if isinstance(n, ast.Name) and n.id in aliases:
                held |= aliases[n.id]
        return held

    def walk(self, fn: ast.AST) -> Iterator[tuple[ast.stmt, frozenset[str]]]:
        aliases: dict[str, set[str]] = {}

        def visit(stmts, held: frozenset[str]):
            for stmt in stmts:
                # Track `name = <expr mentioning a lock>` aliases.
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name):
                    locks = self._locks_in_expr(stmt.value, aliases)
                    if locks:
                        aliases[stmt.targets[0].id] = locks
                yield stmt, held
                inner = held
                if isinstance(stmt, (ast.With, ast.AsyncWith)):
                    for item in stmt.items:
                        inner = inner | self._locks_in_expr(
                            item.context_expr, aliases
                        )
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    # A nested def's body executes later, outside any
                    # lock the enclosing scope holds right now.
                    inner = frozenset()
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, field, None)
                    if sub:
                        yield from visit(sub, inner)
                for handler in getattr(stmt, "handlers", []) or []:
                    yield from visit(handler.body, inner)

        body = getattr(fn, "body", [])
        yield from visit(body, frozenset())
