"""hvlint Tier B over the port: lints of what the dispatched functions do.

The counterpart of `hypervisor_tpu.analysis.jaxpr_lint`. The reference
traces its jitted entry points to jaxprs and lints the primitives; the
port has no jaxpr (an eager wave is Python issuing torch ops and kernel
launches), so Tier B runs the dispatched functions at tiny shapes on a
device and lints what they did: every aten op through a
`TorchDispatchMode`, every host read of a tensor, every instrumented
entry entered, every kernel wrapper's in-place writes. The rule ids are
the reference's, each in the port's form:

  HVB001 host-sync         inside a dispatched wave no op may force a
                           device-to-host synchronisation: a scalar read
                           (`aten._local_scalar_dense`: `.item()`,
                           `bool(t)`, `int(t)`), `nonzero`,
                           `masked_select`, `unique`, boolean-mask
                           indexing, a copy to the CPU (`.cpu()`,
                           `.numpy()`, `.tolist()`), or
                           `torch.cuda.synchronize`. On the card the same
                           programs also run under
                           `torch.cuda.set_sync_debug_mode` ("warn",
                           every site recorded; then "error" on fresh
                           inputs), which sees what a CPU run cannot: a
                           copy from pageable host memory waits for the
                           stream. Neither sees
                           a copy or a stream sync inside a ctypes-bound
                           `csrc/*.cu` entry, so the rule also reads the
                           kernel wrappers' CUDA routes and the CUDA
                           sources. Ops inside a kernel wrapper stand for
                           its launch on the CPU (the plain version runs
                           there) and are read from source instead. The
                           one sanctioned host boundary is a
                           `with work.paused():` block in a wrapper: it
                           runs only while the roofline observatory
                           counts a novel signature's first dispatch
                           (`HV_ROOFLINE`, off during Tier B), as the
                           reference whitelists `hv_wave_twin_call`.
  HVB002 version counters  the reference's use-after-donate. The port
                           donates nothing; its hazard is a kernel's
                           write through `data_ptr`, which moves no
                           version counter (the tenant arena reads the
                           counters to find what a solo op wrote). Every
                           tensor a kernel wrapper writes in place must
                           have a `_version` that moved, and every
                           in-place wrapper must run at least once.
  HVB003 one-program       the fused wave enters no other instrumented
                           dispatch entry (`observability.health.
                           instrument`) while it runs: a nested entry
                           would count as a dispatch of its own in the
                           compile watch and the roofline.

The programs (`PROGRAMS`) are the counterparts of the reference's five
traced targets, plus the saga tick and the slash cascade, which carry
the two in-place wrappers the waves do not reach. `run_tier_b` lists
them on `run_tier_b.last_programs`, so a harness that shrinks shows.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import os
import re
import sys
import sysconfig
import warnings
from pathlib import Path
from typing import Callable, Iterable, Optional

from hypervisor_tpu_torch.analysis.findings import Finding

#: aten op packets that wait for the device before they return.
HOST_SYNC_OPS = frozenset({
    "aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
    "aten._unique2", "aten.unique_dim", "aten.unique_consecutive",
    "aten.bincount", "aten.equal", "aten.is_nonzero", "aten.allclose",
})

#: aten op packets that sync when an index is a boolean mask.
_MASK_INDEX_OPS = frozenset({"aten.index", "aten.index_put", "aten.index_put_",
                             "aten._index_put_impl_"})

#: Tensor methods that copy to the host (a no-op on a CPU tensor, so they
#: are hooked in Python: no aten op shows them on the CPU).
HOST_READ_METHODS = ("cpu", "numpy", "tolist", "item")

#: Calls in a wrapper's CUDA route that read the device on the host.
_STATIC_SYNC_CALLS = frozenset({
    "item", "tolist", "cpu", "numpy", "synchronize", "unique", "nonzero",
    "masked_select",
})

#: What torch's sync debug mode says of a synchronising call (its
#: warning under "warn", its error under "error"; not its one-time notice
#: that the mode is a prototype).
SYNC_DEBUG_MESSAGE = "called a synchronizing CUDA operation"

#: The sanctioned host boundary inside a wrapper (`kernels.work.paused`).
SYNC_BOUNDARY = "paused"

#: Host calls in CUDA sources that wait for the device.
_CUDA_SYNC = re.compile(
    r"\b(cudaDeviceSynchronize|cudaStreamSynchronize|cudaEventSynchronize|"
    r"cudaMemcpy(?!Async)\w*|cudaFree)\s*\("
)

_TORCH_DIR = None
_THIS = Path(__file__).resolve()
_STDLIB = Path(sysconfig.get_paths()["stdlib"]).resolve()


def _torch_dir() -> Path:
    global _TORCH_DIR
    if _TORCH_DIR is None:
        import torch

        _TORCH_DIR = Path(torch.__file__).resolve().parent
    return _TORCH_DIR


def _rel(path: str, root: Path) -> str:
    p = Path(path).resolve()
    try:
        return p.relative_to(root).as_posix()
    except ValueError:
        return p.as_posix()


def _site(root: Path, frame=None) -> tuple[str, int]:
    """(file, line) of the innermost frame that is neither torch, the
    standard library nor this module: where a finding's op was issued."""
    f = frame or sys._getframe(1)
    torch_dir = _torch_dir()
    while f is not None:
        p = Path(f.f_code.co_filename).resolve()
        if p != _THIS and not p.is_relative_to(torch_dir) and not p.is_relative_to(_STDLIB):
            return _rel(f.f_code.co_filename, root), f.f_lineno
        f = f.f_back
    return "<unknown>", 1


def _traceback_site(exc: BaseException, root: Path) -> tuple[str, int]:
    tb, best = exc.__traceback__, ("<unknown>", 1)
    torch_dir = _torch_dir()
    while tb is not None:
        p = Path(tb.tb_frame.f_code.co_filename).resolve()
        if p != _THIS and not p.is_relative_to(torch_dir) and not p.is_relative_to(_STDLIB):
            best = (_rel(tb.tb_frame.f_code.co_filename, root), tb.tb_lineno)
        tb = tb.tb_next
    return best


def _sync_finding(where: str, what: str, file: str, line: int) -> Finding:
    return Finding(
        rule="HVB001", file=file, line=line, tier="B", anchor=f"{where}:{what}",
        message=(
            f"`{what}` inside the `{where}` dispatch forces a device-to-host "
            "synchronisation — the host waits for the card mid-wave and the "
            "launches behind it stop overlapping the host's work"
        ),
        hint=(
            "keep the value on the device (a tensor operand, a masked write, "
            "a host mirror the caller already holds), or move the read "
            "after the dispatch"
        ),
    )


# ── HVB001 at run time: the op recorder ──────────────────────────────


class _Recorder:
    """The run-time half of HVB001 and HVB002 over one program: a
    `TorchDispatchMode` for aten ops, hooks on the Tensor host reads and
    `torch.cuda.synchronize`, and a profile hook that scopes kernel
    wrappers (their ops are the launch's stand-ins) and checks each
    wrapper's in-place writes against its version counters."""

    def __init__(self, root: Path, wrappers: dict, where: str, host_sync: bool,
                 versions: bool, active: Callable[[], bool]) -> None:
        self.root, self.where = root, where
        self.codes = {fn.__code__: name for name, fn in wrappers.items()}
        self.host_sync, self.versions, self.active = host_sync, versions, active
        self.findings: list[Finding] = []
        self.seen: set[tuple] = set()
        self.depth = 0
        self.busy = False
        self.stack: list = []
        self.wrote: dict[str, set[str]] = {}

    # HVB001 -----------------------------------------------------------

    def note_sync(self, what: str, frame=None, on_device: bool = False) -> None:
        """Record one host sync at its site. `on_device`: the card's sync
        debug mode saw it, so it is real even inside a kernel wrapper."""
        if self.busy or (self.depth and not on_device) or not self.host_sync \
                or not self.active():
            return
        file, line = _site(self.root, frame or sys._getframe(2))
        key = (file, line)  # one finding a site: `.item()` is also its aten op
        if key not in self.seen:
            self.seen.add(key)
            self.findings.append(_sync_finding(self.where, what, file, line))

    def mode(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode

        rec = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                packet = str(func.overloadpacket)
                if packet in HOST_SYNC_OPS:
                    rec.note_sync(packet, sys._getframe(1))
                elif packet in _MASK_INDEX_OPS:
                    idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
                    if any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                           for i in (idx or ())):
                        rec.note_sync(f"{packet}[bool mask]", sys._getframe(1))
                elif packet in ("aten._to_copy", "aten.copy_"):
                    out_dev = kwargs.get("device")
                    src = args[1] if packet == "aten.copy_" else args[0]
                    dst_cpu = (out_dev is not None and torch.device(out_dev).type == "cpu") or (
                        packet == "aten.copy_" and args[0].device.type == "cpu")
                    if dst_cpu and isinstance(src, torch.Tensor) and src.device.type != "cpu":
                        rec.note_sync(f"{packet}[to cpu]", sys._getframe(1))
                return func(*args, **kwargs)

        return _Mode()

    @contextlib.contextmanager
    def host_read_hooks(self):
        import torch

        saved = {m: getattr(torch.Tensor, m) for m in HOST_READ_METHODS}
        saved_sync = torch.cuda.synchronize
        rec = self

        def hook(name, orig):
            def read(t, *a, **k):
                rec.note_sync(f"Tensor.{name}", sys._getframe(1))
                return orig(t, *a, **k)
            return read

        def sync(*a, **k):
            rec.note_sync("torch.cuda.synchronize", sys._getframe(1))
            return saved_sync(*a, **k)

        try:
            for m, orig in saved.items():
                setattr(torch.Tensor, m, hook(m, orig))
            torch.cuda.synchronize = sync
            yield
        finally:
            for m, orig in saved.items():
                setattr(torch.Tensor, m, orig)
            torch.cuda.synchronize = saved_sync

    # HVB002 -----------------------------------------------------------

    def profile(self, frame, event, arg):
        if event == "call" and frame.f_code in self.codes:
            self.depth += 1
            self.stack.append((frame, self._snapshot(frame) if self.versions else []))
        elif event == "return" and self.stack and self.stack[-1][0] is frame:
            _, snap = self.stack.pop()
            self.depth -= 1
            if self.versions:
                self._check(frame, snap)

    def _snapshot(self, frame) -> list:
        import torch

        out, seen = [], set()

        def visit(path, v, depth):
            if isinstance(v, torch.Tensor):
                if id(v) not in seen:
                    seen.add(id(v))
                    out.append((path, v, v._version, v.detach().clone()))
            elif depth < 3 and dataclasses.is_dataclass(v) and not isinstance(v, type):
                for f in dataclasses.fields(v):
                    visit(f"{path}.{f.name}", getattr(v, f.name, None), depth + 1)
            elif depth < 3 and isinstance(v, (tuple, list)):
                for i, x in enumerate(v):
                    visit(f"{path}[{i}]", x, depth + 1)

        self.busy = True
        try:
            code = frame.f_code
            for name in code.co_varnames[:code.co_argcount + code.co_kwonlyargcount]:
                visit(name, frame.f_locals.get(name), 0)
        finally:
            self.busy = False
        return out

    def _check(self, frame, snap) -> None:
        import torch

        name = self.codes[frame.f_code]
        written = self.wrote.setdefault(name, set())
        self.busy = True
        cuda = torch.cuda.is_available()
        prev = torch.cuda.get_sync_debug_mode() if cuda else 0
        try:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
            for path, t, v0, before in snap:
                now = t.detach()
                if now.shape == before.shape and _same_bytes(now, before):
                    continue
                written.add(path)
                if t._version == v0:
                    file = _rel(frame.f_code.co_filename, self.root)
                    key = ("HVB002", name, path)
                    if key not in self.seen:
                        self.seen.add(key)
                        self.findings.append(Finding(
                            rule="HVB002", file=file, line=frame.f_code.co_firstlineno,
                            tier="B", anchor=f"{name}:{path}",
                            message=(
                                f"`{name}` wrote `{path}` in place in the `{self.where}` "
                                "dispatch but its version counter did not move — a "
                                "write through a raw pointer is invisible to the "
                                "tenant arena's dirty tracking and to autograd"
                            ),
                            hint=(
                                "call `kernels.mtu._wrote(...)` on every tensor the "
                                "kernel writes, right after the launch"
                            ),
                        ))
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(prev)
            self.busy = False


def _same_bytes(a, b) -> bool:
    import torch

    if a.numel() == 0:
        return True
    x = a.contiguous().reshape(-1).view(torch.uint8)
    y = b.contiguous().reshape(-1).view(torch.uint8)
    return bool(torch.equal(x, y))


# ── HVB003: nested instrumented entries ──────────────────────────────


@contextlib.contextmanager
def _watch_entries(root: Path, where: str, forbidden: set[str], findings: list,
                   stack: list[str]):
    """Patch `CompileWatch.__call__` so every instrumented entry entered
    while another (or the program itself, `stack[0]`) runs is a finding."""
    from hypervisor_tpu_torch.observability import health

    orig = health.CompileWatch.__call__
    seen: set = set()

    def call(watch, *args, **kwargs):
        if stack:
            file, line = _site(root, sys._getframe(1))
            key = (watch.name, file, line)
            if key not in seen:
                seen.add(key)
                named = "a state.py dispatch entry" if watch.name in forbidden \
                    else "an instrumented entry"
                findings.append(Finding(
                    rule="HVB003", file=file, line=line, tier="B",
                    anchor=f"{where}:{watch.name}",
                    message=(
                        f"`{watch.name}` ({named}) runs nested inside the "
                        f"`{stack[-1]}` dispatch — the fused wave is no longer ONE "
                        "program: the compile watch and the roofline count the "
                        "nested entry as a dispatch of its own"
                    ),
                    hint=(
                        "call the op's module function directly inside the wave, "
                        "not its instrumented `state._*` entry"
                    ),
                ))
        stack.append(watch.name)
        try:
            return orig(watch, *args, **kwargs)
        finally:
            stack.pop()

    health.CompileWatch.__call__ = call
    try:
        yield
    finally:
        health.CompileWatch.__call__ = orig


# ── HVB001 from source: the wrappers' CUDA routes and csrc ───────────


def _cuda_route(fn: ast.FunctionDef) -> list[ast.stmt]:
    """The statements after the wrapper's `if not _route(...): return`."""
    for i, stmt in enumerate(fn.body):
        if isinstance(stmt, ast.If) and "_route(" in ast.unparse(stmt.test):
            return fn.body[i + 1:]
    return []


def _boundary(stmt: ast.AST) -> bool:
    return isinstance(stmt, ast.With) and any(
        SYNC_BOUNDARY in ast.unparse(item.context_expr) for item in stmt.items)


def lint_wrapper_sources(package_dir: Path) -> list[Finding]:
    """HVB001 over every kernel wrapper's CUDA route (Python) and every
    CUDA source under `csrc/`: host reads and stream/device syncs."""
    from hypervisor_tpu_torch.analysis.rules_ast import PortProject, derive_kernel_wrappers

    root = package_dir.parent
    findings: list[Finding] = []
    project = PortProject.load(package_dir)
    for mod, name, _ in derive_kernel_wrappers(project):
        fn = next(n for n in mod.tree.body if isinstance(n, ast.FunctionDef) and n.name == name)

        def visit(stmts):
            for stmt in stmts:
                if _boundary(stmt):
                    continue
                for n in ast.walk(stmt) if not isinstance(stmt, (ast.If, ast.With, ast.For,
                                                                ast.While, ast.Try)) \
                        else ast.walk(_header(stmt)):
                    if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                            and n.func.attr in _STATIC_SYNC_CALLS:
                        findings.append(_sync_finding(
                            f"{name} (CUDA route)", f".{n.func.attr}()", mod.rel, n.lineno))
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, field, None)
                    if isinstance(sub, list) and sub and isinstance(sub[0], ast.stmt):
                        visit(sub)
                for h in getattr(stmt, "handlers", []) or []:
                    visit(h.body)

        visit(_cuda_route(fn))
    csrc = package_dir / "csrc"
    for path in sorted(list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh"))) if csrc.exists() else []:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            code = line.split("//", 1)[0]
            m = _CUDA_SYNC.search(code)
            if m:
                findings.append(_sync_finding(
                    f"csrc/{path.name}", m.group(1), _rel(str(path), root), i))
    return findings


def _header(stmt: ast.stmt) -> ast.AST:
    """The part of a compound statement that runs before its body."""
    if isinstance(stmt, (ast.If, ast.While)):
        return stmt.test
    if isinstance(stmt, ast.For):
        return stmt.iter
    if isinstance(stmt, ast.With):
        return ast.Tuple(elts=[i.context_expr for i in stmt.items], ctx=ast.Load())
    return ast.Tuple(elts=[], ctx=ast.Load())


# ── the programs: the dispatched functions at tiny shapes ────────────

_ALL = frozenset({"host_sync", "one_program", "versions"})
_WRITES = frozenset({"one_program", "versions"})

#: (name, lints, scope) in run order; the first five are the
#: counterparts of the reference's traced targets
#: (`jaxpr_lint._trace_targets`). A scope is the instrumented entry the
#: program calls through: the host-sync rule reads only its run.
PROGRAMS: tuple[tuple[str, frozenset, Optional[str]], ...] = (
    ("governance_wave", _ALL, None),
    ("governance_wave_sanitized", _ALL, None),
    ("governance_wave_gateway", _ALL, None),
    ("governance_wave_state_call", _ALL, "governance_wave"),
    ("tenant_governance_wave_donated_call", _ALL, "tenant_governance_wave_donated"),
    ("saga_table_tick", _WRITES, "saga_table_tick"),
    ("slash_cascade", _WRITES, "slash_cascade"),
)

_B, _K, _TURNS, _ROWS = 4, 4, 2, 16


def _wave_inputs(dev):
    """Fresh tables and one wave's lanes: B joins into K sessions that
    live and die in the wave, two live vouch edges toward lane 0."""
    import torch

    from hypervisor_tpu_torch.observability import metrics as mp
    from hypervisor_tpu_torch.observability import tracing
    from hypervisor_tpu_torch.tables.logs import DeltaLog, EventLog, TraceLog
    from hypervisor_tpu_torch.tables.state import (
        SI32_MAX_PARTICIPANTS, SI32_STATE, AgentTable, ElevationTable, SagaTable,
        SessionTable, VouchTable,
    )

    agents = AgentTable.create(_ROWS, dev)
    sessions = SessionTable.create(_ROWS, dev)
    sessions.i32[:_K, SI32_STATE] = 1
    sessions.i32[:_K, SI32_MAX_PARTICIPANTS] = 8
    vouches = VouchTable.create(8, dev)
    vouches.voucher[:2] = torch.tensor([8, 9], dtype=torch.int32)
    vouches.vouchee[:2] = 0
    vouches.session[:2] = 0
    vouches.bond[:2] = 0.125
    vouches.active[:2] = True
    lanes = torch.arange(_B, dtype=torch.int32, device=dev)
    args = (
        agents, sessions, vouches, lanes, lanes + 100, lanes % _K,
        torch.full((_B,), 0.8, dtype=torch.float32, device=dev),
        torch.ones((_B,), dtype=torch.bool, device=dev),
        torch.zeros((_B,), dtype=torch.bool, device=dev),
        torch.arange(_K, dtype=torch.int32, device=dev),
        torch.arange(_TURNS * _K * 16, dtype=torch.int32, device=dev).reshape(_TURNS, _K, 16),
        0.0,
    )
    extras = dict(
        metrics=mp.REGISTRY.create_table(dev), trace=TraceLog.create(64, dev),
        trace_ctx=tracing.TraceContext(trace=1, span=2, wave_seq=0, sampled=True),
        delta_log=DeltaLog.create(64, dev), delta_cursor=0,
        elevations=ElevationTable.create(8, dev),
        epilogue_tables=(SagaTable.create(8, 4, dev), EventLog.create(16, dev)),
    )
    return args, extras


def _gateway_args(dev, a: int = 6):
    import torch

    slot = torch.arange(a, dtype=torch.int32, device=dev) % _B
    return (
        slot, torch.full((a,), 2, dtype=torch.int8, device=dev),
        torch.arange(a, device=dev) % 2 == 0, torch.zeros((a,), dtype=torch.bool, device=dev),
        torch.zeros((a,), dtype=torch.bool, device=dev),
        torch.zeros((a,), dtype=torch.bool, device=dev),
        torch.arange(a, device=dev) < a - 1,
    )


def _program(name: str, dev) -> Callable[[], object]:
    """A zero-argument call of one program on `dev`, inputs built."""
    import numpy as np
    import torch

    from hypervisor_tpu_torch import state as state_mod
    from hypervisor_tpu_torch.config import DEFAULT_CONFIG as cfg
    from hypervisor_tpu_torch.ops import pipeline, saga_ops
    from hypervisor_tpu_torch.tables import struct

    if name.startswith("governance_wave"):
        args, extras = _wave_inputs(dev)
        if name == "governance_wave":
            return lambda: pipeline.governance_wave(*args, **extras)
        if name == "governance_wave_sanitized":
            return lambda: pipeline.governance_wave(*args, **extras, sanitize=True)
        if name == "governance_wave_gateway":
            lanes_valid = torch.arange(_B, device=dev) < _B - 1
            return lambda: pipeline.governance_wave(
                *args, **extras, lanes_valid=lanes_valid, n_sessions_valid=_K - 1,
                gateway_args=_gateway_args(dev), sanitize=True, config=cfg)
        # As `HypervisorState._governance_wave_impl` calls it: through the
        # instrumented entry, a contiguous range, unique sessions.
        return lambda: state_mod._WAVE(
            *args, 0.5, trust=cfg.trust,
            ring_bursts=cfg.rate_limit.ring_bursts, wave_range=(0, _K),
            unique_sessions=True, sanitize=False, config=cfg, **extras)
    if name == "tenant_governance_wave_donated_call":
        t = 2
        stacked = [_wave_inputs(dev) for _ in range(t)]
        tables = [struct.stack([s[0][i] for s in stacked]) for i in range(3)]
        ex = [struct.stack([s[1][k] for s in stacked])
              for k in ("metrics", "delta_log")]
        epi = [struct.stack([s[1]["epilogue_tables"][i] for s in stacked]) for i in range(2)]
        elev = struct.stack([s[1]["elevations"] for s in stacked])
        lanes = [torch.stack([s[0][i] for s in stacked]) for i in range(3, 11)]
        return lambda: state_mod._TENANT_WAVE_DONATED(
            *tables, *ex, epi[0], epi[1], elev, *lanes, [0] * t, [_K] * t,
            torch.ones((t, _B), dtype=torch.bool, device=dev), [_K] * t, 0.0, 0.5,
            cfg.rate_limit.ring_bursts, delta_cursors=[0] * t, trust=cfg.trust,
            sanitize=True, config=cfg)
    if name == "saga_table_tick":
        from hypervisor_tpu_torch.observability import metrics as mp
        from hypervisor_tpu_torch.tables.state import SagaTable

        g = SagaTable.create(8, 4, dev)
        g.n_steps[:4] = 3
        g.retries_left[:4] = 1
        g.has_undo[:4] = True
        g.saga_state[2:4] = saga_ops.SAGA_COMPENSATING
        g.step_state[2:4, 0] = saga_ops.STEP_COMMITTED
        g.cursor[2:4] = 1
        ok = np.array([True, False, True, False] + [False] * 4)
        tried = np.array([True] * 4 + [False] * 4)
        outcomes = torch.from_numpy(saga_ops.pack_outcomes(ok, ok, tried, tried)).to(dev)
        metrics = mp.REGISTRY.create_table(dev)
        return lambda: state_mod._SAGA_TICK(
            g.step_state, g.retries_left, g.has_undo, g.saga_state, g.n_steps, g.cursor,
            outcomes, metrics=metrics)
    if name == "slash_cascade":
        from hypervisor_tpu_torch.observability import metrics as mp

        (agents, _, vouches, *_), _ = _wave_inputs(dev)
        agents.sigma_eff[:] = 0.7
        seeds = torch.zeros((_ROWS,), dtype=torch.bool, device=dev)
        seeds[0] = True
        metrics = mp.REGISTRY.create_table(dev)
        return lambda: state_mod._SLASH(vouches, agents.sigma_eff, seeds, 0, 0.5, 0.0,
                                        metrics=metrics)
    raise KeyError(name)


# ── the tier driver ──────────────────────────────────────────────────


def lint_program(
    where: str,
    call: Callable[[], object],
    *,
    lints: Iterable[str] = ("host_sync", "one_program", "versions"),
    root: Optional[Path] = None,
    wrappers: Optional[dict] = None,
    forbidden: Iterable[str] = (),
    sync_debug: Optional[str] = None,
    scope: Optional[str] = None,
) -> tuple[list[Finding], dict[str, set[str]]]:
    """Run one program under the Tier B instruments and lint it.

    `wrappers` (name -> function) are the kernel wrappers whose ops stand
    for a launch and whose in-place writes are version-checked (default:
    `kernels.WRAPPERS`). `scope`, when given, limits HVB001 to the time
    the instrumented entry of that name runs (the program's host staging
    around it is not the wave). `sync_debug` ("warn" or "error", the card
    only) also runs the program under `torch.cuda.set_sync_debug_mode`:
    under "warn" every synchronising call the mode sees is a finding at
    its site; under "error" the first one raises and ends the program.
    Returns the findings and, per wrapper that ran, the argument paths
    it wrote."""
    import torch

    from hypervisor_tpu_torch import kernels

    root = root or Path(__file__).resolve().parents[2]
    lints = set(lints)
    wrappers = dict(kernels.WRAPPERS) if wrappers is None else wrappers
    stack: list[str] = [] if scope else [where]
    rec = _Recorder(root, wrappers, where, "host_sync" in lints, "versions" in lints,
                    active=(lambda: scope in stack) if scope else (lambda: True))
    findings: list[Finding] = []
    nested: list[Finding] = []
    watch = _watch_entries(root, where, set(forbidden), nested, stack) \
        if "one_program" in lints or scope else contextlib.nullcontext()
    old_profile = sys.getprofile()
    debug_warnings = warnings.catch_warnings() if sync_debug == "warn" \
        else contextlib.nullcontext()

    def on_warning(message, category, filename, lineno, file=None, line=None):
        if SYNC_DEBUG_MESSAGE in str(message):
            rec.note_sync("cuda sync (sync debug mode)", sys._getframe(1), on_device=True)

    try:
        with watch, rec.host_read_hooks(), rec.mode(), debug_warnings:
            if sync_debug == "warn":
                warnings.simplefilter("always")
                warnings.showwarning = on_warning
            sys.setprofile(rec.profile)
            if sync_debug:
                torch.cuda.set_sync_debug_mode(sync_debug)
            try:
                call()
            except RuntimeError as exc:
                if not (sync_debug == "error" and SYNC_DEBUG_MESSAGE in str(exc)):
                    raise
                file, line = _traceback_site(exc, root)
                findings.append(_sync_finding(where, "cuda sync (sync debug mode)", file, line))
            finally:
                if sync_debug:
                    torch.cuda.set_sync_debug_mode(0)
                sys.setprofile(old_profile)
    finally:
        sys.setprofile(old_profile)
    if "one_program" in lints:
        findings += nested
    return findings + rec.findings, rec.wrote


def run_tier_b(package_dir: Optional[Path] = None, device: str = "cuda") -> list[Finding]:
    """Run every program in `PROGRAMS` on `device` and lint it, then the
    wrappers' sources; returns the findings. `device` is never replaced:
    "cuda" without a card raises (`resolve_device`)."""
    import torch

    from hypervisor_tpu_torch import resolve_device
    from hypervisor_tpu_torch.analysis.rules_ast import (
        PortProject, derive_entry_points, derive_inplace_wrappers,
    )

    package_dir = package_dir or Path(__file__).resolve().parents[1]
    root = package_dir.parent
    dev = resolve_device(device)
    project = PortProject.load(package_dir)
    state_ast = project.module("state.py")
    entries = derive_entry_points(state_ast) if state_ast is not None else {}
    findings: list[Finding] = []
    wrote: dict[str, set[str]] = {}
    programs: list[str] = []
    saved = os.environ.get("HV_ROOFLINE")
    os.environ["HV_ROOFLINE"] = "0"
    try:
        for name, lints, scope in PROGRAMS:
            on_card = dev.type == "cuda" and "host_sync" in lints
            got, w = lint_program(
                name, _program(name, dev), lints=lints, root=root,
                forbidden=set(entries) - {scope or ""},
                sync_debug="warn" if on_card else None, scope=scope)
            if on_card:
                # Again on fresh inputs with the mode at "error": the first
                # synchronising call, if any, raises inside the program.
                torch.cuda.synchronize(dev)
                again, _ = lint_program(name, _program(name, dev), lints={"host_sync"},
                                        root=root, sync_debug="error", scope=scope)
                sites = {(f.file, f.line) for f in got}
                got += [f for f in again if (f.file, f.line) not in sites]
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            findings += got
            for k, v in w.items():
                wrote.setdefault(k, set()).update(v)
            programs.append(name)
    finally:
        if saved is None:
            os.environ.pop("HV_ROOFLINE", None)
        else:
            os.environ["HV_ROOFLINE"] = saved
    for mod, name, line in derive_inplace_wrappers(project):
        if not wrote.get(name):
            findings.append(Finding(
                rule="HVB002", file=mod.rel, line=line, tier="B", anchor=f"{name}:coverage",
                message=(
                    f"in-place wrapper `{name}` wrote nothing in any Tier B program — its "
                    "version counters went unchecked"
                ),
                hint="add a program to dispatch_lint.PROGRAMS that reaches it",
            ))
    findings += lint_wrapper_sources(package_dir)
    run_tier_b.last_programs = programs  # type: ignore[attr-defined]
    run_tier_b.last_wrappers = {k: sorted(v) for k, v in sorted(wrote.items())}  # type: ignore[attr-defined]
    run_tier_b.last_device = str(dev)  # type: ignore[attr-defined]
    return findings


run_tier_b.last_programs = []  # type: ignore[attr-defined]
run_tier_b.last_wrappers = {}  # type: ignore[attr-defined]
run_tier_b.last_device = None  # type: ignore[attr-defined]
