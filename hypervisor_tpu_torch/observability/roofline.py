"""The roofline observatory: each program's modeled work, live.

The torch counterpart of `hypervisor_tpu.observability.roofline`. The
reference models each jitted program with XLA's `cost_analysis()`,
re-lowering its abstract signature; the port has no compiled program, so
it models the work the card must do itself, under the reference's names,
series and knobs:

  * **the count** — `observability.health.CompileWatch` treats the first
    dispatch of each novel abstract signature of a watched entry point as
    the port's "compile", and runs that one dispatch under `counting()`:
    a `TorchDispatchMode` adds up every aten op's bytes (tensor inputs
    read once, outputs written once; views, and allocations that touch
    no memory, cost nothing; a gather reads only what it gathers, a
    scatter writes only what it scatters) and operations (floating
    outputs as FLOPs, integer and boolean ones as integer operations),
    and every hand-written kernel, which a dispatch mode cannot see (it
    launches through ctypes), adds its `kernels.work.kernel_work` model
    at the launch's shapes (`kernels.work.note_launch`). Each op and
    launch is attributed to the innermost `profiling.stage_scope` open
    (the wave's `hv.<stage>` ranges), projected onto `HV_PHASES` through
    `attribution.WAVE_PHASE_OF` ("glue" outside every scope). Later
    dispatches of the same signature pay nothing: a warmed scheduler
    (`serving.WaveScheduler.warm`) has counted every (program, bucket).
  * **the registry** — `note_compile` queues the count; `resolve_pending`
    turns it into a `ProgramCost` at the metrics drain, off the dispatch
    path, as the reference resolves its captures.
  * **the join** — `publish()` runs at the metrics drain with no device
    work: modeled bytes and operations are host values, and the measured
    walls are the host-plane stage histograms the Tracer already brackets
    (`STAGE_OF_PROGRAM`). Published series: `hv_roofline_{modeled_bytes,
    modeled_flops,achieved_bw_frac,mfu}{program=...}`, the per-phase twins
    and `hv_roofline_floor_distance`. `modeled_flops` is every modeled
    operation, floating and integer; `mfu` is the operations' share: the
    FLOPs over the float rate plus the integer operations over the integer
    rate, over the wall.

Peaks: on CUDA the data-sheet rates of `torch.cuda.get_device_name()`
(`kernels.work.PEAKS`); a card not in that table publishes no share
unless `HV_ROOFLINE_PEAK_*` gives its rates. The CPU keeps the
reference's nominal host figures (64 GB/s, 2,000 G operations a second).

Knobs (env, read per call):
  `HV_ROOFLINE`            observatory on/off (default 1)
  `HV_ROOFLINE_PHASES`     keep the per-phase byte model (default 1)
  `HV_ROOFLINE_PEAK_BW_GBS`      peak memory GB/s
  `HV_ROOFLINE_PEAK_FLOPS_G`     peak float GFLOP/s
  `HV_ROOFLINE_PEAK_INT_OPS_G`   peak integer G operations a second
  `HV_ROOFLINE_DISPATCH_FLOOR_US`  floor of one dispatch for the distance
                                   gauge (default 5: one kernel launch
                                   on the H100, `chip_smoke.py` phase
                                   `sha_latency`)
  `HV_ROOFLINE_SHIFT_TOL`  relative modeled-bytes drift between two
                           counts of the SAME (program, signature) that
                           emits a `roofline.bytes_shift` event
                           (default 0.1)
  `HV_ROOFLINE_MIN_SAMPLES`  stage histogram samples before a measured
                             join publishes (default 2)
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import threading
import time
from collections import Counter, OrderedDict, deque
from typing import Iterable, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hypervisor_tpu_torch.observability import profiling
from hypervisor_tpu_torch.observability.attribution import HV_PHASES, WAVE_PHASE_OF

#: Wave phases the kernels carve the program into — the SAME vocabulary
#: the attribution plane splits measured walls across.
WAVE_PHASES: tuple[str, ...] = HV_PHASES


_WORK = None


def _work():
    """`kernels.work`, imported at first use (the kernels package imports
    the tables, which import this package)."""
    global _WORK
    if _WORK is None:
        from hypervisor_tpu_torch.kernels import work

        _WORK = work
    return _WORK


# ── env knobs (read per call: post-import arming must work) ──────────


def _env_float(name: str, default):
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def enabled() -> bool:
    return os.environ.get("HV_ROOFLINE", "1") not in ("0", "off", "false")


def _phases_enabled() -> bool:
    return os.environ.get("HV_ROOFLINE_PHASES", "1") not in (
        "0", "off", "false",
    )


def _dispatch_floor_us() -> float:
    return _env_float("HV_ROOFLINE_DISPATCH_FLOOR_US", 5.0)


def peak_rates(backend: Optional[str] = None) -> dict:
    """Peak memory bytes/s, float FLOP/s and integer operations/s for the
    roofline denominators.

    `backend` "cuda" takes the data-sheet rates of the first card
    (`kernels.work.PEAKS`, by `torch.cuda.get_device_name()`), None for a
    card not in the table; "cpu" the reference's NOMINAL host figures
    (64 GB/s, 2,000 G operations a second), so CPU fractions compare
    across runs, not as absolute truth. `HV_ROOFLINE_PEAK_BW_GBS`,
    `HV_ROOFLINE_PEAK_FLOPS_G` and `HV_ROOFLINE_PEAK_INT_OPS_G` override
    (read per call). None (the default) is "cuda" when a card is present.
    """
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    name = None
    if backend == "cuda":
        name = torch.cuda.get_device_name(0) if torch.cuda.is_available() else None
        card = _work().PEAKS.get(name)
        if card is None:
            bw, fl, io = None, None, None
        else:
            bw = card["hbm_bytes_s"] / 1e9
            fl = card["f32_ops_s"] / 1e9
            io = card["int32_ops_s"] / 1e9
    else:
        bw, fl, io = 64.0, 2_000.0, 2_000.0
    bw = _env_float("HV_ROOFLINE_PEAK_BW_GBS", bw)
    fl = _env_float("HV_ROOFLINE_PEAK_FLOPS_G", fl)
    io = _env_float("HV_ROOFLINE_PEAK_INT_OPS_G", io)
    return {
        "backend": backend,
        "device_name": name,
        "peak_bw_bytes_s": None if bw is None else bw * 1e9,
        "peak_flops_s": None if fl is None else fl * 1e9,
        "peak_int_ops_s": None if io is None else io * 1e9,
        "peak_bw_gbs": bw,
        "peak_flops_g": fl,
        "peak_int_ops_g": io,
    }


#: Watch name -> host stage-latency vocabulary (`metrics.STAGE_LATENCY`):
#: the join between the registry's models and the measured walls the
#: Tracer already brackets. Programs absent here (gauge refresh, sweeps)
#: publish model-only rows — there is no host bracket to join.
STAGE_OF_PROGRAM: dict[str, str] = {
    "governance_wave": "governance_wave",
    "governance_wave_donated": "governance_wave",
    "admit_batch": "admission_wave",
    "admit_batch_donated": "admission_wave",
    "saga_table_tick": "saga_round",
    "fanout_round": "saga_round",
    "terminate_batch": "terminate_wave",
    "gateway_check_actions": "gateway_wave",
    "slash_cascade": "slash_cascade",
    "breach_sweep": "breach_sweep",
    "merge_wave_session_states": "reconcile_wave_sessions",
    "tenant_governance_wave": "tenant_governance_wave",
    "tenant_governance_wave_donated": "tenant_governance_wave",
    "tenant_sessions_create": "tenant_sessions_create",
}

#: Programs whose count keeps the per-phase byte model (once per
#: program: the shares are shape-stable).
PHASE_PROGRAMS = ("governance_wave", "governance_wave_donated")


# ── the count: one dispatch's aten ops and kernel launches ───────────

#: Allocations that touch no memory.
_NO_TRAFFIC = frozenset({
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
    "resize_", "set_", "record_stream", "_record_function_enter_new",
    "_record_function_exit",
})
#: Ops that read only what they gather (their output) and the indices.
_GATHERS = frozenset({"index", "index_select", "gather", "take", "embedding",
                      "masked_select", "nonzero"})
#: Ops that write only what they scatter into their first argument.
_SCATTERS = frozenset({
    "index_put", "index_put_", "_index_put_impl", "_index_put_impl_", "index_copy",
    "index_copy_", "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
    "scatter_reduce_", "index_add", "index_add_", "index_fill", "index_fill_",
    "masked_scatter", "masked_scatter_", "put", "put_", "index_reduce", "index_reduce_",
})


def _tensors(value, out: list) -> list:
    if isinstance(value, torch.Tensor):
        out.append(value)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _tensors(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _tensors(v, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ProgramCount:
    """The modeled work of one dispatch, as it accumulates."""

    def __init__(self) -> None:
        self.bytes = 0
        self.flops = 0
        self.int_ops = 0
        self.ops = 0
        self.phase_bytes = {p: 0 for p in WAVE_PHASES}
        self.phase_bytes["glue"] = 0
        self.kernels: Counter = Counter()

    @staticmethod
    def _phase() -> str:
        stage = profiling.current_stage()
        if stage is None:
            return "glue"
        return WAVE_PHASE_OF.get(stage, "epilogue")

    def add_kernel(self, name: str, nbytes: int, int_ops: int) -> None:
        """One hand-written kernel's launch (`kernels.work.note_launch`)."""
        self.bytes += nbytes
        self.int_ops += int_ops
        self.kernels[name] += 1
        self.phase_bytes[self._phase()] += nbytes

    def add_op(self, func, args, kwargs, out) -> None:
        """One aten op: its bytes and operations, by the module's rules."""
        name = func.overloadpacket.__name__
        if name in _NO_TRAFFIC or getattr(func, "is_view", False):
            return
        ins = _tensors((args, kwargs), [])
        outs = _tensors(out, [])
        seen = {id(t) for t in ins}
        fresh = [t for t in outs if id(t) not in seen]
        if name in _GATHERS:
            idx = [t for t in ins[1:]]
            read = sum(_nbytes(t) for t in idx) + sum(_nbytes(t) for t in fresh)
            written = sum(_nbytes(t) for t in fresh)
            n_ops = max((t.numel() for t in fresh), default=0)
        elif name in _SCATTERS and ins:
            # The values scattered are the last tensor argument (indices
            # come before them); a scalar fill writes one index's worth.
            rest = ins[1:]
            read = sum(_nbytes(t) for t in rest)
            values = rest[-1] if rest else ins[0]
            written = min(_nbytes(ins[0]), _nbytes(values))
            n_ops = values.numel()
        elif name.endswith("_") and ins:
            # In place: the other inputs read, the first written.
            read = sum(_nbytes(t) for t in ins[1:])
            written = _nbytes(ins[0])
            n_ops = ins[0].numel()
        else:
            read = sum(_nbytes(t) for t in {id(t): t for t in ins}.values())
            written = sum(_nbytes(t) for t in fresh)
            n_ops = max([t.numel() for t in ins + fresh] or [0])
        nbytes = read + written
        first = (fresh or outs or ins or [None])[0]
        is_float = first is not None and first.is_floating_point()
        self.bytes += nbytes
        self.ops += 1
        if is_float:
            self.flops += n_ops
        else:
            self.int_ops += n_ops
        self.phase_bytes[self._phase()] += nbytes


class _OpCounter(TorchDispatchMode):
    """Passes every aten op through unchanged, adding it to a count."""

    def __init__(self, count: ProgramCount) -> None:
        super().__init__()
        self.count = count

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _work().is_paused():
            try:
                self.count.add_op(func, args, kwargs, out)
            except Exception:  # noqa: BLE001 — the count never breaks a dispatch
                pass
        return out


@contextlib.contextmanager
def counting() -> Iterator[Optional[ProgramCount]]:
    """Count the enclosed dispatch (its aten ops and kernel launches);
    yields the `ProgramCount`, or None when the observatory is off."""
    if not enabled():
        yield None
        return
    count = ProgramCount()
    stack = _work().open_counts()
    stack.append(count)
    try:
        with _OpCounter(count):
            yield count
    finally:
        stack.remove(count)


# ── the registry ─────────────────────────────────────────────────────


@dataclasses.dataclass(frozen=True)
class ProgramCost:
    """One (program, abstract signature)'s modeled work."""

    program: str
    sig_key: str
    signature: tuple[tuple[str, str], ...]
    captured_at: float
    compile_wall_ms: float
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    argument_bytes: Optional[int] = None
    output_bytes: Optional[int] = None
    temp_bytes: Optional[int] = None
    alias_bytes: Optional[int] = None
    generated_code_bytes: Optional[int] = None
    peak_bytes: Optional[int] = None
    error: Optional[str] = None
    int_ops: Optional[float] = None
    ops: Optional[int] = None
    kernels: Optional[dict] = None

    def to_dict(self) -> dict:
        return {
            "program": self.program,
            "sig_key": self.sig_key,
            "signature": [list(kv) for kv in self.signature],
            "captured_at": self.captured_at,
            "compile_wall_ms": round(self.compile_wall_ms, 3),
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "alias_bytes": self.alias_bytes,
            "generated_code_bytes": self.generated_code_bytes,
            "peak_bytes": self.peak_bytes,
            "error": self.error,
            "int_ops": self.int_ops,
            "ops": self.ops,
            "kernels": self.kernels,
        }

    def operations(self) -> float:
        return float(self.flops or 0) + float(self.int_ops or 0)


def _sig_digest(detail: Iterable[tuple[str, str]]) -> str:
    h = hashlib.sha1()
    for name, summary in detail:
        h.update(f"{name}={summary};".encode())
    return h.hexdigest()[:16]


def _live_bytes(value) -> int:
    return sum(_nbytes(t) for t in {id(t): t for t in _tensors(value, [])}.values())


class RooflineRegistry:
    """Process-global modeled work per (program, signature).

    Global on purpose, like `health._CompileLog`: the dispatch entries
    the models mirror are shared by every HypervisorState in the process,
    so the registry survives a supervisor's restore for free.
    """

    def __init__(self, per_program: int = 16) -> None:
        self._lock = threading.Lock()
        self._per_program = per_program
        self._models: dict[str, OrderedDict[str, ProgramCost]] = {}
        self._phase_models: dict[str, dict] = {}
        self._pending: deque = deque(maxlen=64)
        self._phase_shares: Optional[dict] = None
        self._events: deque = deque(maxlen=64)
        self._event_seq = 0
        self.captures = 0
        self.capture_failures = 0

    # -- intake (CompileWatch._record hook) -----------------------------

    def note_compile(
        self,
        program: str,
        count: Optional[ProgramCount],
        args: tuple = (),
        kwargs: Optional[dict] = None,
        out=None,
        *,
        detail: Iterable[tuple[str, str]],
        wall_ms: float = 0.0,
    ) -> None:
        """Queue one counted first dispatch. Cheap and exception-proof:
        the live input and output bytes are read NOW (tensor metadata,
        no buffer retained); the model resolves LATER (`resolve_pending`)."""
        if not enabled() or count is None:
            return
        try:
            arg_bytes = _live_bytes((args, kwargs or {}))
            in_ids = {id(t) for t in _tensors((args, kwargs or {}), [])}
            out_bytes = sum(_nbytes(t) for t in _tensors(out, []) if id(t) not in in_ids)
        except Exception:  # noqa: BLE001 — never break a dispatch
            return
        detail = tuple((str(k), str(v)) for k, v in detail)
        with self._lock:
            self._pending.append(
                (program, count, arg_bytes, out_bytes, detail, float(wall_ms))
            )

    # -- resolution -----------------------------------------------------

    def resolve_pending(self, limit: Optional[int] = None) -> int:
        """Turn up to `limit` queued counts into models (all when None).
        Returns the number resolved. Host arithmetic only."""
        resolved = 0
        while limit is None or resolved < limit:
            with self._lock:
                if not self._pending:
                    break
                item = self._pending.popleft()
            self._resolve_one(*item)
            resolved += 1
        return resolved

    def _resolve_one(self, program, count, arg_bytes, out_bytes, detail, wall_ms) -> None:
        sig_key = _sig_digest(detail)
        entry = ProgramCost(
            program=program,
            sig_key=sig_key,
            signature=detail,
            captured_at=time.time(),
            compile_wall_ms=wall_ms,
            flops=float(count.flops),
            bytes_accessed=float(count.bytes),
            argument_bytes=int(arg_bytes),
            output_bytes=int(out_bytes),
            temp_bytes=None,
            alias_bytes=None,
            generated_code_bytes=None,
            peak_bytes=int(arg_bytes + out_bytes),
            int_ops=float(count.int_ops),
            ops=int(count.ops),
            kernels=dict(sorted(count.kernels.items())),
        )
        with self._lock:
            buckets = self._models.setdefault(program, OrderedDict())
            prev = buckets.get(sig_key)
            buckets[sig_key] = entry
            buckets.move_to_end(sig_key)
            while len(buckets) > self._per_program:
                buckets.popitem(last=False)
            self.captures += 1
            shift = self._shift_of(prev, entry)
            if shift is not None:
                self._event_seq += 1
                self._events.append((self._event_seq, shift))
            if (program in PHASE_PROGRAMS and _phases_enabled()
                    and program not in self._phase_models):
                self._phase_models[program] = dict(count.phase_bytes)

    @staticmethod
    def _shift_of(prev, cur) -> Optional[dict]:
        """A recount of the SAME signature whose modeled bytes moved more
        than `HV_ROOFLINE_SHIFT_TOL` (relative) — the live regression
        canary."""
        if prev is None or prev.bytes_accessed is None:
            return None
        if cur.bytes_accessed is None or prev.bytes_accessed <= 0:
            return None
        tol = _env_float("HV_ROOFLINE_SHIFT_TOL", 0.1)
        rel = abs(cur.bytes_accessed - prev.bytes_accessed) / (
            prev.bytes_accessed
        )
        if rel <= tol:
            return None
        return {
            "program": cur.program,
            "sig_key": cur.sig_key,
            "prev_bytes": prev.bytes_accessed,
            "bytes": cur.bytes_accessed,
            "rel_shift": round(rel, 4),
            "tolerance": tol,
            "at": cur.captured_at,
        }

    # -- views ----------------------------------------------------------

    def latest(self, program: str) -> Optional[ProgramCost]:
        """Most recent successfully-modeled bucket of one program."""
        with self._lock:
            buckets = self._models.get(program)
            if not buckets:
                return None
            for entry in reversed(buckets.values()):
                if entry.error is None:
                    return entry
            return next(reversed(buckets.values()))

    def buckets(self, program: str) -> list[ProgramCost]:
        with self._lock:
            return list(self._models.get(program, {}).values())

    def programs(self) -> list[str]:
        with self._lock:
            return sorted(self._models)

    def phase_model(self, program: str) -> Optional[dict]:
        with self._lock:
            pm = self._phase_models.get(program)
            return dict(pm) if pm else None

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def set_phase_shares(self, shares: Optional[dict]) -> None:
        """Cache the latest measured wave-phase wall shares
        (`attribution.wave_phase_shares`, computed by whoever drained the
        tracer); the drain-time publisher reads this cache."""
        if shares:
            with self._lock:
                self._phase_shares = dict(shares)

    def phase_shares(self) -> Optional[dict]:
        with self._lock:
            return dict(self._phase_shares) if self._phase_shares else None

    def events_since(self, seq: int) -> tuple[int, list[dict]]:
        """Shift events newer than `seq` (per-deployment cursors)."""
        with self._lock:
            fresh = [(s, e) for s, e in self._events if s > seq]
            top = self._event_seq
        return top, [e for _, e in fresh]

    def reset(self) -> None:
        """Test hook: drop every model/pending/event."""
        with self._lock:
            self._models.clear()
            self._phase_models.clear()
            self._pending.clear()
            self._events.clear()
            self._phase_shares = None
            self._event_seq = 0
            self.captures = 0
            self.capture_failures = 0


_REGISTRY = RooflineRegistry()


def registry() -> RooflineRegistry:
    return _REGISTRY


def note_compile(
    program: str,
    count: Optional[ProgramCount],
    args: tuple = (),
    kwargs: Optional[dict] = None,
    out=None,
    *,
    detail: Iterable[tuple[str, str]],
    wall_ms: float = 0.0,
) -> None:
    """Module-level intake (what `CompileWatch._record` calls)."""
    _REGISTRY.note_compile(program, count, args, kwargs, out, detail=detail, wall_ms=wall_ms)


def resolve_pending(limit: Optional[int] = None) -> int:
    return _REGISTRY.resolve_pending(limit)


# ── the drain-time join ──────────────────────────────────────────────


def _wave_entry() -> Optional[ProgramCost]:
    return (
        _REGISTRY.latest("governance_wave_donated")
        or _REGISTRY.latest("governance_wave")
    )


def _measured_wall_us(metrics, stage: str) -> Optional[float]:
    from hypervisor_tpu_torch.observability import metrics as mp

    handle = mp.STAGE_LATENCY.get(stage)
    if handle is None:
        return None
    n, p50 = metrics.host_quantile(handle, 0.5)
    min_samples = int(_env_float("HV_ROOFLINE_MIN_SAMPLES", 2))
    if n < min_samples or p50 <= 0:
        return None
    return float(p50)


def _ops_share(flops: float, int_ops: float, wall_s: float, pk: dict) -> Optional[float]:
    """The operations' share of the peak rates over `wall_s`: the FLOPs
    over the float rate plus the integer operations over the integer
    rate (None when a rate is unknown)."""
    if pk["peak_flops_s"] is None or pk["peak_int_ops_s"] is None:
        return None
    return flops / wall_s / pk["peak_flops_s"] + int_ops / wall_s / pk["peak_int_ops_s"]


def floor_model(entry: Optional[ProgramCost] = None, backend: Optional[str] = None) -> Optional[dict]:
    """The fused wave's modeled floor: the larger of its modeled bytes over
    the peak memory rate and its modeled operations over the peak rates,
    floored by one dispatch (`HV_ROOFLINE_DISPATCH_FLOOR_US`). None when
    nothing is modeled or the card's rates are unknown."""
    entry = entry or _wave_entry()
    if entry is None or not entry.bytes_accessed:
        return None
    pk = peak_rates(backend)
    if pk["peak_bw_bytes_s"] is None:
        return None
    dispatch_floor = _dispatch_floor_us()
    bw_floor_us = float(entry.bytes_accessed) / pk["peak_bw_bytes_s"] * 1e6
    ops_s = _ops_share(float(entry.flops or 0), float(entry.int_ops or 0), 1.0, pk)
    ops_floor_us = None if ops_s is None else ops_s * 1e6
    return {
        "program": entry.program,
        "floor_bytes": int(entry.bytes_accessed),
        "bw_floor_us": round(bw_floor_us, 3),
        "ops_floor_us": None if ops_floor_us is None else round(ops_floor_us, 3),
        "dispatch_floor_us": dispatch_floor,
        "modeled_floor_us": round(max(bw_floor_us, ops_floor_us or 0.0, dispatch_floor), 3),
    }


def _backend_of(metrics) -> str:
    return metrics.table.counters.device.type


def publish(metrics, *, resolve_limit: Optional[int] = 8) -> None:
    """Join the registry's models with the measured host-plane walls and
    publish the `hv_roofline_*` gauges — called from
    `HypervisorState.metrics_snapshot` beside the compile-counter
    republish. HOST-ONLY: resolves a bounded batch of pending counts,
    reads host histograms, sets host-owned gauges."""
    if not enabled():
        return
    from hypervisor_tpu_torch.observability import metrics as mp

    _REGISTRY.resolve_pending(resolve_limit)
    backend = _backend_of(metrics)
    pk = peak_rates(backend)
    bw = pk["peak_bw_bytes_s"]
    wave_wall_us: Optional[float] = None
    wave_entry = _wave_entry()
    for program in mp.ROOFLINE_PROGRAMS:
        entry = _REGISTRY.latest(program)
        if entry is None or entry.error is not None:
            continue
        if entry.bytes_accessed is not None:
            metrics.gauge_set(
                mp.ROOFLINE_MODELED_BYTES[program], entry.bytes_accessed
            )
        metrics.gauge_set(mp.ROOFLINE_MODELED_FLOPS[program], entry.operations())
        stage = STAGE_OF_PROGRAM.get(program)
        if stage is None:
            continue
        wall_us = _measured_wall_us(metrics, stage)
        if wall_us is None:
            continue
        wall_s = wall_us / 1e6
        if entry.bytes_accessed and bw is not None:
            metrics.gauge_set(
                mp.ROOFLINE_ACHIEVED_BW_FRAC[program],
                entry.bytes_accessed / wall_s / bw,
            )
        mfu = _ops_share(float(entry.flops or 0), float(entry.int_ops or 0), wall_s, pk)
        if mfu is not None:
            metrics.gauge_set(mp.ROOFLINE_MFU[program], mfu)
        if wave_entry is not None and program == wave_entry.program:
            wave_wall_us = wall_us
    # Distance to the floor.
    floor = floor_model(wave_entry, backend)
    if floor is not None and wave_wall_us is not None:
        metrics.gauge_set(
            mp.ROOFLINE_FLOOR_DISTANCE,
            wave_wall_us / floor["modeled_floor_us"],
        )
    # Per-phase series: the counted byte model x cached measured shares.
    if wave_entry is None:
        return
    pb = _REGISTRY.phase_model(wave_entry.program)
    shares = _REGISTRY.phase_shares()
    if not pb:
        return
    phase_total = sum(pb.get(p, 0) for p in HV_PHASES) or 1
    flops, int_ops = float(wave_entry.flops or 0), float(wave_entry.int_ops or 0)
    for phase in HV_PHASES:
        pbytes = pb.get(phase, 0)
        metrics.gauge_set(mp.ROOFLINE_PHASE_BYTES[phase], pbytes)
        metrics.gauge_set(mp.ROOFLINE_PHASE_FLOPS[phase],
                          wave_entry.operations() * pbytes / phase_total)
        if shares and wave_wall_us:
            share = float(shares.get(phase, 0.0))
            if share > 0:
                phase_wall_s = wave_wall_us / 1e6 * share
                if bw is not None:
                    metrics.gauge_set(
                        mp.ROOFLINE_PHASE_BW_FRAC[phase],
                        pbytes / phase_wall_s / bw,
                    )
                mfu = _ops_share(flops * pbytes / phase_total, int_ops * pbytes / phase_total,
                                 phase_wall_s, pk)
                if mfu is not None:
                    metrics.gauge_set(mp.ROOFLINE_PHASE_MFU[phase], mfu)


# ── the /debug/roofline payload ──────────────────────────────────────


def summary(metrics, *, tracer=None, resolve_all: bool = True) -> dict:
    """Everything the observatory knows, joined: per-program catalog
    (every counted bucket), the modeled-vs-measured table, per-phase
    model + shares, the live-buffer peak, the headroom ranking, and the
    floor block. Passing `tracer` refreshes the phase shares (one drain
    of the trace ring); without it the cached shares serve."""
    if not enabled():
        return {"enabled": False}
    if resolve_all:
        _REGISTRY.resolve_pending(None)
    backend = _backend_of(metrics)
    pk = peak_rates(backend)
    bw = pk["peak_bw_bytes_s"]
    if tracer is not None:
        from hypervisor_tpu_torch.observability.attribution import (
            wave_phase_shares,
        )

        shares = wave_phase_shares(tracer)
        if shares:
            _REGISTRY.set_phase_shares(shares)
    shares = _REGISTRY.phase_shares()
    programs: dict[str, dict] = {}
    ranking: list[dict] = []
    for program in _REGISTRY.programs():
        entry = _REGISTRY.latest(program)
        if entry is None:
            continue
        stage = STAGE_OF_PROGRAM.get(program)
        wall_us = (
            _measured_wall_us(metrics, stage) if stage is not None else None
        )
        row = {
            "model": entry.to_dict(),
            "buckets": [b.to_dict() for b in _REGISTRY.buckets(program)],
            "stage": stage,
            "wall_p50_us": round(wall_us, 1) if wall_us else None,
            "achieved_bw_frac": None,
            "mfu": None,
            "modeled_floor_us": None,
            "distance": None,
        }
        floor = floor_model(entry, backend)
        if wall_us and entry.bytes_accessed and bw is not None:
            wall_s = wall_us / 1e6
            row["achieved_bw_frac"] = round(entry.bytes_accessed / wall_s / bw, 6)
            mfu = _ops_share(float(entry.flops or 0), float(entry.int_ops or 0), wall_s, pk)
            if mfu is not None:
                row["mfu"] = round(mfu, 9)
            floor_us = floor["modeled_floor_us"]
            row["modeled_floor_us"] = round(floor_us, 3)
            row["distance"] = round(wall_us / floor_us, 2)
            ranking.append(
                {
                    "program": program,
                    "wall_p50_us": round(wall_us, 1),
                    "modeled_floor_us": round(floor_us, 3),
                    "distance": row["distance"],
                }
            )
        programs[program] = row
    ranking.sort(key=lambda r: -r["distance"])
    wave_entry = _wave_entry()
    floor = floor_model(wave_entry, backend)
    if floor is not None and wave_entry is not None:
        stage = STAGE_OF_PROGRAM.get(wave_entry.program)
        wall_us = (
            _measured_wall_us(metrics, stage) if stage is not None else None
        )
        floor["measured_p50_us"] = round(wall_us, 1) if wall_us else None
        floor["distance"] = (
            round(wall_us / floor["modeled_floor_us"], 2)
            if wall_us
            else None
        )
    phases_block = None
    if wave_entry is not None:
        pb = _REGISTRY.phase_model(wave_entry.program)
        if pb:
            phases_block = {
                "program": wave_entry.program,
                "modeled_bytes": pb,
                "wall_shares": shares,
            }
    # The live-buffer peak: the largest program's inputs plus outputs
    # against the footprint() protocol's table bytes (both metadata).
    peak_program = max(
        (
            (e.peak_bytes, p)
            for p in _REGISTRY.programs()
            if (e := _REGISTRY.latest(p)) is not None and e.peak_bytes
        ),
        default=(0, None),
    )
    reg = _REGISTRY
    return {
        "enabled": True,
        "peaks": pk,
        "captures": reg.captures,
        "capture_failures": reg.capture_failures,
        "pending": reg.pending_count(),
        "programs": programs,
        "headroom": ranking,
        "worst_program": ranking[0]["program"] if ranking else None,
        "floor": floor,
        "phases": phases_block,
        "hbm": {
            "peak_program_bytes": int(peak_program[0]),
            "peak_program": peak_program[1],
        },
    }


__all__ = [
    "WAVE_PHASES",
    "ProgramCost",
    "ProgramCount",
    "RooflineRegistry",
    "STAGE_OF_PROGRAM",
    "counting",
    "enabled",
    "floor_model",
    "note_compile",
    "peak_rates",
    "publish",
    "registry",
    "resolve_pending",
    "summary",
]
