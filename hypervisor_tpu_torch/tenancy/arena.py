"""TenantArena: the `[T, ...]` state layer, one dispatch for T tenants.

The arena OWNS the device state: every tenant's AgentTable,
SessionTable, VouchTable, SagaTable, ElevationTable, its DeltaLog,
EventLog and TraceLog rings and its metrics table live STACKED along a
leading tenant axis in `_stacked` (`tables.struct.stack`: one
contiguous allocation a column). Tenants are full `HypervisorState`s
(`TenantState`) whose table attributes route through the arena's
lend/commit component protocol:

  * **lend**: reading `tenant.agents` lends that tenant's slice of the
    stack and caches it (`_tenant_local`), so every host op (joins,
    vouches, sagas, WAL records, checkpoints, integrity repairs, a solo
    wave on the tenant) works unchanged, per tenant. A lent column is
    the slice `stack[t]` as a tensor of its own: the same memory, so an
    in-place op writes through to the stack, but its own version
    counter, so the arena sees which tenant wrote.
  * **commit**: writing a table attribute (a rebind) or writing into a
    lent column marks the tenant dirty; `sync()` commits every dirty
    slice before the next batched dispatch, copying back only what a
    rebind detached from the stack.
  * **invalidate**: a batched wave writes the stacks and drops every
    tenant's lent slices of the tables it wrote.

The hot path never lends per-tenant state: a serving round is ONE
batched session create (`ops.pipeline.tenant_sessions_create`), ONE
batched tenant wave (`ops.pipeline.tenant_governance_wave`: each kernel
in its tenant form, launched as often for T tenants as the solo wave
launches it for one; tenant t's slice bit-identical to its own solo
wave), and the drain is ONE read of the stacked metrics table fanned
into per-tenant snapshots with `tenant="<id>"` labels. Isolation is
structural: a tenant's rows live in its own slice of every stack, its
refusals ride its own front door's queues, and the noisy-neighbour
drill holds neighbours' chain heads bit-identical to a solo run.
"""

from __future__ import annotations

import threading
import types
from contextlib import ExitStack
from typing import Optional, Sequence

import numpy as np
import torch

from hypervisor_tpu_torch import resolve_device, u32
from hypervisor_tpu_torch.config import DEFAULT_CONFIG, HypervisorConfig
from hypervisor_tpu_torch.models import SessionConfig, SessionState
from hypervisor_tpu_torch.observability import health as health_plane
from hypervisor_tpu_torch.observability import metrics as metrics_plane
from hypervisor_tpu_torch.observability import profiling
from hypervisor_tpu_torch.observability import roofline as roofline_plane
from hypervisor_tpu_torch.observability import tracing as trace_plane
from hypervisor_tpu_torch.ops import admission
from hypervisor_tpu_torch.state import (
    HypervisorState,
    _TENANT_SESSIONS_CREATE,
    _TENANT_UPDATE_GAUGES,
    _TENANT_WAVE_DONATED,
)
from hypervisor_tpu_torch.tables import struct
from hypervisor_tpu_torch.tables.logs import BODY_WORDS

#: The stacked components, in seal order: direct state attributes plus
#: the two device planes routed through the factory hooks
#: (`_make_metrics` / `_make_tracer`).
COMPONENTS: tuple[str, ...] = (
    "agents",
    "sessions",
    "vouches",
    "sagas",
    "elevations",
    "delta_log",
    "event_log",
    "metrics_table",
    "trace_table",
)
#: Components the batched wave writes.
_WAVE_WRITES = (
    "agents", "sessions", "vouches", "metrics_table", "delta_log",
)

_MISSING = object()


def _component_property(name: str):
    def _get(self):
        return self._comp_get(name)

    def _set(self, value):
        self._comp_set(name, value)

    return property(_get, _set)


def _versions(table) -> tuple:
    """The version counters of a lent table's columns (() for None)."""
    if table is None:
        return ()
    return tuple(v._version for v in struct.tensors(table).values())


def _lend(stacked, t: int):
    """Tenant t's slice of a stacked table, each column `col[t]` as a
    tensor of its own over the same memory (written through, with its own
    version counter)."""
    cols = {}
    for name, col in struct.tensors(stacked).items():
        view = col[t]
        lent = torch.empty(0, dtype=col.dtype, device=col.device)
        lent.set_(col.untyped_storage(), view.storage_offset(), view.shape, view.stride())
        cols[name] = lent
    return type(stacked)(**cols)


def _aliases(local, stacked, t: int) -> bool:
    """True when every column of `local` is tenant t's slice of the stack."""
    for name, col in struct.tensors(stacked).items():
        mine, view = getattr(local, name), col[t]
        if mine.data_ptr() != view.data_ptr() or mine.shape != view.shape:
            return False
    return True


class TenantState(HypervisorState):
    """One tenant's `HypervisorState`, its tables lent from the arena.

    Before the arena seals (during `__init__`) components live in
    `_tenant_local` like any solo state's. After `TenantArena._seal` the
    stack is authoritative: reads lend and cache a slice, rebinds mark
    the tenant dirty for the next `sync()`.
    """

    def __init__(
        self, config: HypervisorConfig = DEFAULT_CONFIG, device: str | torch.device = "cuda"
    ) -> None:
        self._tenant_local: dict = {}
        self._tenant_versions: dict = {}
        self._tenant_arena: Optional["TenantArena"] = None
        self._tenant_idx: int = -1
        super().__init__(config, device)

    # Direct table attributes route through the component protocol.
    agents = _component_property("agents")
    sessions = _component_property("sessions")
    vouches = _component_property("vouches")
    sagas = _component_property("sagas")
    elevations = _component_property("elevations")
    delta_log = _component_property("delta_log")
    event_log = _component_property("event_log")

    def _make_metrics(self) -> "metrics_plane.Metrics":
        return _TenantMetrics(self)

    def _make_tracer(self, capacity: int) -> "trace_plane.Tracer":
        return _TenantTracer(self, capacity)

    def _comp_get(self, name: str):
        local = self._tenant_local.get(name, _MISSING)
        if local is not _MISSING:
            return local
        arena = self._tenant_arena
        if arena is None:
            raise AttributeError(f"tenant component {name!r} unset before first write")
        value = arena.materialize(self._tenant_idx, name)
        self._tenant_local[name] = value
        self._tenant_versions[name] = _versions(value)
        return value

    def _comp_set(self, name: str, value) -> None:
        self._tenant_local[name] = value
        arena = self._tenant_arena
        if arena is not None:
            arena.note_dirty(self._tenant_idx, name)


class _TenantMetrics(metrics_plane.Metrics):
    """Metrics plane whose device table lives in the arena stack."""

    def __init__(self, owner: TenantState) -> None:
        self._owner = owner
        super().__init__(device=owner.device)

    @property
    def table(self):
        return self._owner._comp_get("metrics_table")

    @table.setter
    def table(self, value) -> None:
        self._owner._comp_set("metrics_table", value)


class _TenantTracer(trace_plane.Tracer):
    """Tracer whose device ring lives in the arena stack."""

    def __init__(self, owner: TenantState, capacity: int) -> None:
        self._owner = owner
        super().__init__(capacity=capacity, device=owner.device)

    @property
    def table(self):
        return self._owner._comp_get("trace_table")

    @table.setter
    def table(self, value) -> None:
        self._owner._comp_set("trace_table", value)


class _StaticFootprint:
    """Cached `footprint()` carrier for the health plane: per-tenant
    table footprints are config-derived metadata, computed once at seal,
    so publishing them lends no slice per drain."""

    def __init__(self, fp: dict) -> None:
        self._fp = fp

    def footprint(self) -> dict:
        return self._fp


class TenantWaveOut:
    """One tenant's view of a batched wave's results (host numpy,
    trimmed to the tenant's real lane and session counts)."""

    __slots__ = ("tenant", "status", "merkle_root", "fsm_error")

    def __init__(self, tenant, status, merkle_root, fsm_error):
        self.tenant = tenant
        self.status = status
        self.merkle_root = merkle_root
        self.fsm_error = fsm_error


class TenantArena:
    """T logical hypervisors behind one dispatch.

    Concurrency discipline: SUBMITS are free-threaded (host only: per-door
    queues, staging queues, shed gates), but DISPATCHES (the batched waves
    here and any per-tenant solo wave) come from one drain thread (the
    `TenantWaveScheduler`), the one-dispatch-thread contract of the solo
    front door. A solo dispatch lends tenant tables (under the arena
    lock) while holding the tenant's staging lock; a concurrent batched
    dispatch takes the locks in the opposite order, so two dispatch
    threads could deadlock; one drain thread makes the order moot.

    Tables live on `device` ("cuda" by default; it raises without CUDA).
    """

    def __init__(
        self,
        num_tenants: int,
        config: HypervisorConfig = DEFAULT_CONFIG,
        device: str | torch.device = "cuda",
    ) -> None:
        if num_tenants < 1:
            raise ValueError("num_tenants must be >= 1")
        self.config = config
        self.device = resolve_device(device)
        self.num_tenants = num_tenants
        # One lock for stack mutation (sync, dispatch, drain). Per-tenant
        # host ops take their own tenant locks as always.
        self._lock = threading.RLock()
        self.tenants: list[TenantState] = [
            TenantState(config, self.device) for _ in range(num_tenants)
        ]
        # The arena's own host metrics plane: stage brackets for the
        # batched dispatches (a T-tenant wall is not any one tenant's
        # latency) and the roofline observatory's measured-walls join.
        self.metrics = metrics_plane.Metrics(device=self.device)
        self._stacked: dict = {}
        self._dirty_sets: dict[str, set] = {name: set() for name in COMPONENTS}
        self._footprints: dict[str, dict] = {}
        self._pinned: dict = {}
        self.waves = 0            # batched governance waves dispatched
        self.last_wave: dict = {}
        self._seal()

    # ── the component protocol ───────────────────────────────────────

    def _get_component(self, state: TenantState, name: str):
        if name == "metrics_table":
            return state.metrics.table
        if name == "trace_table":
            return state.tracer.table
        return getattr(state, name)

    def _seal(self) -> None:
        """Stack every tenant's components into the `[T, ...]` tables and
        flip the tenants to arena-backed reads."""
        cap = self.config.capacity
        for name in COMPONENTS:
            vals = [self._get_component(st, name) for st in self.tenants]
            if all(v is None for v in vals):
                self._stacked[name] = None
            else:
                self._stacked[name] = struct.stack(vals)
        # Static per-tenant footprints (metadata), from tenant 0's
        # pre-seal tables: identical across tenants by construction.
        st0 = self.tenants[0]
        rows = {
            "agents": cap.max_agents,
            "sessions": cap.max_sessions,
            "vouches": cap.max_vouch_edges,
            "sagas": cap.max_sagas,
            "elevations": cap.max_elevations,
            "delta_log": cap.delta_log_capacity,
            "event_log": cap.event_log_capacity,
        }
        for name in COMPONENTS:
            val = self._get_component(st0, name)
            if val is None:
                continue
            key = {"metrics_table": "metrics", "trace_table": "trace_log"}.get(name, name)
            self._footprints[key] = struct.footprint(val, rows.get(name, 0))
        for t, st in enumerate(self.tenants):
            st._tenant_arena = self
            st._tenant_idx = t
            st._tenant_local.clear()
            st._tenant_versions.clear()

    def materialize(self, tenant: int, name: str):
        """Lend tenant `tenant`'s slice of one component (None when the
        component is off, e.g. the trace ring under HV_TRACE=0)."""
        stacked = self._stacked[name]
        if stacked is None:
            return None
        with self._lock:
            return _lend(stacked, tenant)

    def note_dirty(self, tenant: int, name: str) -> None:
        with self._lock:
            self._dirty_sets[name].add(tenant)

    @property
    def _dirty(self) -> dict[str, set]:
        """Component -> tenants with uncommitted writes: the rebinds noted
        at `_comp_set`, and every lent slice an in-place op wrote since it
        was lent or last committed (its version counters moved)."""
        for t, st in enumerate(self.tenants):
            for name, local in st._tenant_local.items():
                if t in self._dirty_sets[name] or local is None:
                    continue
                if st._tenant_versions.get(name) != _versions(local):
                    self._dirty_sets[name].add(t)
        return self._dirty_sets

    def sync(self) -> int:
        """Commit every dirty tenant slice to the stacks; returns the
        number of (tenant, component) commits. Runs before every batched
        dispatch, so slow-path host ops (vouching, saga creation,
        integrity repairs, per-tenant solo waves) and the batched hot path
        see one coherent state. A lent slice already lives in the stack;
        a rebound table is copied back and lent again. Runs in the span
        `tenant_sync`; counts the recorder's `tenant.commits` (the return)
        and `tenant.copied_back` (the rebound tables copied back)."""
        wrote = copied = 0
        with self._lock, profiling.stage_scope("tenant_sync"):
            dirty = self._dirty
            for name in COMPONENTS:
                pending = dirty[name]
                if not pending:
                    continue
                for t in sorted(pending):
                    st = self.tenants[t]
                    local = st._tenant_local.get(name, _MISSING)
                    if local is _MISSING or self._stacked[name] is None:
                        continue
                    stacked = self._stacked[name]
                    if local is None or not _aliases(local, stacked, t):
                        if local is not None:
                            struct.copy_into(struct.tenant_view(stacked, t), local)
                            copied += 1
                        local = st._tenant_local[name] = _lend(stacked, t)
                    st._tenant_versions[name] = _versions(local)
                    wrote += 1
                pending.clear()
        profiling.count("tenant.commits", wrote)
        profiling.count("tenant.copied_back", copied)
        return wrote

    def _invalidate(self, names: Sequence[str]) -> None:
        """Drop every tenant's lent slices of `names` (the stack is
        authoritative again, e.g. right after a batched wave wrote it).
        Dirty slices must have been committed first."""
        dirty = self._dirty
        for name in names:
            assert not dirty[name], (
                f"invalidate of {name} would drop uncommitted tenant "
                f"writes {sorted(dirty[name])}"
            )
            for st in self.tenants:
                st._tenant_local.pop(name, None)
                st._tenant_versions.pop(name, None)

    def splice_tenant(self, tenant: int, recovered) -> None:
        """Replace one arena slot's ENTIRE state with a recovered solo
        `HypervisorState`: the absorb half of fleet failover (a dead
        worker's tenant, restored from its checkpoint and WAL suffix by
        `resilience.recovery.recover_tenant`, lands in a survivor's slot).

        The splice goes through the component protocol (`_comp_set` +
        `sync`), so the stacked shapes never change and a warmed survivor
        absorbs with no novel signature. The recovered state's capacity
        must match this arena's (`adopt_host_from` refuses otherwise).
        Metrics and trace tables are not checkpointed, so the recovered
        state carries fresh ones: the splice wipes the slot's
        observability rings rather than leak the previous occupant's
        telemetry into the new tenant's view.
        """
        t = int(tenant)
        if not 0 <= t < self.num_tenants:
            raise ValueError(f"splice_tenant: slot {t} outside arena of {self.num_tenants}")
        with self._lock:
            self.sync()
            st = self.tenants[t]
            # Host bookkeeping first: it validates capacity parity
            # before any table write lands in the stacks.
            st.adopt_host_from(recovered)
            for name in COMPONENTS:
                if name == "metrics_table":
                    value = recovered.metrics.table
                elif name == "trace_table":
                    value = recovered.tracer.table
                    if value is not None:
                        st.tracer.cursor = recovered.tracer.cursor
                else:
                    value = getattr(recovered, name)
                if value is None:
                    continue
                st._comp_set(name, value)
            st._gauges_fresh = False
            self.sync()

    # ── batched session creation ─────────────────────────────────────

    def create_sessions_batch(
        self,
        ids_per_tenant: dict[int, list[str]],
        config: SessionConfig,
        pad_to: Optional[int] = None,
    ) -> dict[int, np.ndarray]:
        """Allocate each tenant's session rows in HANDSHAKING, ONE write
        for every tenant's creates (the batched twin of
        `HypervisorState.create_sessions_batch`; the session config is
        uniform across the round, mixed configs go through the per-tenant
        solo path). Returns tenant -> slots.

        `pad_to` pins the [T, K] lane shape to a serving bucket so the
        signature set stays CLOSED (the scheduler always passes its
        round's bucket; an unpadded call is a new signature per K)."""
        with self._lock:
            self.sync()
            k_max = max((len(v) for v in ids_per_tenant.values()), default=0)
            if k_max == 0:
                return {}
            if pad_to is not None:
                if pad_to < k_max:
                    raise ValueError(f"pad_to {pad_to} below the widest tenant batch {k_max}")
                k_max = int(pad_to)
            t_count = self.num_tenants
            rows = np.zeros((t_count, k_max), np.int32)
            sids = np.zeros((t_count, k_max), np.int32)
            valid = np.zeros((t_count, k_max), bool)
            slots_out: dict[int, np.ndarray] = {}
            for t, ids in sorted(ids_per_tenant.items()):
                if not ids:
                    continue
                st = self.tenants[t]
                slots = st._stage_sessions_batch(ids, config)
                slots_out[t] = slots
                rows[t, : len(ids)] = slots
                sids[t, : len(ids)] = [st.session_ids.intern(s) for s in ids]
                valid[t, : len(ids)] = True
            dev = self.device
            with self.metrics.stage("tenant_sessions_create"):
                _TENANT_SESSIONS_CREATE(
                    self._stacked["sessions"],
                    torch.from_numpy(rows).to(dev),
                    torch.from_numpy(sids).to(dev),
                    torch.from_numpy(valid).to(dev),
                    SessionState.HANDSHAKING.code,
                    config.consistency_mode.code,
                    int(config.max_participants),
                    float(config.min_sigma_eff),
                    bool(config.enable_audit),
                )
            self._invalidate(("sessions",))
        return slots_out

    # ── the batched governance wave ──────────────────────────────────

    def governance_wave_batch(
        self,
        lanes_per_tenant: dict[int, dict],
        bucket: int,
        now: float,
        omega: float = 0.5,
    ) -> dict[int, TenantWaveOut]:
        """The tenant-dense hot path: every participating tenant's fused
        governance wave as ONE batched wave.

        `lanes_per_tenant[t]` carries that tenant's wave inputs:
        `session_slots` (freshly created, contiguous), `dids`,
        `agent_sessions`, `sigma_raw`, `delta_bodies` (u32[turns, k,
        BODY_WORDS]) and optional `trustworthy`, each at most `bucket`
        lanes. Tenants absent from the dict idle through the wave as
        all-padding lanes in parked sessions (their tables untouched; the
        [T] shape is closed per (bucket, T) tile, so a warmed arena sees
        no novel signature: the solo scheduler's closed-bucket contract
        with the tenant axis).

        Per-tenant semantics are EXACTLY `run_governance_wave(...,
        pad_to=(bucket, bucket))`: the same staging, the same WAL record,
        the same membership, audit and frontier bookkeeping, bit-identical
        tables; that is what makes a tenant's WAL replay through the solo
        wave, and the noisy-neighbour drill's solo oracle, sound. Each
        tenant's ring append lands at its host cursor mirror.
        """
        turns = None
        for spec in lanes_per_tenant.values():
            t_this = np.asarray(spec["delta_bodies"]).shape[0]
            if turns is None:
                turns = t_this
            elif turns != t_this:
                raise ValueError(
                    "every tenant's delta_bodies must share one turn "
                    f"count (got {turns} and {t_this})"
                )
        if turns is None:
            turns = 1
        with self._lock:
            # Pre-dispatch gates per participating tenant (chaos,
            # scheduled corruption, integrity cadence) BEFORE sync so
            # injected table damage rides the commit.
            sanitize = False
            armed: list[TenantState] = []
            for t in sorted(lanes_per_tenant):
                st = self.tenants[t]
                st._predispatch("governance_wave", fused_sanitizer=True)
                plane = st.integrity
                if plane is not None and plane.take_fused_due():
                    sanitize = True
                    armed.append(st)
            self.sync()

            # Per-tenant host staging (numpy only), then ONE stack.
            staged: dict[int, dict] = {}
            shapes: dict[int, tuple[int, int]] = {}
            handles: dict[int, object] = {}
            slots_by_t: dict[int, np.ndarray] = {}
            journals = ExitStack()
            with profiling.stage_scope("tenant_staging"):
                for t in range(self.num_tenants):
                    st = self.tenants[t]
                    spec = lanes_per_tenant.get(t)
                    if spec is None:
                        session_slots = np.zeros((0,), np.int32)
                        dids: list = []
                        agent_sessions = np.zeros((0,), np.int32)
                        sigma_raw = np.zeros((0,), np.float32)
                        bodies = np.zeros((turns, 0, BODY_WORDS), np.uint32)
                        trustworthy = None
                    else:
                        session_slots = np.asarray(spec["session_slots"], np.int32)
                        dids = list(spec["dids"])
                        agent_sessions = np.asarray(spec["agent_sessions"], np.int32)
                        sigma_raw = np.asarray(spec["sigma_raw"], np.float32)
                        bodies = np.asarray(spec["delta_bodies"], np.uint32)
                        trustworthy = spec.get("trustworthy")
                        if len(dids) > bucket or len(session_slots) > bucket:
                            raise ValueError(
                                f"tenant {t} wave ({len(dids)} lanes, "
                                f"{len(session_slots)} sessions) exceeds "
                                f"bucket {bucket}"
                            )
                        if st.journal is not None:
                            journals.enter_context(
                                st._journal(
                                    "governance_wave",
                                    session_slots=session_slots,
                                    dids=dids,
                                    agent_sessions=agent_sessions,
                                    sigma_raw=sigma_raw,
                                    delta_bodies=bodies,
                                    now=float(now),
                                    omega=float(omega),
                                    trustworthy=(
                                        None
                                        if trustworthy is None
                                        else np.asarray(trustworthy, bool)
                                    ),
                                    use_pallas=False,
                                    actions=None,
                                    pad_to=[bucket, bucket],
                                )
                            )
                    slots_by_t[t] = session_slots
                    shapes[t] = (len(dids), len(session_slots))
                    agent_slots = st._claim_wave_rows(bucket)
                    parked = st._park_sessions(bucket - len(session_slots), "tenant bucket")
                    sw = st._stage_wave_lanes(
                        session_slots, dids, agent_sessions, sigma_raw,
                        trustworthy, bodies, bucket, bucket, parked,
                    )
                    sw["agent_slots"] = agent_slots
                    if sw["range_host"] is None:
                        raise RuntimeError(
                            "tenant wave sessions must be contiguous (fresh "
                            "arena-created blocks always are)"
                        )
                    staged[t] = sw
                    handles[t] = st.tracer.begin_wave(
                        "governance_wave",
                        sessions=sw["wave_sessions"][: len(session_slots)],
                        lanes=len(dids),
                        device=False,
                    )
            # Pre-wave cursors for the audit bookkeeping: the host mirrors.
            base_rows = [st._delta_cursor for st in self.tenants]
            dev = self.device

            def col(key, dtype=None):
                arr = np.stack([staged[t][key] for t in range(self.num_tenants)])
                return torch.from_numpy(
                    np.ascontiguousarray(arr if dtype is None else arr.astype(dtype))
                ).to(dev)

            lanes_valid = np.zeros((self.num_tenants, bucket), bool)
            n_sessions_valid = [shapes[t][1] for t in range(self.num_tenants)]
            los = [staged[t]["range_host"][0] for t in range(self.num_tenants)]
            his = [staged[t]["range_host"][1] for t in range(self.num_tenants)]
            for t in range(self.num_tenants):
                lanes_valid[t, : shapes[t][0]] = True

            with journals:
                with self.metrics.stage("tenant_governance_wave"):
                    result = _TENANT_WAVE_DONATED(
                        self._stacked["agents"],
                        self._stacked["sessions"],
                        self._stacked["vouches"],
                        self._stacked["metrics_table"],
                        self._stacked["delta_log"],
                        self._stacked["sagas"],
                        self._stacked["event_log"],
                        self._stacked["elevations"],
                        col("agent_slots"),
                        col("did"),
                        col("agent_sessions"),
                        col("sigma_raw"),
                        col("trustworthy"),
                        col("duplicate"),
                        col("wave_sessions"),
                        u32.from_numpy_u32(
                            np.stack([staged[t]["bodies"] for t in range(self.num_tenants)]),
                            dev,
                        ),
                        los,
                        his,
                        torch.from_numpy(lanes_valid).to(dev),
                        n_sessions_valid,
                        now,
                        omega,
                        self.config.rate_limit.ring_bursts,
                        delta_cursors=base_rows,
                        trust=self.config.trust,
                        sanitize=sanitize,
                        config=self.config,
                    )
            # The stacks were written in place: drop every lent slice of
            # them, and advance each tenant's cursor mirror.
            self._invalidate(_WAVE_WRITES)
            for t, st in enumerate(self.tenants):
                st._delta_cursor += shapes[t][1] * turns
            self.waves += 1
            profiling.count("tenant.lanes", sum(b for b, _ in shapes.values()))
            profiling.count("tenant.padded_lanes", self.num_tenants * bucket)

            # Host fan-out: ONE read per result field, numpy slices per
            # tenant for the bookkeeping and the callers' tickets.
            with profiling.stage_scope("tenant_fanout"):
                status = result.status.cpu().numpy()                # [T, bucket]
                chain = u32.to_numpy_u32(result.chain)              # [T, turns, bucket, 8]
                roots = u32.to_numpy_u32(result.merkle_root)        # [T, bucket, 8]
                fsm_err = result.fsm_error.cpu().numpy()
                out: dict[int, TenantWaveOut] = {}
                sanitizer_by_t = {}
                if sanitize and armed:
                    san = result.sanitizer
                    for st in armed:
                        t = st._tenant_idx
                        sanitizer_by_t[t] = type(san)(
                            *(x[t] if isinstance(x, torch.Tensor) else x for x in san)
                        )
                for t in range(self.num_tenants):
                    st = self.tenants[t]
                    sw = staged[t]
                    b, k = shapes[t]
                    ok = status[t, :b] == admission.ADMIT_OK
                    st._publish_wave_members(
                        sw["wave_keys"][ok].tolist(),
                        recycle_rows=sw["agent_slots"].tolist(),
                    )
                    if k:
                        st._book_wave_audit(slots_by_t[t], chain[t][:, :k], int(base_rows[t]))
                    st._gauges_fresh = True
                    th = handles[t]
                    if th is not None:
                        st.tracer.stamp_wave_host(th)
                        st.tracer.end_wave(th)
                    if t in sanitizer_by_t and st.integrity is not None:
                        st.integrity.absorb_fused(sanitizer_by_t[t])
                    if t in lanes_per_tenant:
                        out[t] = TenantWaveOut(
                            tenant=t,
                            status=status[t, :b],
                            merkle_root=roots[t, :k],
                            fsm_error=fsm_err[t, :k],
                        )
            self.last_wave = {
                "tenants_served": len(lanes_per_tenant),
                "bucket": bucket,
                "sanitized": bool(sanitize),
            }
        return out

    # ── drain: one read for all T tenants ────────────────────────────

    def metrics_snapshot(self) -> dict[int, "metrics_plane.MetricsSnapshot"]:
        """Drain every tenant's metrics plane out of ONE read of the
        stacked table. Gauges are fresh when the last dispatch was a
        tenant wave (its epilogue refreshed all T tenants); otherwise one
        batched `update_gauges` refreshes a copy of the stacked gauge
        column first (uncommitted, like the solo drain)."""
        with self._lock:
            self.sync()
            table = self._stacked["metrics_table"]
            if not all(st._gauges_fresh for st in self.tenants):
                table = struct.replace(table, gauges=table.gauges.clone())
                _TENANT_UPDATE_GAUGES(
                    table,
                    self._stacked["agents"],
                    self._stacked["sessions"],
                    self._stacked["vouches"],
                    self._stacked["sagas"],
                    self._stacked["elevations"],
                    self._stacked["delta_log"],
                    self._stacked["event_log"],
                    self._stacked["trace_table"],
                )
            host = metrics_plane._host_columns(table, self._pinned)
        shims = {name: _StaticFootprint(fp) for name, fp in self._footprints.items()}
        snaps: dict[int, metrics_plane.MetricsSnapshot] = {}
        for t, st in enumerate(self.tenants):
            health_plane.publish_compile_counters(st.metrics)
            roofline_plane.publish(st.metrics)
            st.health.publish_footprints(shims)
            host_t = types.SimpleNamespace(
                counters=host[0][t], gauges=host[1][t], hist=host[2][t], hist_sum=host[3][t],
            )
            snap = st.metrics.snapshot(host_table=host_t)
            st.health.update_occupancy(snap)
            if st.integrity is not None:
                st.integrity.observe_snapshot(snap)
            snaps[t] = snap
        # The arena's own host plane (stage walls for the batched
        # dispatches) publishes through the same drain pass.
        health_plane.publish_compile_counters(self.metrics)
        roofline_plane.publish(self.metrics)
        return snaps

    def metrics_prometheus(self) -> str:
        """One merged exposition: every tenant's series stamped with its
        `tenant="<id>"` label (per-class serving latency, SLO burn, sheds,
        occupancy), headers once, plus the arena's own stage brackets
        under `tenant="arena"`."""
        snaps = self.metrics_snapshot()
        parts = [
            snaps[t].to_prometheus(extra_labels={"tenant": str(t)}, emit_headers=(t == 0))
            for t in sorted(snaps)
        ]
        parts.append(
            self.metrics.snapshot().to_prometheus(
                extra_labels={"tenant": "arena"}, emit_headers=False
            )
        )
        return "".join(parts)

    # ── summaries (what /debug/tenants renders) ──────────────────────

    def summary(self, top_k: int = 8) -> dict:
        """The tenants panel: per-tenant live rows, queue depths, shed
        rates and SLO burn states, ranked by PRESSURE (deepest queues plus
        burn) so the top-K rows are the tenants that matter."""
        rows = []
        for t, st in enumerate(self.tenants):
            serving = st.serving
            depths: dict = {}
            shed = 0
            enqueued = 0
            burn = {}
            if serving is not None:
                depths = serving.queue_depths()
                shed = sum(serving.shed.values())
                enqueued = sum(serving.enqueued.values())
                burn = {q: serving.slo.state_of(q) for q in serving._queues}
            offered = enqueued + shed
            depth_total = sum(depths.values())
            burning = sum(1 for s in burn.values() if s != "ok")
            rows.append(
                {
                    "tenant": t,
                    "sessions_live": len(st._audit_rows),
                    "members": len(st._members),
                    "queue_depth": depth_total,
                    "queues": depths,
                    "shed": shed,
                    "shed_rate": round(shed / offered, 4) if offered else 0.0,
                    "slo_states": burn,
                    "pressure": depth_total + 64 * burning + shed,
                }
            )
        ranked = sorted(rows, key=lambda r: r["pressure"], reverse=True)
        return {
            "num_tenants": self.num_tenants,
            "waves": self.waves,
            "last_wave": dict(self.last_wave),
            "top_k": ranked[: max(1, top_k)],
            "tenants": rows,
        }

    # ── warmup ───────────────────────────────────────────────────────

    def warm(
        self,
        buckets: Sequence[int],
        now: float,
        session_config: Optional[SessionConfig] = None,
        turns: int = 1,
    ) -> dict:
        """Dispatch the (bucket, T) tenant-wave tile set once (and the
        sanitize variant when any tenant carries an integrity plane), so a
        serving soak meets no novel signature after it: the solo
        scheduler's closed-bucket contract with the tenant axis. Returns
        the compile-telemetry totals afterward."""
        cfg = session_config or SessionConfig(min_sigma_eff=0.0, max_participants=4)
        planes = [st.integrity for st in self.tenants if st.integrity is not None]
        sanitize_passes = (False, True) if planes else (False,)
        for bucket in sorted(set(buckets)):
            for sanitized in sanitize_passes:
                if sanitized:
                    for plane in planes:
                        plane._fused_due = True
                ids = {0: [f"tenant:warm:b{bucket}:s{int(sanitized)}"]}
                slots = self.create_sessions_batch(ids, cfg, pad_to=bucket)
                self.governance_wave_batch(
                    {
                        0: {
                            "session_slots": slots[0],
                            "dids": [f"did:tenant:warm:b{bucket}:s{int(sanitized)}"],
                            "agent_sessions": slots[0].copy(),
                            "sigma_raw": np.full(1, 0.8, np.float32),
                            "delta_bodies": np.zeros((turns, 1, BODY_WORDS), np.uint32),
                        }
                    },
                    bucket,
                    now=now,
                )
        # The drain's refresh (the stale-gauge fallback) runs here too, so
        # a mid-soak scrape never counts as a fresh signature.
        self.tenants[0]._gauges_fresh = False
        self.metrics_snapshot()
        summary = health_plane.compile_summary(last=0)
        return {
            k: summary[k]
            for k in ("programs", "compiles", "recompiles", "donation_failures")
        }


__all__ = ["TenantArena", "TenantState", "TenantWaveOut", "COMPONENTS"]
