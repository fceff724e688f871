"""The port's tables against the reference on the CPU: the packed layouts
and initial values, carrying a reference state across byte for byte,
the metrics rows the wave writes, and the port's import purity."""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hypervisor_tpu_torch
from hypervisor_tpu.config import DEFAULT_CONFIG, HypervisorConfig, TableCapacity
from hypervisor_tpu.models import ConsistencyMode, SessionConfig
from hypervisor_tpu.observability import metrics as jax_schema
from hypervisor_tpu.runtime.checkpoint import state_arrays
from hypervisor_tpu.state import HypervisorState
from hypervisor_tpu.tables import state as jax_ts
from hypervisor_tpu.tables.struct import replace as jax_replace
from hypervisor_tpu_torch import config as port_config
from hypervisor_tpu_torch import models as port_models
from hypervisor_tpu_torch import tables as port_tables
from hypervisor_tpu_torch import u32
from hypervisor_tpu_torch.observability import metrics as port_schema
from hypervisor_tpu_torch.state import HypervisorState as PortState
from hypervisor_tpu_torch.tables import metrics as port_metrics
from hypervisor_tpu_torch.tables import state as port_ts
from hypervisor_tpu_torch.tables.struct import replace as port_replace

CAP = dict(max_agents=64, max_sessions=32, max_vouch_edges=48)
_KEYS = ("agents", "sessions", "vouches", "elevations", "event_log")


def _jax_state() -> HypervisorState:
    state = HypervisorState(HypervisorConfig(capacity=TableCapacity(
        **CAP, max_sagas=16, max_steps_per_saga=4, max_elevations=16,
        delta_log_capacity=256, event_log_capacity=64, trace_log_capacity=128,
    )))
    state.create_sessions_batch([f"a{i}" for i in range(5)], SessionConfig(min_sigma_eff=0.3))
    state.create_sessions_batch(
        ["b0", "b1"],
        SessionConfig(consistency_mode=ConsistencyMode.STRONG, max_participants=4,
                      enable_audit=False),
    )
    rng = np.random.RandomState(0)
    e = jnp.arange(10)
    v = state.vouches
    state.vouches = jax_replace(
        v,
        voucher=v.voucher.at[e].set(rng.randint(0, 64, 10)),
        vouchee=v.vouchee.at[e].set(rng.randint(0, 64, 10)),
        session=v.session.at[e].set(rng.randint(0, 7, 10)),
        bond=v.bond.at[e].set(rng.uniform(0, 1, 10).astype(np.float32)),
        bond_pct=v.bond_pct.at[e].set(0.2),
        active=v.active.at[e].set(rng.uniform(size=10) > 0.3),
        expiry=v.expiry.at[e].set(rng.uniform(0, 100, 10).astype(np.float32)),
    )
    state.agents = jax_replace(
        state.agents,
        f32=jnp.asarray(rng.uniform(-1, 1, (64, 8)).astype(np.float32)),
        i32=jnp.asarray(rng.randint(-2**31, 2**31, (64, 21), dtype=np.int64).astype(np.int32)),
    )
    m = state.elevations.agent.shape[0]
    state.elevations = jax_replace(
        state.elevations,
        agent=jnp.asarray(rng.randint(-1, 64, m).astype(np.int32)),
        granted_ring=jnp.asarray(rng.randint(-128, 128, m).astype(np.int8)),
        expires_at=jnp.asarray(rng.uniform(0, 500, m).astype(np.float32)),
        active=jnp.asarray(rng.uniform(size=m) < 0.5),
    )
    c = state.event_log.event_type.shape[0]
    state.event_log = jax_replace(
        state.event_log,
        event_type=jnp.asarray(rng.randint(-1, 40, c).astype(np.int32)),
        agent=jnp.asarray(rng.randint(-1, 64, c).astype(np.int32)),
        trace=jnp.asarray(rng.randint(0, 2**32, c, dtype=np.uint64).astype(np.uint32)),
        span=jnp.asarray(rng.randint(0, 2**32, c, dtype=np.uint64).astype(np.uint32)),
        timestamp=jnp.asarray(rng.uniform(0, 500, c).astype(np.float32)),
        cursor=jnp.asarray(np.int32(c + 5)),
    )
    return state


def _arrays(state) -> dict[str, np.ndarray]:
    arrays = {k: v for k, v in state_arrays(state).items() if k.split(".")[0] in _KEYS}
    table = state.metrics.table
    counters = np.array(table.counters, copy=True)
    counters[:4] = [1, 2**32 - 1, 7, 2**31]
    arrays.update({
        f"metrics.{f.name}": np.array(getattr(table, f.name), copy=True)
        for f in dataclasses.fields(table)
    })
    arrays["metrics.counters"] = counters
    return arrays


def test_state_arrays_round_trip_byte_identical():
    arrays = _arrays(_jax_state())
    back = port_tables.to_state_arrays(port_tables.from_state_arrays(arrays, "cpu"))
    assert sorted(back) == sorted(arrays)
    for key, want in arrays.items():
        assert back[key].dtype == want.dtype, key
        assert back[key].shape == want.shape, key
        assert back[key].tobytes() == want.tobytes(), key


def test_saga_columns_round_trip_byte_identical():
    """`sagas.*` (the reference checkpoint's SagaTable block) crosses both
    ways byte for byte, beside the required tables."""
    state = _jax_state()
    rng = np.random.RandomState(4)
    g, m = state.sagas.step_state.shape
    state.sagas = jax_replace(
        state.sagas,
        step_state=jnp.asarray(rng.randint(0, 7, (g, m)).astype(np.int8)),
        retries_left=jnp.asarray(rng.randint(-128, 128, (g, m)).astype(np.int8)),
        has_undo=jnp.asarray(rng.uniform(size=(g, m)) < 0.5),
        timeout=jnp.asarray(rng.uniform(0, 600, (g, m)).astype(np.float32)),
        saga_state=jnp.asarray(rng.randint(0, 5, g).astype(np.int8)),
        session=jnp.asarray(rng.randint(-1, 7, g).astype(np.int32)),
        n_steps=jnp.asarray(rng.randint(0, m + 1, g).astype(np.int32)),
        cursor=jnp.asarray(rng.randint(-2**31, 2**31, g, dtype=np.int64).astype(np.int32)),
    )
    arrays = {k: v for k, v in state_arrays(state).items()
              if k.split(".")[0] in _KEYS + ("sagas",)}
    assert sum(k.startswith("sagas.") for k in arrays) == 8
    tables = port_tables.from_state_arrays(arrays, "cpu")
    assert tables.sagas is not None and tables.delta_log is None
    back = port_tables.to_state_arrays(tables)
    assert sorted(back) == sorted(arrays)
    for key, want in arrays.items():
        assert back[key].dtype == want.dtype and back[key].shape == want.shape, key
        assert back[key].tobytes() == want.tobytes(), key


def test_saga_table_create_matches_reference():
    want = jax_ts.SagaTable.create(37, 16)
    got = port_ts.SagaTable.create(37, 16, "cpu")
    fields = [f.name for f in dataclasses.fields(want)]
    assert fields == [f.name for f in dataclasses.fields(got)]
    for f in fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), f"SagaTable.{f}"
    port = PortState(port_config.HypervisorConfig(), device="cpu")
    assert tuple(port.sagas.step_state.shape) == (8_192, 16)
    assert port_config.DEFAULT_CONFIG.trust.max_cascade_depth == DEFAULT_CONFIG.trust.max_cascade_depth
    for f in ("sigma_floor", "cascade_wipe_epsilon"):
        assert getattr(port_config.DEFAULT_CONFIG.trust, f) == getattr(DEFAULT_CONFIG.trust, f)
    for f in ("max_sagas", "max_steps_per_saga"):
        assert getattr(port_config.DEFAULT_CONFIG.capacity, f) == getattr(DEFAULT_CONFIG.capacity, f)


@pytest.mark.parametrize("name", ["AgentTable", "SessionTable", "VouchTable", "ElevationTable"])
def test_create_matches_reference_initial_values(name):
    want = getattr(jax_ts, name).create(37)
    got = getattr(port_ts, name).create(37, "cpu")
    fields = [f.name for f in dataclasses.fields(want)]
    assert fields == [f.name for f in dataclasses.fields(got)]
    for f in fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), f"{name}.{f}"


def test_packed_column_indices_match_reference():
    names = [n for n in dir(jax_ts) if n.startswith(("AF32_", "AI32_", "SI32_", "SF32_", "FLAG_"))]
    for n in names:
        if n.startswith(("SI8_", "LEGACY")):
            continue
        assert getattr(port_ts, n) == getattr(jax_ts, n), n
    assert port_ts.KNOWN_FLAGS_MASK == jax_ts.KNOWN_FLAGS_MASK
    for cls in ("AgentTable", "SessionTable"):
        assert getattr(port_ts, cls)._PACKED == getattr(jax_ts, cls)._PACKED
    assert port_ts.AgentTable._SLICES == jax_ts.AgentTable._SLICES


def test_counter_indices_match_reference_registry():
    by_name = {h.name: h for h in jax_schema.REGISTRY.handles if h.kind == "counter"}
    for handle in port_schema.COUNTERS:
        assert by_name[handle.name].index == handle.index, handle.name
    for attr in ("WAVE_TICKS", "ADMITTED", "REFUSED", "SAGA_STEPS_COMMITTED",
                 "SAGA_STEPS_FAILED", "SESSIONS_ARCHIVED", "BONDS_RELEASED"):
        assert getattr(port_schema, attr).index == getattr(jax_schema, attr).index, attr
        assert getattr(port_schema, attr).name == getattr(jax_schema, attr).name, attr
    assert port_schema.WAVE_LANES.index == jax_schema.WAVE_LANES.index
    assert (port_schema.N_COUNTERS, port_schema.N_GAUGES, port_schema.N_HISTOGRAMS) == (
        jax_schema.REGISTRY.counts()
    )
    assert port_schema.DEFAULT_BUCKET_BOUNDS_US == jax_schema.DEFAULT_BUCKET_BOUNDS_US


def test_event_log_create_matches_reference():
    from hypervisor_tpu.tables.logs import EventLog as JaxEventLog
    from hypervisor_tpu_torch.tables.logs import EventLog

    want, got = JaxEventLog.create(37), EventLog.create(37, "cpu")
    fields = [f.name for f in dataclasses.fields(want)]
    assert fields == [f.name for f in dataclasses.fields(got)]
    for f in fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.shape == w.shape and g.tobytes() == w.tobytes(), f"EventLog.{f}"
    assert got.capacity_rows == want.capacity_rows == 37


def test_gauge_indices_match_reference_registry():
    """The occupancy and sanitizer gauges the epilogue writes, and the
    sanitizer's counters, sit on the reference registry's rows."""
    by_key = {(h.name, h.labels): h for h in jax_schema.REGISTRY.handles}
    for attr in ("AGENTS_ACTIVE", "QUARANTINED", "BREAKER_TRIPPED", "SESSIONS_LIVE",
                 "VOUCH_EDGES_ACTIVE", "INTEGRITY_VIOLATION_ROWS", "INTEGRITY_UNREPAIRABLE_ROWS",
                 "INTEGRITY_CHECKS", "INTEGRITY_VIOLATIONS"):
        want, got = getattr(jax_schema, attr), getattr(port_schema, attr)
        assert (got.name, got.index) == (want.name, want.index), attr
        assert by_key[(want.name, want.labels)] is want
    for got, want in zip(port_schema.RING_AGENTS, jax_schema.RING_AGENTS, strict=True):
        assert (got.name, got.index) == (want.name, want.index)
    assert list(port_schema.TABLE_LIVE_ROWS) == list(jax_schema.TABLE_LIVE_ROWS)
    for name, want in jax_schema.TABLE_LIVE_ROWS.items():
        got = port_schema.TABLE_LIVE_ROWS[name]
        assert (got.name, got.index) == (want.name, want.index), name


def test_metrics_table_matches_reference_layout():
    want = HypervisorState(DEFAULT_CONFIG).metrics.table
    got = port_metrics.MetricsTable.create(device="cpu")
    for f in dataclasses.fields(want):
        w, g = np.asarray(getattr(want, f.name)), getattr(got, f.name)
        assert tuple(g.shape) == w.shape, f.name
    np.testing.assert_array_equal(got.bounds.numpy(), np.asarray(want.bounds))


def test_counters_wrap_like_u32():
    m = port_metrics.MetricsTable.create(device="cpu")
    m.counters[0] = u32.narrow(torch.tensor(2**32 - 2))
    port_metrics.counter_add_many(m, (0, 1, 1), (5, torch.tensor(3), 4))
    assert u32.to_numpy_u32(m.counters[:2]).tolist() == [3, 7]
    port_metrics.observe(m, 13, torch.tensor([1.0, 3.0, 3.0, 1e9]))
    assert u32.to_numpy_u32(m.hist[13]).tolist()[:3] == [1, 0, 2]
    assert u32.to_numpy_u32(m.hist[13])[-1] == 1


def test_create_sessions_batch_matches_reference():
    ref = HypervisorState(HypervisorConfig(capacity=TableCapacity(max_sessions=16)))
    port = PortState(
        port_config.HypervisorConfig(capacity=port_config.TableCapacity(max_sessions=16)),
        device="cpu",
    )
    for ids, cfg_args in (
        (["x", "y", "z"], {}),
        (["p", "q"], dict(consistency_mode="strong", max_participants=3, min_sigma_eff=0.25,
                          enable_audit=False)),
    ):
        mode = cfg_args.pop("consistency_mode", "eventual")
        want = ref.create_sessions_batch(
            ids, SessionConfig(consistency_mode=ConsistencyMode(mode), **cfg_args)
        )
        got = port.create_sessions_batch(
            ids, port_models.SessionConfig(
                consistency_mode=port_models.ConsistencyMode(mode), **cfg_args
            )
        )
        np.testing.assert_array_equal(got, want)
    for f in ("i32", "f32", "enable_audit", "has_nonreversible"):
        assert getattr(port.sessions, f).numpy().tobytes() == np.asarray(
            getattr(ref.sessions, f)
        ).tobytes(), f
    assert [port.session_ids.string(h) for h in range(5)] == [
        ref.session_ids.string(h) for h in range(5)
    ]
    with pytest.raises(RuntimeError, match="session table full"):
        port.create_sessions_batch([f"o{i}" for i in range(12)], port_models.SessionConfig())


def test_replace_folds_virtual_columns_into_a_copy():
    a = port_ts.AgentTable.create(4, "cpu")
    b = port_replace(a, sigma_eff=torch.ones(4), flags=7, bd_window=torch.full((4, 18), 2))
    assert b.f32[:, port_ts.AF32_SIGMA_EFF].tolist() == [1.0] * 4
    assert b.flags.tolist() == [7] * 4 and b.bd_window.sum().item() == 4 * 18 * 2
    assert a.f32.sum().item() == 0 and a.flags.sum().item() == 0  # the original is untouched
    with pytest.raises(ValueError, match="shadow"):
        port_ts.table(packed={"f32": ("f32", 0)})(type("X", (), {"__annotations__": {"f32": int}}))


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
    return names


def test_port_imports_neither_jax_nor_the_reference_package():
    root = Path(hypervisor_tpu_torch.__file__).resolve().parent
    files = sorted(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
    assert len(files) >= 20
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "hypervisor_tpu"), f"{path}: imports {name}"
