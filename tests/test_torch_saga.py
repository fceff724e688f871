"""The port's saga plane against the reference's, on the CPU.

* Kernel B7's plain version (`kernels.saga.saga_tick_block_plain`) is
  held against the reference's numpy twin `saga_tick_block_np` and
  against the unarmed `ops.saga_ops.saga_table_tick(wave_kernels=False)`
  (with its metrics tallies and trace stamps) on random tables in every
  step and saga code, cursors at, below and past `n_steps`, and random
  outcome and dispatch masks; and once at the default 8,192 x 16. The
  plain version's SAGA_STEPS_* tallies, and the whole metrics table the
  tick leaves, equal the reference's from counters seeded at 0xFFFFFFF0
  (the u32 wrap).
* The transition bits, the compensation and settle passes, the fan-out
  policy check and round, and the DSL parser against the reference's.
* One seeded sequence through `SagaScheduler` on the JAX package's
  `HypervisorState` (unarmed) and the port's `HypervisorState(device=
  "cpu")`: the create_saga refusals, the 5-step retry / compensate /
  escalate saga, a saga that commits, a step timeout, DSL sagas whose
  ALL and ANY fan-out policies fail, a mid-saga quarantine refused by
  the isolation gate, a kill-switch handoff through `apply_handoffs`,
  and `saga_work(comp_budget=...)`'s prefix. Every SagaTable column, the
  metrics counters, the TraceLog words, the scheduler's results, errors
  and attempt counts and the round count must be equal.

Tolerance 0 throughout. Trace ids are made deterministic by patching
`secrets.token_hex`.
"""

from __future__ import annotations

import asyncio
import itertools
import secrets
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervisor_tpu import config as jax_config
from hypervisor_tpu import models as jax_models
from hypervisor_tpu.kernels.wave_pallas import saga_tick_block_np
from hypervisor_tpu.observability import metrics as jax_schema
from hypervisor_tpu.observability import tracing as jax_tracing
from hypervisor_tpu.ops import saga_ops as jax_saga_ops
from hypervisor_tpu.runtime.checkpoint import state_arrays
from hypervisor_tpu.runtime.saga_scheduler import SagaScheduler as JaxScheduler
from hypervisor_tpu.saga import dsl as jax_dsl
from hypervisor_tpu.saga import fan_out as jax_fan_out
from hypervisor_tpu.saga import state_machine as jax_sm
from hypervisor_tpu.state import HypervisorState as JaxState
from hypervisor_tpu.tables import metrics as jax_metrics
from hypervisor_tpu.tables.logs import TraceLog as JaxTraceLog
from hypervisor_tpu.tables.state import FLAG_ACTIVE, FLAG_QUARANTINED
from hypervisor_tpu.tables.struct import replace as jax_replace
from hypervisor_tpu_torch import config as port_config
from hypervisor_tpu_torch import models as port_models
from hypervisor_tpu_torch import tables as port_tables
from hypervisor_tpu_torch.kernels import saga as saga_kernels
from hypervisor_tpu_torch.observability import tracing as port_tracing
from hypervisor_tpu_torch.ops import saga_ops
from hypervisor_tpu_torch.runtime.saga_scheduler import SagaScheduler as PortScheduler
from hypervisor_tpu_torch.saga import dsl as port_dsl
from hypervisor_tpu_torch.saga import fan_out as port_fan_out
from hypervisor_tpu_torch.saga import state_machine as port_sm
from hypervisor_tpu_torch.tables.logs import TraceLog as PortTraceLog
from hypervisor_tpu_torch.tables.metrics import MetricsTable as PortMetrics
from hypervisor_tpu_torch.tables.state import AI32_FLAGS

_COLS = ("step_state", "retries_left", "saga_state", "cursor", "committed", "exhausted")


def _random_table(rng: np.random.RandomState, g: int, m: int) -> dict:
    """A saga table in every step and saga code, biased so that many sagas
    book, retry, exhaust, compensate and settle in one round."""
    n_steps = rng.randint(0, m + 1, g).astype(np.int32)
    step = rng.choice([0, 0, 0, 1, 2, 2, 2, 3, 4, 5, 6], (g, m)).astype(np.int8)
    cursor = (n_steps + rng.randint(-3, 3, g)).astype(np.int32)
    at = np.clip(cursor, 0, m - 1)
    pending = rng.uniform(size=g) < 0.7  # most cursor steps wait for an outcome
    step[np.arange(g)[pending], at[pending]] = 0
    return {
        "step_state": step,
        "retries_left": rng.randint(-1, 3, (g, m)).astype(np.int8),
        "has_undo": rng.uniform(size=(g, m)) < 0.6,
        "saga_state": rng.choice([0, 0, 0, 1, 1, 2, 3, 4], g).astype(np.int8),
        "n_steps": n_steps,
        "cursor": cursor,  # at, below and past n_steps, a few negative
        "masks": [rng.uniform(size=g) < p for p in (0.6, 0.6, 0.8, 0.8)],
    }


def _port_tick(t: dict):
    cols = {k: torch.from_numpy(np.array(t[k], copy=True)) for k in (
        "step_state", "retries_left", "has_undo", "saga_state", "n_steps", "cursor")}
    outcomes = torch.from_numpy(saga_ops.pack_outcomes(*t["masks"]))
    committed, exhausted = saga_kernels.saga_tick_block_plain(
        cols["step_state"], cols["retries_left"], cols["has_undo"], cols["saga_state"],
        cols["n_steps"], cols["cursor"], outcomes)
    return (cols["step_state"].numpy(), cols["retries_left"].numpy(), cols["saga_state"].numpy(),
            cols["cursor"].numpy(), committed.numpy(), exhausted.numpy())


def _assert_cols(got, want, label):
    for name, g, w in zip(_COLS, got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, f"{label} {name}"
        assert g.tobytes() == w.tobytes(), f"{label} {name} diverged"


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("m", [4, 16])
def test_plain_tick_matches_numpy_twin(m, seed):
    """Twin rule: B7's plain version and the reference's `saga_tick_block_np`."""
    t = _random_table(np.random.RandomState(100 * m + seed), 257, m)
    want = saga_tick_block_np(t["step_state"], t["retries_left"], t["has_undo"], t["saga_state"],
                              t["n_steps"], t["cursor"], *t["masks"])
    got = _port_tick(t)
    _assert_cols(got, want, f"M={m}")
    assert want[4].sum() > 5 and want[5].sum() > 2  # the round booked and exhausted steps
    assert (want[2] != t["saga_state"]).sum() > 20     # and moved many sagas
    assert (want[1] != t["retries_left"]).sum() > 2    # and retried some


def _trace_pair(cap: int = 32):
    words = (0x1234ABCD, 0x0F0E0D0C)
    jax_ctx = jax_tracing.TraceContext(trace=jnp.uint32(words[0]), span=jnp.uint32(words[1]),
                                       wave_seq=jnp.int32(7), sampled=jnp.bool_(True))
    port_ctx = port_tracing.TraceContext(trace=words[0], span=words[1], wave_seq=7, sampled=True)
    return (JaxTraceLog.create(cap), jax_ctx), (PortTraceLog.create(cap, "cpu"), port_ctx)


def _tick_against_reference(t: dict):
    (jlog, jctx), (plog, pctx) = _trace_pair()
    jm = jax_metrics.MetricsTable.create(*jax_schema.REGISTRY.counts(),
                                         jax_schema.DEFAULT_BUCKET_BOUNDS_US)
    out = jax_saga_ops.saga_table_tick(
        jnp.asarray(t["step_state"]), jnp.asarray(t["retries_left"]), jnp.asarray(t["has_undo"]),
        jnp.asarray(t["saga_state"]), jnp.asarray(t["n_steps"]), jnp.asarray(t["cursor"]),
        *(jnp.asarray(x) for x in t["masks"]), metrics=jm, trace=jlog, trace_ctx=jctx,
        wave_kernels=False)
    cols = {k: torch.from_numpy(np.array(t[k], copy=True)) for k in (
        "step_state", "retries_left", "has_undo", "saga_state", "n_steps", "cursor")}
    pm = PortMetrics.create(device="cpu")
    got = saga_ops.saga_table_tick(
        cols["step_state"], cols["retries_left"], cols["has_undo"], cols["saga_state"],
        cols["n_steps"], cols["cursor"], torch.from_numpy(saga_ops.pack_outcomes(*t["masks"])),
        metrics=pm, trace=plog, trace_ctx=pctx)
    for name, g, w in zip(_COLS[:4], got[:4], out[:4]):
        assert g.numpy().tobytes() == np.asarray(w).tobytes(), name
    assert pm.counters.numpy().view(np.uint32).tobytes() == np.asarray(out[4].counters).tobytes()
    assert plog.words.numpy().view(np.uint32).tobytes() == np.asarray(out[5].words).tobytes()
    assert int(plog.cursor) == int(out[5].cursor) == 2
    return pm


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("m", [4, 16])
def test_tick_matches_reference_xla_tick(m, seed):
    """`ops.saga_ops.saga_table_tick` (B7's plain version on the CPU)
    against the reference's unarmed tick: columns, tallies and stamps."""
    pm = _tick_against_reference(_random_table(np.random.RandomState(100 * m + seed), 257, m))
    counters = pm.counters.numpy()
    assert counters[saga_kernels.schema.SAGA_STEPS_COMMITTED.index] > 0
    assert counters[saga_kernels.schema.SAGA_STEPS_FAILED.index] > 0


COUNTER_SEED = 0xFFFFFFF0  # the round's tallies wrap the u32 rows past 2^32


def _seeded_counters(rows) -> np.ndarray:
    c = np.zeros(jax_schema.REGISTRY.counts()[0], np.uint32)
    c[list(rows)] = COUNTER_SEED
    return c


def _table_bytes(m) -> dict:
    return {k: np.asarray(getattr(m, k)).tobytes() for k in ("counters", "gauges", "hist",
                                                               "hist_sum", "bounds")}


@pytest.mark.parametrize("m", [4, 16])
def test_plain_tick_books_the_reference_tallies_through_the_wrap(m):
    """B7's plain version adds the committed and exhausted counts to the
    counter column it is given, rows SAGA_STEPS_COMMITTED and
    SAGA_STEPS_FAILED, wrapping at 2^32 as the reference's u32 rows do."""
    t = _random_table(np.random.RandomState(40 + m), 1000, m)
    rows = saga_kernels.TALLY_ROWS
    seeded = _seeded_counters(rows)
    jm = jax_metrics.MetricsTable.create(*jax_schema.REGISTRY.counts(),
                                         jax_schema.DEFAULT_BUCKET_BOUNDS_US)
    jm = jax_replace(jm, counters=jnp.asarray(seeded))
    out = jax_saga_ops.saga_table_tick(
        *(jnp.asarray(t[k]) for k in ("step_state", "retries_left", "has_undo", "saga_state",
                                      "n_steps", "cursor")),
        *(jnp.asarray(x) for x in t["masks"]), metrics=jm, wave_kernels=False)
    cols = {k: torch.from_numpy(np.array(t[k], copy=True)) for k in (
        "step_state", "retries_left", "has_undo", "saga_state", "n_steps", "cursor")}
    counters = torch.from_numpy(seeded.view(np.int32).copy())
    committed, exhausted = saga_kernels.saga_tick_block_plain(
        *cols.values(), torch.from_numpy(saga_ops.pack_outcomes(*t["masks"])), counters)
    want = np.asarray(out[4].counters)
    assert counters.numpy().view(np.uint32).tobytes() == want.tobytes()
    assert want[list(rows)].tolist() == [(COUNTER_SEED + int(committed.sum())) % 2**32,
                                         (COUNTER_SEED + int(exhausted.sum())) % 2**32]
    assert (want[list(rows)] < COUNTER_SEED).all()  # both rows wrapped


def test_tick_from_wrapping_counters_leaves_the_reference_metrics_table():
    """`ops.saga_ops.saga_table_tick` on CPU tensors, the tally rows seeded
    near 2^32: the whole metrics table byte-identical to the reference's."""
    t = _random_table(np.random.RandomState(9), 1000, 16)
    seeded = _seeded_counters(saga_kernels.TALLY_ROWS)
    jm = jax_metrics.MetricsTable.create(*jax_schema.REGISTRY.counts(),
                                         jax_schema.DEFAULT_BUCKET_BOUNDS_US)
    jm = jax_replace(jm, counters=jnp.asarray(seeded))
    out = jax_saga_ops.saga_table_tick(
        *(jnp.asarray(t[k]) for k in ("step_state", "retries_left", "has_undo", "saga_state",
                                      "n_steps", "cursor")),
        *(jnp.asarray(x) for x in t["masks"]), metrics=jm, wave_kernels=False)
    pm = PortMetrics.create(device="cpu")
    pm.counters.copy_(torch.from_numpy(seeded.view(np.int32)))
    cols = {k: torch.from_numpy(np.array(t[k], copy=True)) for k in (
        "step_state", "retries_left", "has_undo", "saga_state", "n_steps", "cursor")}
    got = saga_ops.saga_table_tick(*cols.values(),
                                   torch.from_numpy(saga_ops.pack_outcomes(*t["masks"])),
                                   metrics=pm)
    assert got[4] is pm
    port = _table_bytes(pm)
    port["counters"] = pm.counters.numpy().view(np.uint32).tobytes()
    port["hist"] = pm.hist.numpy().view(np.uint32).tobytes()
    assert port == _table_bytes(out[4])


def test_tick_at_default_size_matches_reference():
    cap = port_config.DEFAULT_CONFIG.capacity
    assert (cap.max_sagas, cap.max_steps_per_saga) == (8_192, 16)
    _tick_against_reference(_random_table(np.random.RandomState(3), cap.max_sagas,
                                          cap.max_steps_per_saga))


@pytest.mark.parametrize("machine", ["step", "saga"])
def test_transition_bits_give_the_reference_matrices(machine):
    if machine == "step":
        matrix, port_fn, jax_fn = (jax_sm.STEP_TRANSITION_MATRIX, saga_ops.step_transition_valid,
                                   jax_saga_ops.step_transition_valid)
        assert np.array_equal(port_sm.STEP_TRANSITION_MATRIX, matrix)
    else:
        matrix, port_fn, jax_fn = (jax_sm.SAGA_TRANSITION_MATRIX, saga_ops.saga_transition_valid,
                                   jax_saga_ops.saga_transition_valid)
        assert np.array_equal(port_sm.SAGA_TRANSITION_MATRIX, matrix)
    codes = np.arange(-1, matrix.shape[0] + 1, dtype=np.int8)
    frm, to = np.meshgrid(codes, codes, indexing="ij")
    got = port_fn(torch.from_numpy(frm), torch.from_numpy(to)).numpy()
    want = np.asarray(jax_fn(jnp.asarray(frm), jnp.asarray(to)))
    assert np.array_equal(got, want)
    assert np.array_equal(got[1:-1, 1:-1], matrix.astype(bool))
    for to_code in range(matrix.shape[0]):  # an int target, as the facade passes
        assert np.array_equal(port_fn(torch.from_numpy(codes), to_code).numpy(), want[:, to_code + 1])


def test_state_codes_match_reference():
    for name in ("StepState", "SagaState"):
        port_enum, jax_enum = getattr(port_sm, name), getattr(jax_sm, name)
        assert [(s.value, s.code) for s in port_enum] == [(s.value, s.code) for s in jax_enum]
    for name in dir(jax_saga_ops):
        if name.startswith(("STEP_", "SAGA_")) and isinstance(getattr(jax_saga_ops, name), int):
            assert getattr(saga_ops, name) == getattr(jax_saga_ops, name), name
    assert [(p.value, p.code) for p in port_fan_out.FanOutPolicy] == [
        (p.value, p.code) for p in jax_fan_out.FanOutPolicy]
    for pol in port_fan_out.FanOutPolicy:
        jpol = jax_fan_out.FanOutPolicy(pol.value)
        for wins, total in ((0, 3), (1, 3), (2, 3), (3, 3), (1, 2)):
            assert port_fan_out.evaluate_policy(pol, wins, total) == jax_fan_out.evaluate_policy(
                jpol, wins, total)


def test_step_ops_match_reference():
    rng = np.random.RandomState(11)
    state = rng.randint(-1, 8, (64, 6)).astype(np.int8)
    target = rng.randint(0, 7, (64, 6)).astype(np.int8)
    select, undo, ok = (rng.uniform(size=(64, 6)) < 0.5 for _ in range(3))
    saga = rng.randint(0, 5, 64).astype(np.int8)
    pairs = [
        (saga_ops.apply_step_transitions(torch.from_numpy(state), torch.from_numpy(target),
                                         torch.from_numpy(select)),
         jax_saga_ops.apply_step_transitions(jnp.asarray(state), jnp.asarray(target),
                                             jnp.asarray(select))),
        ((saga_ops.compensation_pass(torch.from_numpy(state), torch.from_numpy(undo),
                                     torch.from_numpy(ok)),),
         (jax_saga_ops.compensation_pass(jnp.asarray(state), jnp.asarray(undo), jnp.asarray(ok)),)),
        ((saga_ops.settle_sagas(torch.from_numpy(state), torch.from_numpy(saga)),),
         (jax_saga_ops.settle_sagas(jnp.asarray(state), jnp.asarray(saga)),)),
    ]
    for got, want in pairs:
        for g, w in zip(got, want):
            assert g.numpy().tobytes() == np.asarray(w).tobytes()


def test_fanout_round_matches_reference():
    rng = np.random.RandomState(5)
    g, m = 96, 8
    step = rng.randint(0, 7, (g, m)).astype(np.int8)
    saga = rng.randint(0, 5, g).astype(np.int8)
    cursor = rng.randint(0, m, g).astype(np.int32)
    start = rng.randint(0, m - 2, g)
    width = rng.randint(2, 4, g)
    cols = np.arange(m)[None, :]
    group = (cols >= start[:, None]) & (cols < (start + width)[:, None])
    active = rng.uniform(size=g) < 0.7
    success = rng.uniform(size=(g, m)) < 0.5
    policy = rng.randint(0, 3, g).astype(np.int8)
    got = saga_ops.fanout_round(*(torch.from_numpy(x) for x in (
        step, saga, cursor, group, active, success, policy)))
    want = jax_saga_ops.fanout_round(*(jnp.asarray(x) for x in (
        step, saga, cursor, group, active, success, policy)))
    for gt, w in zip(got, want):
        assert gt.numpy().dtype == np.asarray(w).dtype
        assert gt.numpy().tobytes() == np.asarray(w).tobytes()
    valid = group & active[:, None]
    assert np.array_equal(
        saga_ops.fanout_policy_check(torch.from_numpy(success), torch.from_numpy(valid),
                                     torch.from_numpy(policy)).numpy(),
        np.asarray(jax_saga_ops.fanout_policy_check(jnp.asarray(success), jnp.asarray(valid),
                                                    jnp.asarray(policy))))


_BAD_DEFINITIONS = [
    {},
    {"name": "n", "session_id": "s", "steps": []},
    {"name": "n", "session_id": "s", "steps": [{"id": "a", "action_id": "x"}]},
    {"name": "n", "session_id": "s", "steps": [
        {"id": "a", "action_id": "x", "agent": "d"}, {"id": "a", "action_id": "y", "agent": "d"}]},
    {"name": "n", "session_id": "s", "steps": [{"id": "a", "action_id": "x", "agent": "d"}],
     "fan_out": [{"policy": "most", "branches": ["a", "b"]}, {"branches": ["a"]},
                 {"branches": ["a", "zz"]}]},
]


def test_dsl_parser_matches_reference():
    spec = {
        "name": "n", "session_id": "s", "saga_id": "saga:dsl", "metadata": {"k": 1},
        "steps": [{"id": f"s{i}", "action_id": f"a{i}", "agent": "d", "undo_api": "/u",
                   "retries": i, "timeout": 5 + i} for i in range(4)],
        "fan_out": [{"policy": "majority_must_succeed", "branches": ["s1", "s2"]}],
    }
    got, want = port_dsl.SagaDSLParser().parse(spec), jax_dsl.SagaDSLParser().parse(spec)
    assert [vars(s) for s in got.steps] == [vars(s) for s in want.steps]
    assert [(f.policy.value, f.branch_step_ids) for f in got.fan_outs] == [
        (f.policy.value, f.branch_step_ids) for f in want.fan_outs]
    assert (got.name, got.session_id, got.saga_id, got.metadata) == (
        want.name, want.session_id, want.saga_id, want.metadata)
    assert [s.id for s in got.sequential_steps] == ["s0", "s3"]
    assert [vars(s)["step_id"] for s in port_dsl.SagaDSLParser.to_saga_steps(got)] == got.step_ids
    for bad in _BAD_DEFINITIONS:
        assert port_dsl.SagaDSLParser.validate(bad) == jax_dsl.SagaDSLParser.validate(bad)
        with pytest.raises(port_dsl.SagaDSLError):
            port_dsl.SagaDSLParser().parse(bad)


def test_host_state_machines_refuse_like_the_reference():
    step = port_sm.SagaStep("s", "a", "d", "/x")
    step.transition(port_sm.StepState.EXECUTING)
    step.transition(port_sm.StepState.COMMITTED)
    with pytest.raises(port_sm.SagaStateError, match="committed → pending"):
        step.transition(port_sm.StepState.PENDING)
    saga = port_sm.Saga("g", "s", steps=[step])
    saga.transition(port_sm.SagaState.COMPENSATING)
    back = port_sm.Saga.from_dict(saga.to_dict())
    assert back.state is port_sm.SagaState.COMPENSATING
    assert [s.state for s in back.committed_steps_reversed] == [port_sm.StepState.COMMITTED]


# ── one seeded sequence on both facades ──────────────────────────────

CAP = dict(max_agents=16, max_sessions=8, max_vouch_edges=16, max_sagas=16,
           max_steps_per_saga=8, delta_log_capacity=32, trace_log_capacity=256)
QUARANTINED_ROW = 3


class _Ref:
    models, dsl, scheduler = jax_models, jax_dsl, JaxScheduler

    def __init__(self):
        self.st = JaxState(jax_config.HypervisorConfig(capacity=jax_config.TableCapacity(
            **CAP, max_elevations=8, event_log_capacity=16)))

    def set_flags(self, row, flags):
        a = self.st.agents
        self.st.agents = jax_replace(a, flags=a.flags.at[row].set(flags))

    def snapshot(self):
        out = {k: v for k, v in state_arrays(self.st).items() if k.startswith("sagas.")}
        out["metrics.counters"] = np.array(self.st.metrics.table.counters)
        out["trace.words"] = np.array(self.st.tracer.table.words)
        out["trace.cursor"] = np.array(self.st.tracer.table.cursor)
        return out


class _Port(_Ref):
    models, dsl, scheduler = port_models, port_dsl, PortScheduler

    def __init__(self):
        self.st = port_state(CAP)

    def set_flags(self, row, flags):
        self.st.agents.i32[row, AI32_FLAGS] = flags

    def snapshot(self):
        st = self.st
        out = port_tables.to_state_arrays(port_tables.StateTables(
            st.agents, st.sessions, st.vouches, sagas=st.sagas))
        out = {k: v for k, v in out.items() if k.startswith("sagas.")}
        out["metrics.counters"] = st.metrics.table.counters.numpy().view(np.uint32).copy()
        out["trace.words"] = st.tracer.table.words.numpy().view(np.uint32).copy()
        out["trace.cursor"] = st.tracer.table.cursor.numpy().copy()
        return out


def port_state(cap: dict):
    from hypervisor_tpu_torch.state import HypervisorState

    return HypervisorState(port_config.HypervisorConfig(
        capacity=port_config.TableCapacity(**cap)), device="cpu")


def _fan_definition(side, policy: str, n_branches: int, tail: bool, saga_id: str):
    steps = [{"id": f"b{i}", "action_id": f"m.b{i}", "agent": "did:f",
              "execute_api": f"/b{i}", "undo_api": f"/ub{i}"} for i in range(n_branches)]
    if tail:
        steps.append({"id": "finish", "action_id": "m.finish", "agent": "did:f",
                      "execute_api": "/fin"})
    return side.dsl.SagaDSLParser().parse({
        "name": "fan", "session_id": "session:fan", "saga_id": saga_id, "steps": steps,
        "fan_out": [{"policy": policy, "branches": [f"b{i}" for i in range(n_branches)]}],
    })


def _run(side) -> dict:
    st = side.st
    log: dict = {"ran": []}
    ran = log["ran"]
    sess = st.create_session("s:saga", side.models.SessionConfig())
    refusals = []
    for steps in ([], [{}] * (CAP["max_steps_per_saga"] + 1)):
        with pytest.raises(ValueError) as err:
            st.create_saga("saga:bad", sess, steps)
        refusals.append(str(err.value))
    sched = side.scheduler(st, retry_backoff_seconds=0.0)

    def ok(tag, value="ok"):
        async def run():
            ran.append(tag)
            return value
        return run

    def fails(tag, message="permanent"):
        async def run():
            ran.append(tag)
            raise RuntimeError(message)
        return run

    # The 5-step retry / compensate / escalate saga.
    g0 = st.create_saga("saga:bench", sess, [
        {"retries": 1, "has_undo": True}, {"has_undo": True}, {"has_undo": False},
        {"has_undo": True}, {"retries": 2}])
    flaky = {"n": 0}

    async def flaky_first():
        flaky["n"] += 1
        ran.append(f"g0.0#{flaky['n']}")
        if flaky["n"] == 1:
            raise RuntimeError("transient")
        return "ok"

    sched.register(g0, 0, flaky_first, undo=ok("undo g0.0"))
    sched.register(g0, 1, ok("g0.1"), undo=ok("undo g0.1"))
    sched.register(g0, 2, ok("g0.2"))  # no undo API
    sched.register(g0, 3, ok("g0.3"), undo=ok("undo g0.3"))
    sched.register(g0, 4, fails("g0.4"))
    # All steps commit.
    g1 = st.create_saga("saga:ok", sess, [{}, {}, {}])
    for i in range(3):
        sched.register(g1, i, ok(f"g1.{i}", i))
    # A step timeout counts as a failure.
    g2 = st.create_saga("saga:timeout", sess, [{"has_undo": True}, {"timeout": 0.01}])

    async def slow():
        ran.append("g2.1")
        await asyncio.sleep(1.0)
        return "late"

    sched.register(g2, 0, ok("g2.0"), undo=ok("undo g2.0"))
    sched.register(g2, 1, slow)
    # DSL sagas whose ALL and ANY policies fail.
    for policy, branch_ok, tail, sid in (("all_must_succeed", [True, False, True], True, "saga:all"),
                                         ("any_must_succeed", [False, False], False, "saga:any")):
        definition = _fan_definition(side, policy, len(branch_ok), tail, sid)
        g = st.create_saga_from_dsl(definition, sess)
        executors = {f"b{i}": (ok if good else fails)(f"{sid}.b{i}")
                     for i, good in enumerate(branch_ok)}
        if tail:
            executors["finish"] = ok(f"{sid}.finish")
        undos = {f"b{i}": ok(f"undo {sid}.b{i}") for i in range(len(branch_ok))}
        sched.register_definition(g, definition, executors, undos=undos)
    # A mid-saga quarantine: step 0 quarantines the acting agent's row,
    # so the gate refuses step 1 twice (one retry), and step 0 unwinds.
    side.set_flags(QUARANTINED_ROW, FLAG_ACTIVE)
    g5 = st.create_saga("saga:iso", sess, [{"has_undo": True}, {"retries": 1}, {}])

    async def quarantine():
        ran.append("g5.0")
        side.set_flags(QUARANTINED_ROW, FLAG_ACTIVE | FLAG_QUARANTINED)
        return "ok"

    sched.register(g5, 0, quarantine, undo=ok("undo g5.0"), agent_slot=QUARANTINED_ROW)
    sched.register(g5, 1, ok("g5.1"), agent_slot=QUARANTINED_ROW)
    sched.register(g5, 2, ok("g5.2"), agent_slot=QUARANTINED_ROW)
    # A kill-switch handoff: step 1's dead executor goes to a substitute
    # with a fresh retry budget; the unowned handoff is skipped.
    g6 = st.create_saga("saga:handoff", sess, [{"has_undo": True}, {"has_undo": True}, {}])
    sched.register(g6, 0, ok("g6.0"), undo=ok("undo g6.0"))
    sched.register(g6, 1, fails("g6.1 victim"), undo=ok("undo g6.1 victim"))
    sched.register(g6, 2, ok("g6.2"))
    kill = SimpleNamespace(handoffs=[
        SimpleNamespace(saga_id="saga:handoff", step_id="s1", to_agent="did:sub"),
        SimpleNamespace(saga_id="saga:handoff", step_id="s2", to_agent=None),
    ])
    sub_runs = {"n": 0}

    async def substitute():
        sub_runs["n"] += 1
        ran.append(f"g6.1 sub#{sub_runs['n']}")
        if sub_runs["n"] < 3:
            raise RuntimeError("warming up")
        return "sub"

    log["rewired"] = sched.apply_handoffs(
        kill, {("saga:handoff", "s1"): (g6, 1), ("saga:handoff", "s2"): (g6, 2)},
        {"did:sub": substitute}, retries=2)

    rounds = {"n": 0}
    saga_round = st.saga_round

    def counted_round(*args, **kwargs):
        rounds["n"] += 1
        return saga_round(*args, **kwargs)

    st.saga_round = counted_round
    with pytest.raises(RuntimeError, match="not settled"):
        asyncio.run(sched.run_until_settled(max_rounds=2))
    log["mid"] = side.snapshot()
    log["work"] = st.saga_work()
    log["work_budget"] = st.saga_work(comp_budget=1)
    log["settled_mid"] = st.sagas_settled()
    asyncio.run(sched.run_until_settled())
    log["rounds"] = rounds["n"]
    log["end"] = side.snapshot()
    log["refusals"] = refusals
    log["results"] = dict(sched.results)
    log["errors"] = dict(sched.errors)
    log["attempts"] = dict(sched._attempts)
    log["gate"] = [st.isolation_refusal(r) for r in (QUARANTINED_ROW, 0)]
    log["slots"] = [g0, g1, g2, g5, g6]
    with pytest.raises(RuntimeError, match="saga table full"):
        for i in range(CAP["max_sagas"] + 1):
            st.create_saga(f"saga:fill{i}", sess, [{}])
    return log


@pytest.fixture(scope="module")
def runs():
    counter = itertools.count()

    def token_hex(nbytes=None):
        return f"{next(counter):0{2 * nbytes}x}"

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HV_WAVE_PALLAS", "0")
        mp.delenv("HV_TRACE", raising=False)
        mp.delenv("HV_TRACE_SAMPLE", raising=False)
        mp.setattr(secrets, "token_hex", token_hex)
        ref = _run(_Ref())
        counter = itertools.count()
        port = _run(_Port())
    return ref, port


def _assert_same(label, got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), label
        for key, w in want.items():
            _assert_same(f"{label} {key}", got[key], w)
    elif isinstance(want, np.ndarray):
        g = np.asarray(got)
        assert g.dtype == want.dtype and g.shape == want.shape, label
        assert g.tobytes() == want.tobytes(), f"{label} diverged"
    else:
        assert got == want, label


@pytest.mark.parametrize("step", ["mid", "end"])
def test_saga_sequence_tables_metrics_and_trace_match_reference(runs, step):
    ref, port = runs
    _assert_same(step, port[step], ref[step])


def test_saga_sequence_scheduler_matches_reference(runs):
    ref, port = runs
    for key in ("results", "errors", "attempts", "rounds", "ran", "rewired", "refusals", "gate",
                "slots", "settled_mid"):
        assert port[key] == ref[key], key
    assert port["attempts"][(port["slots"][0], 4)] == 3   # 1 + 2 retries
    assert port["errors"][(port["slots"][3], 1)] == "agent is quarantined (read-only isolation)"
    assert port["errors"][(port["slots"][2], 1)] == ""     # the step timed out
    assert port["rewired"] == 1 and port["results"][(port["slots"][4], 1)] == "sub"


def test_saga_sequence_outcomes(runs):
    _, port = runs
    end = port["end"]
    g0, g1, g2, g5, g6 = port["slots"]
    states, steps = end["sagas.saga_state"], end["sagas.step_state"]
    assert states[g0] == saga_ops.SAGA_ESCALATED
    assert steps[g0, :5].tolist() == [4, 4, 5, 4, 6]
    assert states[g1] == saga_ops.SAGA_COMPLETED and steps[g1, :3].tolist() == [2, 2, 2]
    assert states[g2] == saga_ops.SAGA_COMPLETED and steps[g2, :2].tolist() == [4, 6]
    assert states[g5] == saga_ops.SAGA_COMPLETED and steps[g5, :2].tolist() == [4, 6]
    assert states[g6] == saga_ops.SAGA_COMPLETED and steps[g6, :3].tolist() == [2, 2, 2]
    all_slot, any_slot = 3, 4
    assert steps[all_slot, :4].tolist() == [4, 6, 4, 0] and states[all_slot] == 2
    assert steps[any_slot, :2].tolist() == [6, 6] and states[any_slot] == 2


def test_saga_work_budget_is_a_deterministic_prefix(runs):
    ref, port = runs
    execute, compensate = port["work"]
    _, bounded = port["work_budget"]
    assert len(compensate) >= 2 and bounded == compensate[:1]
    assert port["work"] == ref["work"] and not port["settled_mid"]
