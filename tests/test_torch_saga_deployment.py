"""The saga deployment on the port, on the CPU: block creation of sagas,
the scheduler's reads bounded to the rows that can still hold a live
saga, the saga plane's spans and counters, and the port held to the JAX
package and to the benchmark's plain saga reference
(`hvbench/reference/saga.py`).

* `create_sagas` (and `create_sagas_from_dsl`) equal `create_saga` (and
  `create_saga_from_dsl`) called in order, on the port and on the JAX
  package: slots, every column of the table bit for bit, the interned
  ids and the fan-out groups; a block that does not fit raises before it
  writes anything;
* a journaled block writes the log K `create_saga` calls write on the
  JAX package, byte for byte, and replays to the same table;
* `run_until_settled` over three batches (older settled sagas under the
  live rows' lower bound, the bound put back to 0 before the third)
  gives the JAX package's tables, results, errors, attempts and rounds,
  and those of reads that start at row 0; each round reads no more rows
  than the batch holds;
* a call of the benchmark's saga cell (256 seeded sagas of its mix, a
  1,024-row table) equals the reference saga for saga, with the spans
  and the counters the reference counts.
"""

from __future__ import annotations

import asyncio
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from hvbench.drivers import saga as saga_driver
from hvbench.reference import saga as saga_ref
from hypervisor_tpu import config as jax_config
from hypervisor_tpu import models as jax_models
from hypervisor_tpu.resilience import wal as jax_wal
from hypervisor_tpu.runtime.checkpoint import state_arrays
from hypervisor_tpu.runtime.saga_scheduler import SagaScheduler as JaxScheduler
from hypervisor_tpu.saga import dsl as jax_dsl
from hypervisor_tpu.state import HypervisorState as JaxState
from hypervisor_tpu_torch import tables as port_tables
from hypervisor_tpu_torch.config import HypervisorConfig, TableCapacity
from hypervisor_tpu_torch.models import SessionConfig
from hypervisor_tpu_torch.observability import profiling
from hypervisor_tpu_torch.resilience import recovery, wal
from hypervisor_tpu_torch.runtime.saga_scheduler import SagaScheduler
from hypervisor_tpu_torch.saga import dsl as port_dsl
from hypervisor_tpu_torch.state import HypervisorState

REPO = Path(__file__).resolve().parents[1]
COLUMNS = ("step_state", "retries_left", "has_undo", "timeout", "saga_state", "session",
           "n_steps", "cursor")
STEPS = [{"retries": 1, "has_undo": True}, {"retries": 1, "has_undo": True},
         {"retries": 0, "has_undo": True}, {"retries": 1, "has_undo": True},
         {"retries": 2, "has_undo": True, "timeout": 0.5}]
NO_UNDO = [dict(s) for s in STEPS]
NO_UNDO[2]["has_undo"] = False


CAPACITY = dict(max_agents=512, max_sessions=512, max_vouch_edges=256, max_steps_per_saga=16,
                max_elevations=64, delta_log_capacity=256, event_log_capacity=256,
                trace_log_capacity=256)


def state(max_sagas: int = 1024, sessions: int = 64) -> tuple[HypervisorState, np.ndarray]:
    st = HypervisorState(HypervisorConfig(capacity=TableCapacity(
        **CAPACITY, max_sagas=max_sagas)), device="cpu")
    slots = st.create_sessions_batch([f"s{i}" for i in range(sessions)], SessionConfig())
    return st, slots


def jax_state(max_sagas: int = 1024, sessions: int = 64) -> tuple[JaxState, np.ndarray]:
    st = JaxState(jax_config.HypervisorConfig(capacity=jax_config.TableCapacity(
        **CAPACITY, max_sagas=max_sagas)))
    slots = st.create_sessions_batch([f"s{i}" for i in range(sessions)],
                                     jax_models.SessionConfig())
    return st, slots


def fanout_definition(saga_id: str, policy: str, dsl=port_dsl):
    return dsl.SagaDSLParser().parse({
        "name": "fan", "session_id": "s", "saga_id": saga_id,
        "steps": [{"id": f"b{b}", "action_id": f"m.b{b}", "agent": "did:f",
                   "undo_api": f"/u{b}"} for b in range(3)]
        + [{"id": "tail", "action_id": "m.tail", "agent": "did:f", "retries": 2,
            "timeout": 7}],
        "fan_out": [{"policy": policy, "branches": ["b0", "b1", "b2"]}],
    })


def table(st: HypervisorState) -> dict:
    return {c: getattr(st.sagas, c).clone() for c in COLUMNS}


def same_tables(a: dict, b: dict) -> None:
    for c in COLUMNS:
        assert torch.equal(a[c], b[c]), c


def saga_arrays(st) -> dict:
    """Every column of the saga table on the host, under the JAX package's
    `"sagas.<column>"` names, from either package's state."""
    if isinstance(st, JaxState):
        out = state_arrays(st)
    else:
        out = port_tables.to_state_arrays(port_tables.StateTables(
            st.agents, st.sessions, st.vouches, sagas=st.sagas))
    return {k: v for k, v in out.items() if k.startswith("sagas.")}


def same_arrays(port: dict, ref: dict, label) -> None:
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=f"{label} {k}")
        assert port[k].dtype == ref[k].dtype, (label, k)


def seeded_blocks(seed: int, n: int, sessions: np.ndarray):
    """(saga ids, session slots, step lists) of n sagas, three shapes of
    step list, one object each."""
    rng = np.random.RandomState(seed)
    short = [{"retries": 3, "has_undo": False, "timeout": 2.5}]
    shapes = (STEPS, NO_UNDO, short)
    which = rng.randint(0, 3, n)
    return ([f"g{seed}:{i}" for i in range(n)],
            [int(sessions[i % len(sessions)]) for i in range(n)],
            [shapes[w] for w in which])


class TestCreateSagas:
    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_a_block_equals_create_saga_in_order(self, seed):
        one, slots = state()
        block, _ = state()
        ref, ref_slots = jax_state()
        assert list(ref_slots) == list(slots)
        ids, sess, steps = seeded_blocks(seed, 40, slots)
        policies = ("all_must_succeed", "any_must_succeed", "majority_must_succeed")
        defs = [fanout_definition(f"d{seed}:{k}", p) for k, p in enumerate(policies)]
        ref_defs = [fanout_definition(f"d{seed}:{k}", p, jax_dsl) for k, p in enumerate(policies)]
        want = [one.create_saga(i, s, st) for i, s, st in zip(ids, sess, steps)]
        want += [one.create_saga_from_dsl(d, int(slots[k])) for k, d in enumerate(defs)]
        ref_want = [ref.create_saga(i, s, st) for i, s, st in zip(ids, sess, steps)]
        ref_want += [ref.create_saga_from_dsl(d, int(slots[k])) for k, d in enumerate(ref_defs)]
        got = list(block.create_sagas(ids, sess, steps))
        got += list(block.create_sagas_from_dsl(defs, [int(s) for s in slots[:3]]))
        assert got == want == ref_want == list(range(43))
        same_tables(table(one), table(block))
        same_arrays(saga_arrays(block), saga_arrays(ref), f"seed {seed}")
        assert one.saga_ids._to_string == block.saga_ids._to_string
        assert block.saga_ids._to_string == ref.saga_ids._to_string
        assert one._fanout_groups == block._fanout_groups == ref._fanout_groups
        assert one._next_saga_slot == block._next_saga_slot == ref._next_saga_slot == 43

    def test_a_full_table_raises_before_it_writes(self):
        st, slots = state(max_sagas=32)
        ids, sess, steps = seeded_blocks(5, 30, slots)
        st.create_sagas(ids, sess, steps)
        before, names = table(st), list(st.saga_ids._to_string)
        with pytest.raises(RuntimeError, match="saga table full"):
            st.create_sagas(["x0", "x1", "x2"], [0, 0, 0], [STEPS] * 3)
        with pytest.raises(ValueError, match="at least one step"):
            st.create_sagas(["y0", "y1"], [0, 0], [STEPS, []])
        with pytest.raises(ValueError, match="table holds 16"):
            st.create_sagas(["z0"], [0], [STEPS * 4])
        same_tables(before, table(st))
        assert st.saga_ids._to_string == names and st._next_saga_slot == 30
        # It fills the table to the last row, as create_saga does.
        assert list(st.create_sagas(["w0", "w1"], [1, 2], [STEPS, NO_UNDO])) == [30, 31]
        with pytest.raises(RuntimeError, match="saga table full"):
            st.create_saga("w2", 3, STEPS)

    def test_the_journal_replays_a_block_to_the_same_table(self, tmp_path):
        st, slots = state()
        ref, _ = jax_state()
        st.journal = wal.WriteAheadLog(tmp_path / "wal.log", fsync=False)
        ref.journal = jax_wal.WriteAheadLog(tmp_path / "ref.log", fsync=False)
        ids, sess, steps = seeded_blocks(9, 25, slots)
        st.create_sagas(ids, sess, steps)
        st.create_saga("single", int(slots[1]), STEPS)
        st.create_sagas_from_dsl([fanout_definition("fan", "any_must_succeed")], [int(slots[2])])
        for i, s, sts in zip(ids, sess, steps):
            ref.create_saga(i, s, sts)
        ref.create_saga("single", int(slots[1]), STEPS)
        ref.create_saga_from_dsl(fanout_definition("fan", "any_must_succeed", jax_dsl),
                                 int(slots[2]))
        st.journal.flush()
        ref.journal.flush()
        # One `create_saga` record a saga, as the JAX package writes them.
        assert (tmp_path / "wal.log").read_bytes() == (tmp_path / "ref.log").read_bytes()
        records = wal.scan(tmp_path / "wal.log").committed
        assert [r.op for r in records] == ["create_saga"] * 27 + ["register_fanout_groups"]
        fresh, _ = state()
        recovery.replay(fresh, records)
        same_tables(table(st), table(fresh))
        assert fresh.saga_ids._to_string == st.saga_ids._to_string
        assert fresh._fanout_groups == st._fanout_groups


def wire(st: HypervisorState, sched: SagaScheduler, slots, kinds, seed: int) -> None:
    """Seeded executors: kind 0 commits, 1 fails one attempt, 2 always
    fails its last step (compensation), 3 times out once."""
    rng = np.random.RandomState(seed)
    attempts: dict = {}

    def executor(key, fail_first, always, sleep):
        async def run():
            n = attempts[key] = attempts.get(key, 0) + 1
            if always or (fail_first and n == 1):
                raise RuntimeError(f"{key} {n}")
            if sleep and n == 1:
                await asyncio.sleep(0.05)
            return n
        return run

    async def undo():
        return "undone"

    for slot, kind in zip(slots, kinds):
        f = int(rng.randint(0, 5))
        n = int(st.sagas.n_steps[slot])
        for j in range(n):
            has_undo = bool(st.sagas.has_undo[slot, j])
            sched.register(int(slot), j, executor((int(slot), j), kind == 1 and j == f,
                                                  kind == 2 and j == n - 1, kind == 3 and j == 0),
                           undo=undo if has_undo else None)


def batch(st, b: int, slots, seed: int):
    """48 sequential sagas and six fan-out sagas, in one block each on the
    port and a `create_saga` a saga on the JAX package."""
    rng = np.random.RandomState(seed)
    timed = [dict(s) for s in STEPS]
    timed[0]["timeout"] = 0.01
    kinds = rng.randint(0, 4, 48)
    steps = [timed if k == 3 else (NO_UNDO if rng.uniform() < 0.3 else STEPS) for k in kinds]
    ids, sess = [f"b{b}:{i}" for i in range(48)], [int(s) for s in slots[:48]]
    policies = ("all_must_succeed", "any_must_succeed", "majority_must_succeed") * 2
    fan_ids, fan_sess = [f"b{b}:fan{k}" for k in range(6)], [int(s) for s in slots[:6]]
    if isinstance(st, JaxState):
        new = [st.create_saga(i, s, sts) for i, s, sts in zip(ids, sess, steps)]
        groups = [st.create_saga_from_dsl(fanout_definition(i, p, jax_dsl), s)
                  for i, p, s in zip(fan_ids, policies, fan_sess)]
        return new, kinds, groups
    new = st.create_sagas(ids, sess, steps)
    groups = st.create_sagas_from_dsl(
        [fanout_definition(i, p) for i, p in zip(fan_ids, policies)], fan_sess)
    return new, kinds, groups


def run_batches(side: str) -> list:
    """Three batches run to their end on one state, the live rows' bound
    put back to 0 before the third. `side` is "bounded" (the port),
    "whole" (the port with every read from row 0) or "jax" (the JAX
    package's state and scheduler). Returns each batch's outcome and the
    rows read."""
    st, slots = jax_state() if side == "jax" else state()
    if side == "whole":
        def from_row_0():
            profiling.count("saga.readback_rows", st._next_saga_slot)
            return 0, st._next_saga_slot
        st._saga_live_rows = from_row_0
    booked = {"rounds": 0}
    saga_round = st.saga_round

    def count_rounds(*args, **kwargs):
        booked["rounds"] += 1
        return saga_round(*args, **kwargs)
    st.saga_round = count_rounds
    scheduler = JaxScheduler if side == "jax" else SagaScheduler
    out = []
    for b in range(3):
        if b == 2 and side != "jax":
            st._saga_lo = 0
        new, kinds, groups = batch(st, b, slots, 40 + b)
        sched = scheduler(st, retry_backoff_seconds=0.0)
        wire(st, sched, new, kinds, 50 + b)
        rng = np.random.RandomState(60 + b)
        for slot in groups:
            for j in range(4):
                fail = j < 3 and rng.uniform() < 0.4
                sched.register(int(slot), j, _const(not fail), undo=_const(True) if j < 3
                               else None)
        c0 = profiling.span_totals()["counters"].get("saga.readback_rows", 0)
        booked["rounds"] = 0
        rounds = asyncio.run(sched.run_until_settled())
        assert rounds in (None, booked["rounds"])
        rows = profiling.span_totals()["counters"].get("saga.readback_rows", 0) - c0
        out.append({"table": saga_arrays(st), "results": dict(sched.results),
                    "errors": dict(sched.errors), "attempts": dict(sched._attempts),
                    "rounds": booked["rounds"], "rows": rows, "next": st._next_saga_slot,
                    "lo": getattr(st, "_saga_lo", None)})
    return out


def _const(ok: bool):
    async def run():
        if not ok:
            raise RuntimeError("branch failed")
        return "ok"
    return run


class TestLiveRowReads:
    def test_bounded_reads_equal_whole_column_reads(self):
        bounded, whole, ref = run_batches("bounded"), run_batches("whole"), run_batches("jax")
        for b, (x, y, r) in enumerate(zip(bounded, whole, ref)):
            same_arrays(x["table"], r["table"], f"batch {b}")
            same_arrays(y["table"], r["table"], f"batch {b}")
            for k in ("results", "errors", "attempts", "rounds"):
                assert x[k] == y[k] == r[k], (b, k)
            assert x["rounds"] > 3
        # Every saga settled, so the bound ends at the table's end.
        assert [x["lo"] for x in bounded] == [x["next"] for x in bounded] == [54, 108, 162]

    def test_a_round_reads_no_more_rows_than_its_batch(self):
        bounded = run_batches("bounded")
        # Five reads a round at most (settled, work, dispatch, settle,
        # timeouts) and the closing settled check, 54 sagas a batch.
        for b, x in enumerate(bounded[:2]):
            assert x["rows"] <= (5 * x["rounds"] + 1) * 54, b
        # Put back to 0, the third batch's reads start at row 0 until the
        # first check moves the bound past the two settled batches.
        whole = run_batches("whole")
        assert bounded[1]["rows"] < whole[1]["rows"]


def cell(sagas: int = 256):
    config = json.loads((REPO / "hvbench/configs/saga10k.json").read_text())
    traffic = json.loads((REPO / "hvbench/traffic/txn5.json").read_text())
    config.update(actors=sagas)
    config["capacity"].update(max_agents=sagas + 64, max_sessions=sagas + 64, max_sagas=1024,
                              max_vouch_edges=256, max_elevations=64, delta_log_capacity=256,
                              event_log_capacity=256, trace_log_capacity=256)
    traffic.update(sagas=sagas, warmup_calls=0)
    return config, traffic


class TestAgainstTheReference:
    @pytest.mark.parametrize("seed", [2**31 + 5, 7, 2**33 + 1])
    def test_a_call_equals_the_reference(self, seed):
        config, traffic = cell()
        drv = saga_driver.Driver(config, traffic, seed, "cpu")
        drv.setup()
        for c in range(2):
            drv.call()
            got = drv.keep()
            want = saga_ref.run_call(drv.gen.plan(c))
            for f in saga_driver.ROW_FIELDS + ("attempts", "undos"):
                np.testing.assert_array_equal(got[f], want[f], err_msg=f"call {c} {f}")
            assert got["rounds"] == want["rounds"] == 11
            assert {k: got["counters"][k] for k in saga_ref.COUNTERS} == want["counters"]
        kinds = set(np.unique(want["saga_state"]).tolist())
        assert kinds == {saga_ref.SAGA_COMPLETED, saga_ref.SAGA_ESCALATED}
        drv.collect({})

    def test_the_spans_and_counters_of_a_call(self):
        config, traffic = cell()
        drv = saga_driver.Driver(config, traffic, 2**31 + 99, "cpu")
        drv.setup()
        profiling.reset_spans()
        drv.call()
        totals = profiling.span_totals()
        want = saga_ref.run_call(drv.gen.plan(0))
        rounds = want["rounds"]
        spans = {p: v[0] for p, v in totals["spans"].items()}
        assert spans["saga_create"] == 2  # the sequential block and the fan-out block
        assert spans["saga_scheduler"] == 1
        assert spans["saga_scheduler/round"] == rounds
        assert spans["saga_scheduler/round/executors"] == rounds
        assert spans["saga_scheduler/round/saga_work"] == rounds
        assert spans["saga_scheduler/round/fanout_dispatch"] == rounds
        assert spans["saga_scheduler/round/fanout_settle"] >= 1
        assert spans["saga_scheduler/round/saga_round"] == rounds
        counters = totals["counters"]
        assert {k: counters.get(k, 0) for k in saga_ref.COUNTERS} == want["counters"]
        assert want["counters"]["saga.timeouts"] > 0 and want["counters"]["saga.retries"] > 0
        assert want["counters"]["saga.gate_refusals"] == 0
        assert 0 < counters["saga.readback_rows"] <= (5 * rounds + 1) * 256
        drv.collect({})


@pytest.mark.parametrize("g", [1, 7, 4096])
def test_packed_outcome_bytes_equal_the_bitwise_sum(g):
    from hypervisor_tpu_torch.ops import saga_ops

    rng = np.random.RandomState(g)
    masks = [rng.uniform(size=g) < 0.5 for _ in range(4)]
    want = (masks[0] * saga_ops.OUT_EXEC_SUCCESS + masks[1] * saga_ops.OUT_UNDO_SUCCESS
            + masks[2] * saga_ops.OUT_EXEC_ATTEMPTED + masks[3] * saga_ops.OUT_UNDO_ATTEMPTED)
    got = saga_ops.pack_outcomes(*masks)
    assert got.dtype == np.uint8 and got.tolist() == want.tolist()
    both = saga_ops.pack_outcomes(masks[0], masks[1])
    assert both.tolist() == (want - masks[2] * 4 - masks[3] * 8 + 12).tolist()
