"""The port's resilience plane against the reference's, on the CPU.

Counterparts of `tests/unit/test_resilience.py` (the WAL's mechanics, the
journal-site registry, the kill-at-arbitrary-WAL-offset property, the
recovery refusals, the seeded fault schedule, the chaos executor's hang
hygiene) on `hypervisor_tpu_torch.resilience` with the port's
`HypervisorState(device="cpu")`, where every kernel the replay reaches
runs its plain version through its wrapper. Then across the packages,
with the reference unarmed (`HV_WAVE_PALLAS=0`):

* one seeded sequence of every journaled op (all 31) writes the same
  `wal.log` bytes on both packages, and leaves equal tables;
* a checkpoint and log written by the reference recover on the port,
  at every commit boundary and at torn cuts, bit-identical to the
  reference's own state at the same committed prefix;
* a chaos run whose faulted dispatches are retried by hand ends equal
  to the clean run, with the same fault schedule, on both packages (the
  supervisor's ladder is held in `test_torch_supervisor.py`);
* the shed gate, the damper's targeted shed, the fan-out pause, the
  no-supervisor `resilience_summary` and `recover_tenant` behave as the
  reference's do, and the package resolves the `Supervisor`.

Tolerance 0 everywhere: every checkpointed column byte for byte, the
chain seeds, the membership keys and the turn counters.
"""

from __future__ import annotations

import ast
import asyncio
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from hypervisor_tpu import config as jax_config
from hypervisor_tpu import models as jax_models
from hypervisor_tpu.observability import metrics as jax_metrics
from hypervisor_tpu.resilience import policy as jax_policy
from hypervisor_tpu.resilience import recovery as jax_recovery
from hypervisor_tpu.resilience import wal as jax_wal
from hypervisor_tpu.runtime import checkpoint as jax_ckpt
from hypervisor_tpu.saga import dsl as jax_dsl
from hypervisor_tpu.state import HypervisorState as JaxState
from hypervisor_tpu.testing import chaos as jax_chaos
from hypervisor_tpu_torch import config as port_config
from hypervisor_tpu_torch import models as port_models
from hypervisor_tpu_torch import state as port_state_mod
from hypervisor_tpu_torch.observability import metrics as port_metrics
from hypervisor_tpu_torch.resilience import policy as port_policy
from hypervisor_tpu_torch.resilience import recovery as port_recovery
from hypervisor_tpu_torch.resilience import wal as port_wal
from hypervisor_tpu_torch.runtime import checkpoint as port_ckpt
from hypervisor_tpu_torch.saga import dsl as port_dsl
from hypervisor_tpu_torch.state import HypervisorState as PortState
from hypervisor_tpu_torch.testing import chaos as port_chaos

#: The reference test's tables (`tests/unit/test_resilience.py`).
CAP = dict(max_agents=64, max_sessions=32, max_vouch_edges=64, max_sagas=16,
           max_steps_per_saga=8, max_elevations=16, delta_log_capacity=128,
           event_log_capacity=128, trace_log_capacity=128)


@pytest.fixture(autouse=True)
def unarmed(monkeypatch):
    """The reference's unarmed path (the XLA ops, no Pallas), as every
    parity test of the port runs it."""
    monkeypatch.setenv("HV_WAVE_PALLAS", "0")
    monkeypatch.delenv("HV_TRACE", raising=False)
    monkeypatch.delenv("HV_TRACE_SAMPLE", raising=False)


@dataclasses.dataclass(frozen=True)
class Pkg:
    """One package's resilience plane and the modules a sequence needs."""

    ref: bool

    def __getattr__(self, name):
        mods = {
            "config": (jax_config, port_config), "models": (jax_models, port_models),
            "wal": (jax_wal, port_wal), "recovery": (jax_recovery, port_recovery),
            "ckpt": (jax_ckpt, port_ckpt), "chaos": (jax_chaos, port_chaos),
            "dsl": (jax_dsl, port_dsl), "policy": (jax_policy, port_policy),
            "metrics": (jax_metrics, port_metrics),
        }
        if name not in mods:
            raise AttributeError(name)
        return mods[name][0 if self.ref else 1]

    def cfg(self, **cap):
        return self.config.HypervisorConfig(capacity=self.config.TableCapacity(**{**CAP, **cap}))

    def state(self, **cap):
        if self.ref:
            return JaxState(self.cfg(**cap))
        return PortState(self.cfg(**cap), device="cpu")

    def recover(self, ckpt_dir, wal_path, **kw):
        if self.ref:
            return self.recovery.recover(ckpt_dir, wal_path, config=self.cfg(), **kw)
        return self.recovery.recover(ckpt_dir, wal_path, config=self.cfg(), device="cpu", **kw)

    def host_counter(self, st, handle: str) -> int:
        idx = getattr(self.metrics, handle).index
        return int(st.metrics._h_counters[idx])


REF, PORT = Pkg(True), Pkg(False)


def fingerprint(st) -> dict:
    """Everything the crash property compares bit for bit (either package)."""
    arrays = (jax_ckpt if isinstance(st, JaxState) else port_ckpt).state_arrays(st)
    return {
        "arrays": arrays,
        "chain": {s: tuple(int(w) for w in v) for s, v in st._chain_seed.items()},
        "members": set(st._members),
        "turns": dict(st._turns),
    }


def assert_same(a: dict, b: dict, ctx: str = "") -> None:
    assert a["chain"] == b["chain"], f"chain head diverged {ctx}"
    assert a["members"] == b["members"], f"membership diverged {ctx}"
    assert a["turns"] == b["turns"], f"turn counters diverged {ctx}"
    assert sorted(a["arrays"]) == sorted(b["arrays"]), ctx
    for key, col in a["arrays"].items():
        other = b["arrays"][key]
        assert col.dtype == other.dtype and col.shape == other.shape, f"{key} {ctx}"
        assert col.tobytes() == other.tobytes(), f"column {key} diverged {ctx}"


def crash_offsets(raw: bytes, torn: bool = True) -> list[int]:
    """Every record boundary, and (`torn`) a cut 3 bytes short of each:
    the reader must refuse the torn line."""
    boundaries = [0]
    for line in raw.splitlines(keepends=True):
        boundaries.append(boundaries[-1] + len(line))
    extra = {b - 3 for b in boundaries[1:]} if torn else set()
    return sorted(set(boundaries) | extra)


# ── WAL mechanics (the copied module) ────────────────────────────────


class TestWal:
    def test_commit_abort_and_torn_tail(self, tmp_path):
        wal = port_wal.WriteAheadLog(tmp_path / "w.log", fsync=False)
        with wal.txn("op_a", {"x": 1}):
            pass
        with pytest.raises(RuntimeError):
            with wal.txn("op_b", {"x": 2}):
                raise RuntimeError("dispatch blew up")
        with wal.txn("op_c", {"x": 3}) as txn:
            txn.cancel()
        with wal.txn("op_d", {"x": 4}):
            pass
        wal.flush()
        s = port_wal.scan(wal.path)
        assert [r.op for r in s.committed] == ["op_a", "op_d"]
        assert s.aborted == 2
        raw = wal.path.read_bytes()
        wal.close()
        (tmp_path / "w.log").write_bytes(raw + b"deadbeef {garb")
        s2 = port_wal.scan(tmp_path / "w.log")
        assert [r.op for r in s2.committed] == ["op_a", "op_d"]
        assert s2.torn_bytes > 0
        resumed = port_wal.WriteAheadLog(tmp_path / "w.log", fsync=False)
        assert resumed.last_seq == s2.last_seq
        with resumed.txn("op_e", {}):
            pass
        resumed.flush()
        assert [r.op for r in port_wal.scan(tmp_path / "w.log").committed] == [
            "op_a", "op_d", "op_e"]

    def test_nested_txn_suppressed(self, tmp_path):
        wal = port_wal.WriteAheadLog(tmp_path / "n.log", fsync=False)
        with wal.txn("outer", {}):
            with wal.txn("inner", {}):
                pass
        wal.flush()
        assert [r.op for r in port_wal.scan(wal.path).committed] == ["outer"]

    def test_numpy_payloads_round_trip(self, tmp_path):
        wal = port_wal.WriteAheadLog(tmp_path / "np.log", fsync=False)
        with wal.txn("op", {"arr": np.arange(3, dtype=np.uint32), "f": np.float32(1.5),
                            "inf": float("inf")}):
            pass
        (rec,) = wal.committed()
        assert rec.args == {"arr": [0, 1, 2], "f": 1.5, "inf": float("inf")}
        # A tensor is no payload: every journal site hands numpy or scalars.
        with pytest.raises(TypeError, match="not WAL-serializable"):
            with wal.txn("op", {"t": torch.zeros(2)}):
                pass

    def test_depth_survives_append_failures(self, tmp_path, monkeypatch):
        wal = port_wal.WriteAheadLog(tmp_path / "io.log", fsync=False)

        def boom(op, args):
            raise OSError("disk full")

        monkeypatch.setattr(wal, "append_intent", boom)
        with pytest.raises(OSError):
            with wal.txn("doomed", {}):
                pass
        monkeypatch.undo()
        with wal.txn("after", {}):
            pass
        wal.flush()
        assert [r.op for r in port_wal.scan(wal.path).committed] == ["after"]


def port_journal_ops() -> set[str]:
    """The op names of every `self._journal("<op>", ...)` call in the
    port's `state.py`, from its syntax tree."""
    tree = ast.parse(Path(port_state_mod.__file__).read_text())
    ops = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "_journal"):
            assert node.args and isinstance(node.args[0], ast.Constant), ast.unparse(node)
            ops.add(node.args[0].value)
    return ops


def test_journal_sites_match_replay_registry_and_the_reference():
    from hypervisor_tpu.analysis import derived_wal_ops

    ops = port_journal_ops()
    assert len(ops) == 31
    assert ops == set(port_recovery.REPLAY), "journal sites and REPLAY handlers differ"
    assert ops == derived_wal_ops() == set(jax_recovery.REPLAY)


# ── the crash property on the port ───────────────────────────────────


def drive_workload(st, pkg: Pkg, ckpt_dir, snapshots: dict) -> int:
    """The reference test's scripted workload; snapshots[last_seq] holds
    the state after every committed top-level op. Returns the
    checkpoint's watermark seq."""

    def snap():
        snapshots[st.journal.last_seq] = fingerprint(st)

    free = pkg.models.SessionConfig(min_sigma_eff=0.0)
    slot = st.create_session("s:crash", free, now=1.0)
    snap()
    st.enqueue_join(slot, "did:a", 0.8)
    snap()
    st.enqueue_join(slot, "did:b", 0.7)
    snap()
    st.flush_joins(now=2.0)
    snap()
    a = st.agent_row("did:a")["slot"]
    b = st.agent_row("did:b")["slot"]
    st.add_vouch(a, b, slot, bond=0.15)
    snap()
    watermark = st.journal.last_seq
    pkg.recovery.checkpoint_with_watermark(st, ckpt_dir, step=1)

    g = st.create_saga("saga:crash", slot, [{"retries": 1}, {}])
    snap()
    st.saga_round({g: True})
    snap()
    st.stage_delta(slot, a, ts=3.0, change_words=np.arange(4, dtype=np.uint32))
    snap()
    st.flush_deltas()
    snap()
    st.check_actions_wave([a, b], [2, 2], [False, False], [False, False], [False, False],
                          [False, False], now=3.5)
    snap()
    slots2 = st.create_sessions_batch(["s:w0", "s:w1"], free)
    snap()
    st.run_governance_wave(slots2, ["did:c", "did:d"], slots2.copy(),
                           np.full(2, 0.8, np.float32), np.zeros((1, 2, 16), np.uint32), now=4.0)
    snap()
    st.saga_round({g: True})
    snap()
    st.terminate_sessions([slot], now=5.0)
    snap()
    return watermark


def journaled(pkg: Pkg, path: Path):
    st = pkg.state()
    st.journal = pkg.wal.WriteAheadLog(path, fsync=False)
    return st


def check_every_offset(writer: Pkg, reader: Pkg, tmp_path, snapshots, watermark, offsets=None):
    """Recover on `reader` from the checkpoint and every cut of the log
    `writer` wrote; each must equal the snapshot at its committed prefix."""
    raw = (tmp_path / "wal.log").read_bytes()
    every = writer.wal.scan(tmp_path / "wal.log").committed
    for off in crash_offsets(raw) if offsets is None else offsets(raw):
        torn = tmp_path / f"torn_{off}.log"
        torn.write_bytes(raw[:off])
        committed = writer.wal.scan(torn).committed
        expected_seq = max(max((r.seq for r in committed), default=0), watermark)
        back, report = reader.recover(tmp_path / "ckpt", torn)
        assert report["wal_records_replayed"] == len([r for r in committed if r.seq > watermark])
        # `create_saga_from_dsl` journals two records, and the snapshot
        # follows the second: the first's prefix differs from it only in
        # the host-only fan-out index, which no fingerprint column holds.
        snap_seq = min(s for s in snapshots if s >= expected_seq)
        assert {r.op for r in every if expected_seq < r.seq <= snap_seq} <= {
            "register_fanout_groups"}
        assert_same(snapshots[snap_seq], fingerprint(back),
                    ctx=f"(crash at byte {off}, committed seq {expected_seq})")
        torn.unlink()


class TestKillAtArbitraryWalOffset:
    def test_no_committed_transition_lost_or_doubled(self, tmp_path):
        st = journaled(PORT, tmp_path / "wal.log")
        snapshots: dict[int, dict] = {}
        watermark = drive_workload(st, PORT, tmp_path / "ckpt", snapshots)
        st.journal.flush()
        check_every_offset(PORT, PORT, tmp_path, snapshots, watermark)

    def test_full_wal_recovers_tip_state(self, tmp_path):
        st = journaled(PORT, tmp_path / "wal.log")
        drive_workload(st, PORT, tmp_path / "ckpt", {})
        st.journal.flush()
        back, report = PORT.recover(tmp_path / "ckpt", tmp_path / "wal.log",
                                    attach_journal=True)
        assert_same(fingerprint(st), fingerprint(back), ctx="(tip)")
        # The replay is published on the recovered state's host counters.
        assert PORT.host_counter(back, "WAL_REPLAYED_OPS") == report["wal_records_replayed"] > 0
        # The reattached journal continues the numbering, and the
        # recovered state keeps admitting and journaling.
        assert back.journal.last_seq == st.journal.last_seq
        slot2 = back.create_session("s:post", port_models.SessionConfig(min_sigma_eff=0.0),
                                    now=9.0)
        back.enqueue_join(slot2, "did:post", 0.9)
        assert (back.flush_joins(now=9.5) == 0).all()
        assert back.journal.last_seq > st.journal.last_seq


def test_reference_log_and_checkpoint_recover_on_the_port_at_every_offset(tmp_path):
    """The reference writes the checkpoint and the log; the port recovers
    at every record boundary and torn cut, equal to the reference's own
    snapshots."""
    st = journaled(REF, tmp_path / "wal.log")
    snapshots: dict[int, dict] = {}
    watermark = drive_workload(st, REF, tmp_path / "ckpt", snapshots)
    st.journal.flush()
    check_every_offset(REF, PORT, tmp_path, snapshots, watermark)


class TestRecoverySafety:
    def test_recover_refuses_without_durable_checkpoint(self, tmp_path):
        with pytest.raises(port_recovery.RecoveryError, match="durable"):
            PORT.recover(tmp_path, None)

    def test_latest_durable_skips_markerless_saves(self, tmp_path):
        for name, done in (("step_1", True), ("step_2", False)):
            d = tmp_path / name
            d.mkdir()
            if done:
                (d / ".done").touch()
        assert port_recovery.latest_durable_checkpoint(tmp_path).name == "step_1"
        assert [s for s, _ in port_recovery.step_checkpoints(tmp_path)] == [1, 2]
        assert [s for s, _ in port_recovery.step_checkpoints(tmp_path, durable_only=True)] == [1]

    def test_latest_durable_orders_by_completion_time(self, tmp_path):
        (tmp_path / "step_5").mkdir()
        (tmp_path / "step_5" / ".done").touch()
        os.utime(tmp_path / "step_5" / ".done", (1_000, 1_000))
        (tmp_path / "latest").mkdir()
        (tmp_path / "latest" / ".done").touch()
        os.utime(tmp_path / "latest" / ".done", (2_000, 2_000))
        assert port_recovery.latest_durable_checkpoint(tmp_path).name == "latest"

    def test_audit_head_mismatch_refuses(self):
        st = PORT.state()
        slot = st.create_session("s:audit", port_models.SessionConfig(min_sigma_eff=0.0))
        st.enqueue_join(slot, "did:a", 0.8)
        st.flush_joins()
        st.stage_delta(slot, 0, ts=1.0, change_words=np.arange(2, dtype=np.uint32))
        st.flush_deltas()
        assert port_recovery.verify_audit_heads(st) == 1
        st._chain_seed[slot] = np.zeros(8, np.uint32)
        with pytest.raises(port_recovery.RecoveryError, match="chain head mismatch"):
            port_recovery.verify_audit_heads(st)


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: port_recovery.recover(tmp_path),
                 lambda: port_recovery.recover_tenant(tmp_path, 0),
                 lambda: port_ckpt.restore_state(tmp_path)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# ── every journaled op, on both packages ─────────────────────────────


def plain(value):
    """A returned value in comparable form for either package; a wave's
    or the gateway's result tuple by its type name (the tables, compared
    apart, hold what it wrote)."""
    if hasattr(value, "_fields"):
        return type(value).__name__
    if isinstance(value, torch.Tensor):
        return value.numpy().tolist()
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    return value


def attempt(log: list, fn, *args, **kw):
    """Call one op, logging its return or the type of its refusal (both
    packages must refuse the same calls)."""
    try:
        out = fn(*args, **kw)
    except (ValueError, RuntimeError) as err:
        log.append(("raised", type(err).__name__))
        return None
    log.append(plain(out))
    return out


def rich_sequence(st, pkg: Pkg, seed: int, after=lambda: None, checkpoint=lambda: None) -> list:
    """A seeded sequence that calls every journaled op of the state (all
    31) with values drawn from `seed`, at dyadic times (ROADMAP C.2).
    `after` runs after every call, `checkpoint` once, after the joins.
    Returns the calls' results."""
    rng = np.random.RandomState(seed)
    M = pkg.models
    log: list = []

    def op(fn, *args, **kw):
        out = attempt(log, fn, *args, **kw)
        after()
        return out

    def t(k):
        return k / 4.0

    free = M.SessionConfig(min_sigma_eff=0.0)
    s0 = op(st.create_session, f"s:{seed}:a", free, now=1.0)
    s1 = op(st.create_session, f"s:{seed}:b", M.SessionConfig(
        min_sigma_eff=0.25, max_participants=6, max_duration_seconds=600,
        consistency_mode=M.ConsistencyMode.STRONG), now=1.5)
    park = op(st.create_session, f"s:{seed}:park", free, now=1.75)
    dids = [f"did:{seed}:{i}" for i in range(6)]
    for i, did in enumerate(dids):
        op(st.enqueue_join, s0 if i < 4 else s1, did, float(np.float32(rng.uniform(0.62, 0.9))),
           trustworthy=i != 3)
    op(st.enqueue_join, s0, dids[0], 0.875)  # a duplicate: refused at the flush
    op(st.flush_joins, now=2.0, pad_to=8 if seed % 2 else None)
    checkpoint()
    rows = [st.agent_row(d)["slot"] for d in dids]
    op(st.set_session_state, s0, M.SessionState.ACTIVE)
    op(st.force_session_mode, s1, M.ConsistencyMode.STRONG, has_nonreversible=True)
    op(st.add_vouch, rows[0], rows[1], s0, bond=0.125, bond_pct=0.25)
    op(st.add_vouch, rows[2], rows[1], s0, bond=0.0625)
    e2 = op(st.add_vouch, rows[4], rows[5], s1, bond=0.1, expiry=50.0)
    op(st.release_vouch, e2)
    op(st.free_edge_rows, [])
    for k in range(3):
        words = rng.randint(0, 2**32, 3 + k, dtype=np.uint64).astype(np.uint32)
        op(st.stage_delta, s0, rows[k], ts=t(12 + k), change_words=words)
    op(st.stage_delta, s1, rows[4], ts=t(16),
       digest_words=rng.randint(0, 2**32, 8, dtype=np.uint64).astype(np.uint32))
    op(st.stage_delta, s1, rows[5], ts=t(17))
    op(st.flush_deltas)
    g = op(st.create_saga, f"saga:{seed}", s0, [{"retries": 1, "has_undo": True},
                                                {"timeout": 5.0}, {}])
    fan = pkg.dsl.SagaDSLParser().parse({
        "name": "fan", "session_id": f"s:{seed}:a", "saga_id": f"saga:{seed}:fan",
        "steps": [{"id": f"b{i}", "action_id": f"m.b{i}", "agent": dids[0],
                   "execute_api": f"/b{i}", "undo_api": f"/ub{i}"} for i in range(3)]
        + [{"id": "tail", "action_id": "m.tail", "agent": dids[0], "execute_api": "/tail"}],
        "fan_out": [{"policy": "majority_must_succeed", "branches": ["b0", "b1", "b2"]}],
    })
    gf = op(st.create_saga_from_dsl, fan, s0)
    op(st.saga_round, {g: False})
    op(st.saga_round, {g: True})
    op(st.fanout_settle, {(gf, 0): True, (gf, 1): bool(seed % 2), (gf, 2): True})
    op(st.saga_round, {}, {})
    op(st.check_actions_wave, [rows[0], rows[1], rows[2], rows[3], rows[0]], [2, 1, 0, 2, 2],
       [False, True, False, False, False], [False] * 5, [False, False, True, False, False],
       [False, False, False, True, False], now=t(20))
    op(st.record_calls, [rows[0], rows[1], rows[0]], [2, 0, 1], now=t(21))
    op(st.breach_sweep_tick, t(22))
    op(st.consume_rate, [rows[0], rows[0], rows[2]], now=t(23), rings=[1, 1, 3])
    op(st.consume_rate, [rows[1]], now=t(24))
    op(st.grant_elevation, rows[2], 1, now=t(25), ttl_seconds=4.0)
    el = op(st.grant_elevation, rows[1], 1, now=t(25))
    if el is not None:
        op(st.revoke_elevation, el, expected_agent=rows[1])
    op(st.elevation_tick, t(40))
    op(st.quarantine_rows, [rows[3]], now=t(41))
    op(st.quarantine_rows, [rows[2], rows[3]], now=t(42), duration=2.0)
    op(st.quarantine_tick, t(60))
    op(st.set_agent_risk, rows[1], 0.375)
    op(st.set_agent_ring, rows[0], 3, now=t(61))
    slots = op(st.create_sessions_batch, [f"w:{seed}:{i}" for i in range(3)], free)
    op(st.run_governance_wave, slots, [f"did:{seed}:w{i}" for i in range(3)], slots.copy(),
       rng.uniform(0.4, 0.9, 3).astype(np.float32),
       rng.randint(0, 2**32, (2, 3, 16), dtype=np.uint64).astype(np.uint32), now=t(64),
       actions={"slots": [rows[0], rows[1], rows[1]], "required_rings": [2, 0, 2]},
       pad_to=(4, 4) if seed % 2 else None)
    op(st.apply_slash, s0, rows[1], 0.5, now=t(65))
    op(st.blacklist_rows, [rows[4]])
    op(st.leave_agent, s1, dids[5])
    op(st.terminate_sessions, [s0, s1], now=t(66), pad_to=3, pad_slot=park)
    return log


@pytest.mark.parametrize("seed", [1, 2, 7])
def test_every_op_writes_the_reference_log_bytes(seed, tmp_path):
    runs = {}
    for pkg in (REF, PORT):
        d = tmp_path / ("ref" if pkg.ref else "port")
        st = journaled(pkg, d / "wal.log")
        results = rich_sequence(st, pkg, seed)
        st.journal.flush()
        runs[pkg.ref] = (st, (d / "wal.log").read_bytes(), results)
    (ref_st, ref_log, ref_out), (port_st, port_log, port_out) = runs[True], runs[False]
    ops = {r.op for r in port_wal.scan(tmp_path / "port" / "wal.log").committed}
    assert ops == set(port_recovery.REPLAY), f"ops not reached: {set(port_recovery.REPLAY) - ops}"
    assert port_out == ref_out
    assert port_log == ref_log
    assert_same(fingerprint(ref_st), fingerprint(port_st), ctx=f"(seed {seed})")


@pytest.mark.parametrize("seed", [2, 7])
def test_reference_rich_log_recovers_on_the_port_at_every_commit(seed, tmp_path):
    """Every journaled op replayed on the port from the reference's log
    and checkpoint: recovery at every commit boundary and at torn cuts
    (inside an intent line, inside a commit line, 3 bytes short of the
    end) equals the reference at the same committed prefix."""
    st = journaled(REF, tmp_path / "wal.log")
    snapshots: dict[int, dict] = {}
    marks = {}

    def snap():
        snapshots[st.journal.last_seq] = fingerprint(st)

    def checkpoint():
        marks["watermark"] = st.journal.last_seq
        REF.recovery.checkpoint_with_watermark(st, tmp_path / "ckpt", step=1)

    rich_sequence(st, REF, seed, after=snap, checkpoint=checkpoint)
    st.journal.flush()

    def commits_and_torn(raw: bytes) -> list[int]:
        lines = raw.splitlines(keepends=True)
        ends = np.cumsum([len(x) for x in lines]).tolist()
        commit_ends = [e for line, e in zip(lines, ends) if b'"k":"C"' in line]
        intent_line = next(i for i, line in enumerate(lines) if b'"op":"governance_wave"' in line)
        commit_line = intent_line + 1
        return sorted({0, *commit_ends, ends[intent_line] - len(lines[intent_line]) // 2,
                       ends[commit_line] - 4, len(raw) - 3})

    check_every_offset(REF, PORT, tmp_path, snapshots, marks["watermark"],
                       offsets=commits_and_torn)


# ── chaos: hand-retried dispatches end where the clean run ends ──────


def wave_workload(st, pkg: Pkg, dispatch) -> None:
    """The reference's end-to-end chaos workload: eight two-session waves,
    every dispatch through `dispatch`."""
    for i in range(8):
        slots = st.create_sessions_batch([f"e2e{i}:{j}" for j in range(2)],
                                         pkg.models.SessionConfig(min_sigma_eff=0.0))
        dispatch(st.run_governance_wave, slots, [f"did:e2e{i}:{j}" for j in range(2)],
                 slots.copy(), np.full(2, 0.8, np.float32), np.zeros((1, 2, 16), np.uint32),
                 float(i))


def retry_by_hand(pkg: Pkg, counter: list):
    """A dispatch that retries an injected fault until it goes through
    (by hand: the supervisor's ladder is tested on its own)."""

    def dispatch(fn, *args):
        while True:
            try:
                return fn(*args)
            except pkg.chaos.InjectedWaveFault:
                counter.append(1)

    return dispatch


def test_hand_retried_chaos_run_equals_the_clean_run_on_both_packages(tmp_path):
    ends = {}
    for pkg in (REF, PORT):
        clean = pkg.state()
        wave_workload(clean, pkg, lambda fn, *a: fn(*a))
        side = tmp_path / ("ref" if pkg.ref else "port")
        chaotic = journaled(pkg, side / "e2e.log")
        chaotic.fault_injector = pkg.chaos.WaveChaosInjector(
            pkg.chaos.WaveChaosPlan(seed=11, fail_rate=0.4))
        retries: list = []
        wave_workload(chaotic, pkg, retry_by_hand(pkg, retries))
        assert retries, "seed 11 injected nothing: plan drifted?"
        assert_same(fingerprint(clean), fingerprint(chaotic), ctx="(chaos vs clean)")
        # The journal replays the chaotic history losslessly: faulted
        # dispatches raised before their bracket and left no record.
        pkg.recovery.checkpoint_with_watermark(chaotic, side / "ck")
        back, _ = pkg.recover(side / "ck", side / "e2e.log")
        assert_same(fingerprint(chaotic), fingerprint(back), ctx="(chaotic log replayed)")
        ends[pkg.ref] = (fingerprint(chaotic), len(retries),
                         chaotic.fault_injector.report(),
                         (side / "e2e.log").read_bytes())
    assert_same(ends[True][0], ends[False][0], ctx="(port vs reference)")
    assert ends[True][1:] == ends[False][1:]


def test_corruption_lands_on_the_reference_rows_and_bits():
    """One plan's corruptions damage the same rows, words and bits on both
    packages, and the tables stay byte-equal after them."""
    plans = [port_chaos.InjectedCorruption(kind, at_dispatch=at, table=table)
             for kind, at, table in (("bit_flip", 1, "agents"), ("bit_flip", 1, "vouches"),
                                     ("bit_flip", 2, "delta_log"), ("row_rewrite", 2, "agents"),
                                     ("row_rewrite", 2, "sessions"), ("row_rewrite", 3, "vouches"),
                                     ("chain_tamper", 3, "agents"))]
    ends = []
    for pkg in (REF, PORT):
        st = pkg.state()
        rich_sequence(st, pkg, 5)
        st.create_sessions_batch(["c:0"], pkg.models.SessionConfig(min_sigma_eff=0.0))
        fresh = st.add_vouch(0, 1, 0, bond=0.25)
        inj = pkg.chaos.WaveChaosInjector(pkg.chaos.WaveChaosPlan(
            seed=3, corruptions=tuple(pkg.chaos.InjectedCorruption(c.kind, c.at_dispatch, c.table)
                                      for c in plans)))
        st.fault_injector = inj
        for _ in range(3):
            st.saga_round({})
        ends.append((fingerprint(st), inj.report(), fresh))
    assert ends[0][1]["corruptions_applied"] and ends[0][1]["corruptions_pending"] == 0
    assert ends[0][1:] == ends[1][1:]
    assert_same(ends[0][0], ends[1][0], ctx="(after the corruptions)")


def test_same_seed_same_fault_schedule():
    def schedule(seed):
        inj = port_chaos.WaveChaosInjector(
            port_chaos.WaveChaosPlan(seed=seed, fail_rate=0.3, hang_rate=0.2, hang_seconds=0.0))
        out = []
        for _ in range(64):
            try:
                inj.on_dispatch("governance_wave")
                out.append("ok")
            except port_chaos.InjectedWaveFault:
                out.append("fault")
        return out, inj.hangs

    assert schedule(7) == schedule(7)
    assert schedule(7) != schedule(8)


class TestChaosHangHygiene:
    def test_hangs_are_tracked_and_cancellable(self):
        async def scenario():
            chaos = port_chaos.ChaosExecutorFactory(
                port_chaos.ChaosPlan(seed=0, fail_rate=0.0, hang_rate=1.0, hang_seconds=3600.0))

            async def step():
                return "done"

            wrapped = chaos.wrap(step, key="hangy")
            tasks = [asyncio.ensure_future(wrapped()) for _ in range(3)]
            await asyncio.sleep(0)
            assert chaos.hanging_tasks == 3
            assert chaos.cancel_hangs() == 3
            results = await asyncio.gather(*tasks, return_exceptions=True)
            assert all(isinstance(r, asyncio.CancelledError) for r in results)
            assert chaos.hanging_tasks == 0
            return chaos.report()

        report = asyncio.run(scenario())
        assert report["hangs"] == 3

        async def probe():
            return [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]

        assert asyncio.run(probe()) == []


# ── degraded mode: the shed gate, the damper, the fan-out pause ──────


def test_shed_gate_refuses_loudly_and_counts_on_both_packages():
    outs = []
    for pkg in (REF, PORT):
        st = pkg.state()
        slot = st.create_session("s:shed", pkg.models.SessionConfig(min_sigma_eff=0.0), now=0.0)
        log: list = []
        st.degraded_policy = pkg.policy.DegradedPolicy(reason="drill")
        with pytest.raises(pkg.policy.DegradedModeRefusal, match="degraded mode active"):
            st.enqueue_join(slot, "did:shed", 0.9)
        st.degraded_policy = pkg.policy.DegradedPolicy(
            shed_admissions=False, admission_sigma_floor=0.5, reason="floor")
        with pytest.raises(pkg.policy.SybilShedRefusal, match="below the active floor"):
            st.enqueue_join(slot, "did:low", 0.25)
        log.append(st.enqueue_join(slot, "did:high", 0.75))
        st.degraded_policy = None
        log.append(st.enqueue_join(slot, "did:low", 0.25))
        log.append(st.flush_joins(now=1.0).tolist())
        log.append((pkg.host_counter(st, "ADMISSIONS_SHED"),
                    pkg.host_counter(st, "ADMISSIONS_DAMPED")))
        log.append(st.resilience_summary())
        outs.append((log, fingerprint(st)))
    assert outs[0][0] == outs[1][0]
    assert outs[0][0][3] == (2, 1)
    assert_same(outs[0][1], outs[1][1])


def test_admission_damper_trips_and_sheds_the_same_joins(tmp_path):
    """A low-sigma flood at synthetic arrival times (`enqueue_join(now=)`)
    trips the damper's targeted shed at the same join on both packages;
    honest joins flow; the journal holds only the staged joins, and the
    replay (which disables the damper) admits exactly them."""
    outs = []
    for pkg in (REF, PORT):
        side = tmp_path / ("ref" if pkg.ref else "port")
        st = journaled(pkg, side / "wal.log")
        slot = st.create_session("s:flood", pkg.models.SessionConfig(
            min_sigma_eff=0.0, max_participants=64), now=0.0)
        pkg.recovery.checkpoint_with_watermark(st, side / "ck")
        st.admission_damper = pkg.policy.AdmissionDamper(
            rate_threshold=6.0, low_sigma_fraction=0.5, sigma_floor=0.5, window_seconds=1.0)
        log = []
        for i in range(24):
            sigma = 0.75 if i % 4 == 0 else 0.25
            try:
                log.append(st.enqueue_join(slot, f"did:flood:{i}", sigma, now=i / 16))
            except pkg.policy.SybilShedRefusal as err:
                log.append(("damped", str(err)))
        log.append(st.admission_damper.summary())
        log.append((pkg.host_counter(st, "ADMISSIONS_SHED"),
                    pkg.host_counter(st, "ADMISSIONS_DAMPED")))
        log.append(st.flush_joins(now=2.0).tolist())
        st.journal.flush()
        back, _ = pkg.recover(side / "ck", side / "wal.log")
        assert_same(fingerprint(st), fingerprint(back), ctx="(damped run replayed)")
        outs.append((log, fingerprint(st), (side / "wal.log").read_bytes()))
    assert outs[0][0] == outs[1][0]
    assert outs[0][0][24]["trips"] >= 1 and outs[0][0][24]["damped"] > 0
    assert outs[0][2] == outs[1][2]
    assert_same(outs[0][1], outs[1][1])


def test_degraded_policy_pauses_the_fan_out():
    outs = []
    for pkg in (REF, PORT):
        st = pkg.state()
        sess = st.create_session("s:fan", pkg.models.SessionConfig(min_sigma_eff=0.0), now=0.0)
        fan = pkg.dsl.SagaDSLParser().parse({
            "name": "fan", "session_id": "s:fan", "saga_id": "saga:fan",
            "steps": [{"id": f"b{i}", "action_id": f"m.b{i}", "agent": "did:f",
                       "execute_api": f"/b{i}"} for i in range(3)],
            "fan_out": [{"policy": "all_must_succeed", "branches": ["b0", "b1", "b2"]}],
        })
        g = st.create_saga_from_dsl(fan, sess)
        log = [st.fanout_dispatch()]
        st.degraded_policy = pkg.policy.DegradedPolicy(reason="pause")
        log.append(st.fanout_dispatch())
        log.append(st.saga_work())  # cursor steps and compensations still flow
        st.degraded_policy = pkg.policy.DegradedPolicy(pause_saga_fanout=False)
        log.append(st.fanout_dispatch())
        st.degraded_policy = None
        st.fanout_settle({(g, i): True for i in range(3)})
        log.append(st.fanout_dispatch())
        outs.append(log)
    assert outs[0] == outs[1]
    assert outs[1][0] and outs[1][1] == [] and outs[1][3] == outs[1][0]


# ── the summaries, recover_tenant, the supervisor ────────────────────


def test_resilience_summary_without_a_supervisor(tmp_path):
    outs = []
    for pkg in (REF, PORT):
        st = pkg.state()
        bare = st.resilience_summary()
        st.journal = pkg.wal.WriteAheadLog(tmp_path / ("r.log" if pkg.ref else "p.log"),
                                           fsync=False)
        st.create_session("s:sum", pkg.models.SessionConfig(), now=0.0)
        st.degraded_policy = pkg.policy.DegradedPolicy(reason="summary", entered_at=2.0)
        full = st.resilience_summary()
        full["journal"]["path"] = Path(full["journal"]["path"]).name[1:]
        outs.append((bare, full, st.integrity_summary()))
    assert outs[0] == outs[1]
    assert outs[1][0] == {"enabled": False, "mode": "normal",
                          "degraded": {"active_policy": None}, "journal": None}
    assert outs[1][1]["mode"] == "degraded" and outs[1][2] == {"enabled": False}


def test_recover_tenant_reads_either_packages_bundle(tmp_path):
    """A tenant's namespace `<bundle>/tenant_<t>/{wal.log, step_<N>/}`,
    written by each package, recovers on the port equal to its writer."""
    for pkg in (REF, PORT):
        tdir = tmp_path / ("ref" if pkg.ref else "port") / "tenant_3"
        st = journaled(pkg, tdir / "wal.log")
        snapshots: dict[int, dict] = {}
        drive_workload(st, pkg, tdir, snapshots)
        st.journal.flush()
        back, report = port_recovery.recover_tenant(tdir.parent, 3, config=PORT.cfg(),
                                                    device="cpu")
        assert report["tenant"] == 3 and report["wal_records_replayed"] > 0
        assert_same(fingerprint(st), fingerprint(back), ctx=f"(tenant, ref={pkg.ref})")
        with pytest.raises(port_recovery.RecoveryError, match="no durable namespace"):
            port_recovery.recover_tenant(tdir.parent, 4, config=PORT.cfg(), device="cpu")


def test_supervisor_waits_for_the_health_plane():
    """The supervisor arrived with the health plane: the package resolves
    it, and attaching one subscribes it to the state's health fan-out
    and publishes it as `state.resilience`."""
    import hypervisor_tpu_torch.resilience as res
    from hypervisor_tpu_torch.resilience import supervisor as port_supervisor

    assert res.Supervisor is port_supervisor.Supervisor
    assert res.recover is port_recovery.recover
    st = PORT.state()
    sup = res.Supervisor(st)
    assert st.resilience is sup
    assert sup._on_health_event in st.health._listeners
    assert st.resilience_summary()["enabled"] is True
