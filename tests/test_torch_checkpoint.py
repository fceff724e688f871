"""The port's device-table checkpoints against the reference's, on the CPU.

Counterparts of `tests/unit/test_checkpoint.py`'s npz tests on
`hypervisor_tpu_torch.runtime.checkpoint` with the port's
`HypervisorState(device="cpu")` (the orbax pair is a JAX library: its
counterpart comes with ROADMAP A8). Then across the packages, with the
reference unarmed (`HV_WAVE_PALLAS=0`) and time patched the same way for
both: a checkpoint written by either package restores on the other with
equal arrays (tolerance 0, dtypes included) and an equal `host.json`,
and the port's host mirror of the DeltaLog cursor comes back from the
restored column, so the first wave after a restore appends where the
saved state would have.
"""

from __future__ import annotations

import asyncio
import json
import time

import numpy as np
import pytest

from hypervisor_tpu.runtime import checkpoint as jax_ckpt
from hypervisor_tpu.state import HypervisorState as JaxState
from hypervisor_tpu_torch import config as port_config
from hypervisor_tpu_torch.models import SessionConfig
from hypervisor_tpu_torch.ops import saga_ops
from hypervisor_tpu_torch.resilience.recovery import latest_durable_checkpoint
from hypervisor_tpu_torch.runtime import checkpoint as ckpt_mod
from hypervisor_tpu_torch.runtime.checkpoint import restore_state, save_state, wait_durable
from hypervisor_tpu_torch.runtime.saga_scheduler import SagaScheduler
from hypervisor_tpu_torch.state import HypervisorState
from hypervisor_tpu_torch.tables.state import AgentTable, SessionTable
from tests.test_torch_resilience import PORT, REF, assert_same, fingerprint, rich_sequence


@pytest.fixture(autouse=True)
def unarmed(monkeypatch):
    monkeypatch.setenv("HV_WAVE_PALLAS", "0")


def _state() -> HypervisorState:
    return HypervisorState(device="cpu")


def _restore(target, config=port_config.DEFAULT_CONFIG) -> HypervisorState:
    return restore_state(target, config, device="cpu")


def _populated_state() -> HypervisorState:
    st = _state()
    slot = st.create_session("session:ckpt", SessionConfig())
    for i in range(4):
        st.enqueue_join(slot, f"did:ck{i}", sigma_raw=0.7 + i * 0.05)
    status = st.flush_joins()
    assert (status == 0).all()
    return st


def _col(t) -> np.ndarray:
    return t.cpu().numpy()


def test_save_restore_round_trip(tmp_path):
    st = _populated_state()
    target = save_state(st, tmp_path, step=1)
    assert (target / "tables.npz").exists()
    back = _restore(target)
    np.testing.assert_array_equal(_col(back.agents.sigma_eff), _col(st.agents.sigma_eff))
    np.testing.assert_array_equal(_col(back.sessions.state), _col(st.sessions.state))
    assert back.agent_ids.lookup("did:ck2") == st.agent_ids.lookup("did:ck2")
    assert back._next_agent_slot == st._next_agent_slot
    assert back._members == st._members
    assert_same(fingerprint(st), fingerprint(back))
    # Nothing staged survives (a save refuses staged work), and the
    # caches and transient lists start empty.
    assert (back._staged_members, back._pending_rows, back._pending_deltas,
            back._scrubbed_edges, back._slot_of_member, back._packed_bodies) == \
        (set(), {}, [], [], {}, {})


def test_restored_state_continues_ticking(tmp_path):
    st = _populated_state()
    back = _restore(save_state(st, tmp_path))
    slot = int(_col(back.agents.session)[0])
    # The admitted membership is still known after the restore.
    back.enqueue_join(slot, "did:ck0", sigma_raw=0.9)
    assert back.flush_joins()[0] != 0
    # And a fresh agent still admits, its row found through the scan
    # (the restored state's `_slot_of_member` cache starts empty).
    back.enqueue_join(slot, "did:new", sigma_raw=0.8)
    assert back.flush_joins()[0] == 0
    assert back.agent_row("did:new") is not None
    assert back.agent_row("did:ck1", slot) == st.agent_row("did:ck1", slot)


def test_background_save_is_durable(tmp_path):
    st = _populated_state()
    target = save_state(st, tmp_path, step=7, background=True)
    assert wait_durable(target, timeout=30.0)
    back = _restore(target)
    assert back.participant_count(0) == st.participant_count(0)


class TestMidSagaResume:
    def test_saga_resumes_across_checkpoint_restore(self, tmp_path):
        st = _state()
        slot = st.create_session("s:resume", SessionConfig())
        g = st.create_saga("saga:resume", slot, [{"retries": 1}, {}, {"has_undo": True}])
        st.saga_round({g: True})
        assert int(st.sagas.cursor[g]) == 1
        restored = _restore(save_state(st, tmp_path / "mid"))
        assert int(restored.sagas.cursor[g]) == 1
        assert int(restored.sagas.step_state[g, 0]) == saga_ops.STEP_COMMITTED
        sched = SagaScheduler(restored, retry_backoff_seconds=0.0)

        async def ok():
            return "ok"

        sched.register(g, 1, ok)
        sched.register(g, 2, ok, undo=ok)
        asyncio.run(sched.run_until_settled())
        assert int(restored.sagas.saga_state[g]) == saga_ops.SAGA_COMPLETED

    def test_vouch_and_elevation_state_survive(self, tmp_path):
        st = _state()
        slot = st.create_session("s:ve", SessionConfig())
        st.enqueue_join(slot, "did:a", 0.9)
        st.enqueue_join(slot, "did:b", 0.5)
        assert (st.flush_joins() == 0).all()
        a, b = st.agent_row("did:a"), st.agent_row("did:b")
        edge = st.add_vouch(a["slot"], b["slot"], slot, bond=0.18)
        st.grant_elevation(b["slot"], granted_ring=1, now=0.0, ttl_seconds=50.0)
        restored = _restore(save_state(st, tmp_path / "ve"))
        assert bool(restored.vouches.active[edge])
        assert restored.effective_rings(now=10.0)[b["slot"]] == 1
        assert restored.effective_rings(now=60.0)[b["slot"]] == b["ring"]
        restored.release_vouch(edge)
        assert restored.add_vouch(a["slot"], b["slot"], slot, bond=0.10) == edge

    def test_free_edge_rows_survive_restore(self, tmp_path):
        st = _state()
        slot = st.create_session("s:fe", SessionConfig())
        st.enqueue_join(slot, "did:x", 0.9)
        st.enqueue_join(slot, "did:y", 0.5)
        assert (st.flush_joins() == 0).all()
        x, y = st.agent_row("did:x")["slot"], st.agent_row("did:y")["slot"]
        edge = st.add_vouch(x, y, slot, bond=0.1)
        st.release_vouch(edge)
        restored = _restore(save_state(st, tmp_path / "fe"))
        assert restored.add_vouch(x, y, slot, bond=0.2) == edge


def test_staged_work_refuses_checkpoint(tmp_path):
    st = _populated_state()
    slot = int(_col(st.agents.session)[0])
    st.enqueue_join(slot, "did:staged", sigma_raw=0.9)
    with pytest.raises(RuntimeError, match="staged joins"):
        save_state(st, tmp_path, step=1)
    st.flush_joins()
    st.stage_delta(slot, 0, ts=1.0)
    with pytest.raises(RuntimeError, match="staged deltas"):
        save_state(st, tmp_path, step=1)


def test_crash_mid_write_never_exposes_torn_tables(tmp_path, monkeypatch):
    st = _populated_state()
    target = save_state(st, tmp_path, step=1)
    assert (target / ".done").exists()
    before = _col(st.agents.sigma_eff).copy()
    slot = int(_col(st.agents.session)[0])
    st.enqueue_join(slot, "did:late", sigma_raw=0.9)
    st.flush_joins()

    def torn_savez(f, **arrays):
        f.write(b"PK\x03\x04 torn")
        raise OSError("simulated crash mid-write")

    monkeypatch.setattr(ckpt_mod.np, "savez", torn_savez)
    with pytest.raises(OSError):
        save_state(st, tmp_path, step=1)
    monkeypatch.undo()
    back = _restore(target)
    np.testing.assert_array_equal(_col(back.agents.sigma_eff), before)
    assert back.agent_row("did:late") is None
    assert not (target / ".done").exists()
    assert latest_durable_checkpoint(tmp_path) is None


def test_capacity_mismatch_refuses_restore(tmp_path):
    target = save_state(_populated_state(), tmp_path, step=1)
    shrunk = port_config.HypervisorConfig(
        capacity=port_config.TableCapacity(max_agents=64, max_sessions=32))
    with pytest.raises(ValueError, match="capacity mismatch"):
        _restore(target, shrunk)


def _wave(st, tag):
    slots = st.create_sessions_batch([f"{tag}:0", f"{tag}:1"], SessionConfig(min_sigma_eff=0.0))
    st.run_governance_wave(slots, [f"did:{tag}:0", f"did:{tag}:1"], slots.copy(),
                           np.full(2, 0.8, np.float32),
                           np.arange(2 * 2 * 16, dtype=np.uint32).reshape(2, 2, 16))


def test_restore_then_dispatch_continues_the_saved_run(tmp_path):
    """The port has no compile cache to stay warm (the reference's version
    counts recompiles); its counterpart: a restored state's first wave
    lands exactly where the saved state's own next wave does, DeltaLog
    rows, cursor mirror and audit index included."""
    st = _state()
    _wave(st, "pre")
    back = _restore(save_state(st, tmp_path, step=1))
    assert back._delta_cursor == st._delta_cursor == int(st.delta_log.cursor) == 4
    assert back.tracer.cursor == 0 == int(back.tracer.table.cursor)
    _wave(st, "post")
    _wave(back, "post")
    assert_same(fingerprint(st), fingerprint(back), ctx="(after the post-restore wave)")
    assert back._delta_cursor == st._delta_cursor == 8
    assert back._audit_rows == st._audit_rows and back._row_session.tolist() == \
        st._row_session.tolist()
    assert {s: f.root_hex() for s, f in back._frontier.items()} == \
        {s: f.root_hex() for s, f in st._frontier.items()}


def test_restore_legacy_percolumn_checkpoint(tmp_path):
    st = _populated_state()
    target = save_state(st, tmp_path, step=7)
    path = target / "tables.npz"
    data = dict(np.load(path))
    for tname, ttype in (("agents", AgentTable), ("sessions", SessionTable)):
        blocks = {}
        for name, (block, idx) in ttype._PACKED.items():
            blocks.setdefault(block, []).append((idx, name))
        for block, cols in blocks.items():
            arr = data.pop(f"{tname}.{block}")
            for idx, name in cols:
                data[f"{tname}.{name}"] = arr[:, idx]
    del data["agents.quarantine_until"]
    with open(path, "wb") as f:
        np.savez(f, **data)
    back = _restore(target)
    np.testing.assert_array_equal(_col(back.agents.sigma_eff), _col(st.agents.sigma_eff))
    np.testing.assert_array_equal(_col(back.agents.did), _col(st.agents.did))
    for col in ("sid", "state", "mode", "n_participants", "max_participants", "min_sigma_eff"):
        np.testing.assert_array_equal(_col(getattr(back.sessions, col)),
                                      _col(getattr(st.sessions, col)),
                                      err_msg=f"sessions.{col} diverged")
    assert not _col(back.agents.quarantine_until).any()
    assert back.quarantine_tick(now=1.0) == []


# ── across the packages ──────────────────────────────────────────────


def _saved(pkg, tmp_path, monkeypatch, seed: int):
    """A state of `pkg` after the every-op sequence, and its checkpoint,
    with the epoch taken from a patched clock."""
    monkeypatch.setattr(time, "time", lambda: 1_767_225_600.0)
    st = pkg.state()
    monkeypatch.undo()
    monkeypatch.setenv("HV_WAVE_PALLAS", "0")
    rich_sequence(st, pkg, seed)
    target = (jax_ckpt if pkg.ref else ckpt_mod).save_state(
        st, tmp_path / ("ref" if pkg.ref else "port"), step=3)
    return st, target


@pytest.mark.parametrize("seed", [3, 4])
def test_checkpoints_restore_across_the_packages(seed, tmp_path, monkeypatch):
    ref_st, ref_target = _saved(REF, tmp_path, monkeypatch, seed)
    port_st, port_target = _saved(PORT, tmp_path, monkeypatch, seed)
    ref_npz, port_npz = np.load(ref_target / "tables.npz"), np.load(port_target / "tables.npz")
    assert ref_npz.files == port_npz.files
    for key in ref_npz.files:
        a, b = ref_npz[key], port_npz[key]
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), key
    assert (ref_target / "host.json").read_bytes() == (port_target / "host.json").read_bytes()
    assert json.loads((port_target / "host.json").read_text())["wal_seq"] is None
    # Each package restores the other's checkpoint.
    on_port = restore_state(ref_target, PORT.cfg(), device="cpu")
    on_ref = jax_ckpt.restore_state(port_target, REF.cfg())
    assert isinstance(on_ref, JaxState)
    for saved, back in ((ref_st, on_port), (port_st, on_ref), (port_st, on_port)):
        assert_same(fingerprint(saved), fingerprint(back))
    assert ckpt_mod.host_metadata(on_port) == jax_ckpt.host_metadata(on_ref)
    assert on_port._delta_cursor == int(on_port.delta_log.cursor) == port_st._delta_cursor > 0


@pytest.mark.parametrize("seed", [3])
def test_dcp_backend_restores_what_the_npz_path_restores(seed, tmp_path, monkeypatch):
    """The sharded-state pair through `torch.distributed.checkpoint` with
    no process group: three steps kept to the newest two, and the latest
    restored equal to the npz restore of the same state, column for
    column (u32 words included) and in its host metadata, and to the
    saved state's fingerprint. The reference's pair is its orbax backend
    (`hypervisor_tpu.runtime.checkpoint.save_state_orbax`), whose library
    this machine lacks; both serialize the same (arrays, metadata) pair."""
    import torch.distributed as dist

    port_st, npz_target = _saved(PORT, tmp_path, monkeypatch, seed)
    manager = ckpt_mod.open_checkpoint_manager(tmp_path / "dcp", max_to_keep=2)
    for step in (5, 6, 7):
        target = ckpt_mod.save_state_dcp(port_st, manager, step)
    assert not (dist.is_available() and dist.is_initialized())
    manager.wait_until_finished()
    assert manager.all_steps() == [6, 7] and manager.latest_step() == 7
    assert (target / ".done").exists() and not manager.step_dir(5).exists()
    via_dcp = ckpt_mod.restore_state_dcp(manager, config=PORT.cfg(), device="cpu")
    via_npz = restore_state(npz_target, PORT.cfg(), device="cpu")
    a, b = ckpt_mod.state_arrays(via_dcp), ckpt_mod.state_arrays(via_npz)
    assert list(a) == list(b)
    for key in b:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
        assert a[key].tobytes() == b[key].tobytes(), key
    assert a["delta_log.digest"].dtype == np.uint32
    assert ckpt_mod.host_metadata(via_dcp) == ckpt_mod.host_metadata(via_npz)
    assert_same(fingerprint(port_st), fingerprint(via_dcp))
    assert not any("orbax" in name for name in ckpt_mod.__all__)
    with pytest.raises(FileNotFoundError):
        ckpt_mod.restore_state_dcp(ckpt_mod.open_checkpoint_manager(tmp_path / "empty"),
                                   device="cpu")
