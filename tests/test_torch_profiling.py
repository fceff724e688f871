"""The port's profiling hooks (`observability.profiling`), on the CPU.

Counterparts of the reference's profiling cases (`tests/unit/test_api.py`
`/debug/profile`, the spans of `tests/unit/test_metrics.py`), on
`torch.profiler`: a capture writes a Chrome trace that names the `hv.`
ranges, a capture window refuses with `busy` or `active` and never
starts a second profiler, spans cost nothing without a capture, and the
device-plane probe returns at once on the CPU.
"""

from __future__ import annotations

import json
import subprocess
import threading

import numpy as np
import pytest
import torch

from hypervisor_tpu_torch.config import HypervisorConfig, TableCapacity
from hypervisor_tpu_torch.models import SessionConfig
from hypervisor_tpu_torch.observability import profiling
from hypervisor_tpu_torch.state import HypervisorState


def small_state():
    cap = TableCapacity(max_agents=128, max_sessions=32, max_vouch_edges=32, max_sagas=8,
                        delta_log_capacity=256, event_log_capacity=32, trace_log_capacity=64)
    return HypervisorState(HypervisorConfig(capacity=cap), device="cpu")


def wave(st, rnd: int):
    slots = st.create_sessions_batch([f"prof:{rnd}:{i}" for i in range(4)],
                                     SessionConfig(min_sigma_eff=0.0))
    st.run_governance_wave(slots, [f"did:prof:{rnd}:{i}" for i in range(4)], slots.copy(),
                           np.full(4, 0.8, np.float32), np.zeros((1, 4, 16), np.uint32),
                           float(rnd))


def names_in(path) -> set:
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_capture_writes_a_trace_naming_the_wave_ranges(tmp_path):
    st = small_state()
    with profiling.capture(str(tmp_path)):
        assert profiling.is_active()
        wave(st, 0)
    assert not profiling.is_active()
    traces = sorted(tmp_path.glob("hv_trace.*.json"))
    assert len(traces) == 1
    names = names_in(traces[0])
    assert "hv.governance_wave" in names
    assert {"hv.admission_wave", "hv.session_fsm", "hv.delta_chain", "hv.epilogue"} <= names


def test_nested_capture_is_a_noop_and_start_is_idempotent(tmp_path):
    assert profiling.start(str(tmp_path / "a"))
    try:
        assert not profiling.start(str(tmp_path / "b"))
        with profiling.capture(str(tmp_path / "c")):
            torch.ones(3) + 1
        assert profiling.is_active()
    finally:
        path = profiling.stop()
    assert path is not None and path.startswith(str(tmp_path / "a"))
    assert profiling.stop() is None
    assert not (tmp_path / "b").exists() and not (tmp_path / "c").exists()


def test_capture_window_writes_a_trace_naming_an_hv_span(tmp_path):
    out = profiling.capture_window(str(tmp_path), 0.05)
    assert out["status"] == "captured" and out["dir"] == str(tmp_path)
    assert out["duration_s"] == 0.05
    assert "hv.profile_window" in names_in(out["trace"])


def test_capture_window_clamps_its_duration(tmp_path):
    assert profiling.capture_window(str(tmp_path), 0.0)["duration_s"] == 0.001
    assert profiling.capture_window(str(tmp_path), -5)["duration_s"] == 0.001


def test_capture_window_refuses_active_while_a_manual_trace_runs(tmp_path):
    assert profiling.start(str(tmp_path / "manual"))
    try:
        out = profiling.capture_window(str(tmp_path / "window"), 0.01)
    finally:
        profiling.stop()
    assert out["status"] == "refused" and out["reason"] == "active"


def test_capture_window_refuses_active_under_another_profiler(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = profiling.capture_window(str(tmp_path), 0.01)
        assert not profiling.start(str(tmp_path / "second"))
    assert out["status"] == "refused" and out["reason"] == "active"
    assert not profiling.is_active()


def test_capture_window_refuses_busy_while_a_window_hangs(tmp_path, monkeypatch):
    release = threading.Event()
    hung = threading.Thread(target=release.wait, daemon=True)
    hung.start()
    monkeypatch.setattr(profiling, "_capture_thread", hung)
    try:
        out = profiling.capture_window(str(tmp_path), 0.01)
    finally:
        release.set()
        hung.join()
    assert out["status"] == "refused" and out["reason"] == "busy"


def test_capture_window_refuses_wedged_when_the_probe_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "probe_device_plane", lambda backend=None: (False, "hung"))
    out = profiling.capture_window(str(tmp_path), 0.01)
    assert out == {"status": "refused", "reason": "wedged", "detail": "hung"}


def test_spans_are_noops_without_a_capture():
    """With no profiler on, a span opens no profiler range (it only
    records its times) and starts no capture."""
    assert not torch.autograd._profiler_enabled()
    assert profiling.current_stage() is None
    with profiling.stage_scope("admission_wave") as outer:
        assert profiling.current_stage() == "admission_wave"
        with profiling.stage_scope("delta_chain") as inner:
            assert profiling.current_stage() == "delta_chain"
            assert inner._rf is None and outer._rf is None
        assert profiling.current_stage() == "admission_wave"
    assert profiling.current_stage() is None
    assert not profiling.is_active()


def test_stage_scope_unwinds_on_a_raise():
    with pytest.raises(ValueError):
        with profiling.stage_scope("session_fsm"):
            raise ValueError("x")
    assert profiling.current_stage() is None


def test_probe_on_the_cpu_spawns_nothing(monkeypatch):
    def no_spawn(*a, **k):
        raise AssertionError("the CPU probe must not spawn a process")

    monkeypatch.setattr(subprocess, "run", no_spawn)
    ok, detail = profiling.probe_device_plane("cpu")
    assert ok and "cpu" in detail


@pytest.mark.parametrize("outcome,ok", [("timeout", False), ("exit1", False), ("exit0", True)])
def test_probe_on_a_card_is_bounded(monkeypatch, outcome, ok):
    seen = {}

    def fake_run(cmd, capture_output, timeout):
        seen.update(cmd=cmd, timeout=timeout)
        if outcome == "timeout":
            raise subprocess.TimeoutExpired(cmd, timeout)
        return subprocess.CompletedProcess(cmd, 0 if outcome == "exit0" else 1)

    monkeypatch.setenv("HV_PROFILE_PROBE_TIMEOUT", "3")
    monkeypatch.setattr(subprocess, "run", fake_run)
    got, detail = profiling.probe_device_plane("cuda")
    assert got is ok and seen["timeout"] == 3.0
    assert "torch.cuda.device_count()" in seen["cmd"][-1]
    if outcome == "timeout":
        assert "hung" in detail
