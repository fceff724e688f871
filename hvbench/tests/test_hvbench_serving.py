"""The serving cell at a tiny size on the CPU: a sound run is correct and
reports the layers' metrics, its bfloat16 control is not (judged in
place and through `reference_record`, as `hvbench.control` runs it), and
a run with the front door broken underneath is not: a gateway verdict, a
lifecycle's Merkle root, a join's status, a shed request, an accepted
ticket never served."""

from __future__ import annotations

import json
import time

import pytest

from hvbench import control, gen, harness
from hvbench.drivers import serving
from hvbench.reference import BFLOAT16
from hvbench.tests.conftest import SEED, make_tiny
from hypervisor_tpu_torch.serving.front_door import FrontDoor
from hypervisor_tpu_torch.state import HypervisorState


@pytest.fixture(scope="module")
def tiny_serving(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout_serving")
    bench = make_tiny(root)
    cfg = root / "hvbench/configs/gov10k.json"
    c = json.loads(cfg.read_text())
    c["capacity"].update(max_agents=2048, max_sessions=1 << 14, max_sagas=2048,
                         delta_log_capacity=2048)
    cfg.write_text(json.dumps(c))
    f = root / "hvbench/traffic/serving.json"
    t = json.loads(f.read_text())
    t.update(sessions_per_call=96, warmup_calls=1, profile_calls=1, check_calls=3)
    f.write_text(json.dumps(t))
    return root, bench


def run(tiny_serving, trace=False):
    root, bench = tiny_serving
    return harness.run_cell(bench, "gov10k.serving", SEED, 1.0, trace, "cpu",
                            time.perf_counter(), root)


def test_a_sound_run_is_correct_and_its_control_is_not(tiny_serving, monkeypatch):
    records = []
    judge = serving.judge

    def keep_record(config, traffic, seed, rec, window_calls):
        records.append((config, traffic, seed, rec, window_calls))
        return judge(config, traffic, seed, rec, window_calls)
    monkeypatch.setattr(serving, "judge", keep_record)
    line, checks = run(tiny_serving, trace=True)
    assert line["correct"], checks
    assert checks["shed"]["value"] == checks["unresolved"]["value"] == 0
    # The host-clock layers; the device's (`device_ms`, `kernel_roofline`)
    # come from a card's trace.
    assert {"call_ms_p95", "audit_booking_ms", "staging_ms", "dispatch_ms",
            "gateway_ms"} <= set(line["metrics"])
    assert line["metrics"]["dispatch_ms"]["value"] > 0
    config, traffic, seed, rec, n = records[0]
    assert harness.model_seconds(serving.Driver(config, traffic, seed, "cpu").roofline_work()) > 0
    bf16, _ = judge(config, traffic, seed, rec, n, prec=BFLOAT16)
    assert bf16["lifecycles"]["value"] > 0, bf16


def test_the_control_record_is_not_correct_and_float32_is(tiny_serving):
    root, bench = tiny_serving
    _, config, traffic = harness.cell_spec(bench, "gov10k.serving", root)
    warmup = int(traffic["warmup_calls"])
    calls = warmup + 4
    rec = control.control_record(serving, config, traffic, SEED, calls, warmup)
    checks, failed = serving.judge(config, traffic, SEED, rec, calls - warmup)
    assert checks["lifecycles"]["value"] > 0 and failed, checks
    sample = gen.Sample(int(traffic["check_calls"]), SEED)
    for c in range(warmup, calls):
        sample.admit(c)
    rec = serving.reference_record(config, traffic, SEED, calls, sorted(sample.kept),
                                   serving.FLOAT32)
    checks, _ = serving.judge(config, traffic, SEED, rec, calls - warmup)
    assert all(v["value"] == 0 for v in checks.values()), checks


def flipped_verdict(monkeypatch):
    check = HypervisorState.check_actions_wave

    def flip(self, *args, **kwargs):
        r = check(self, *args, **kwargs)
        v = r.verdict.clone()
        v[0] = 4 if int(v[0]) == 0 else 0
        return r._replace(verdict=v)
    monkeypatch.setattr(HypervisorState, "check_actions_wave", flip)


def altered_root(monkeypatch):
    wave = HypervisorState.run_governance_wave

    def alter(self, *args, **kwargs):
        r = wave(self, *args, **kwargs)
        root = r.merkle_root.clone()
        root[0, 0] ^= 1
        return r._replace(merkle_root=root)
    monkeypatch.setattr(HypervisorState, "run_governance_wave", alter)


def refused_join(monkeypatch):
    flush = HypervisorState.flush_joins

    def refuse(self, *args, **kwargs):
        out = flush(self, *args, **kwargs)
        for key in list(self.last_join_results)[:1]:
            self.last_join_results[key] = 1
        return out
    monkeypatch.setattr(HypervisorState, "flush_joins", refuse)


def shed_action(monkeypatch):
    submit = FrontDoor.submit_action
    seen = []

    def shed(self, *args, now=None, **kwargs):
        seen.append(1)
        if len(seen) % 5 == 0:
            return self._refuse("queue_full", "planted", "action", now)
        return submit(self, *args, now=now, **kwargs)
    monkeypatch.setattr(FrontDoor, "submit_action", shed)


def lost_termination(monkeypatch):
    accept = FrontDoor._accept
    seen = []

    def lose(self, queue, ticket):
        if queue == "terminate":
            seen.append(1)
            if len(seen) == 3:
                return ticket  # handed back, never queued
        return accept(self, queue, ticket)
    monkeypatch.setattr(FrontDoor, "_accept", lose)


@pytest.mark.parametrize("fault", [flipped_verdict, altered_root, refused_join, shed_action,
                                   lost_termination])
def test_a_broken_front_door_is_not_correct(tiny_serving, monkeypatch, fault):
    fault(monkeypatch)
    line, checks = run(tiny_serving)
    assert not line["correct"], checks
    if fault in (shed_action, lost_termination):
        name = "shed" if fault is shed_action else "unresolved"
        assert checks[name]["value"] > 0, checks
        assert all(v["value"] == 0 for k, v in checks.items() if k != name), checks
