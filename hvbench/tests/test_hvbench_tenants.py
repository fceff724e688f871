"""The tenant arena's cell at a tiny size on the CPU: a sound run is
correct and its traced run reads the cell's metrics, the bfloat16 control
fails it, and its reference is the solo facade reference tenant by
tenant."""

from __future__ import annotations

import json
import time
import types

import numpy as np
import pytest

from hvbench import control, harness
from hvbench.drivers import tenant_wave
from hvbench.reference import FLOAT32, facade
from hvbench.reference import tenants as tenants_ref
from hvbench.tests.conftest import SEED, make_tiny

SHARES = [7, 3, 2, 1]
VOUCHED = [2, 1, 1, 0]


@pytest.fixture(scope="module")
def tiny_tenants(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout_tenants")
    bench = make_tiny(root)
    cfg = root / "hvbench/configs/tenants8.json"
    c = json.loads(cfg.read_text())
    c.update(tenants=len(SHARES), actors=8)
    c["capacity"].update(max_agents=8 + 24, max_sessions=1024, max_vouch_edges=64,
                         max_sagas=16, max_elevations=16, delta_log_capacity=48,
                         event_log_capacity=64, trace_log_capacity=64)
    cfg.write_text(json.dumps(c))
    f = root / "hvbench/traffic/arena.json"
    t = json.loads(f.read_text())
    t.update(tenant_sessions=SHARES, tenant_vouched=VOUCHED, bucket=8, warmup_calls=2,
             profile_calls=1, check_calls=3, input_pool=4)
    f.write_text(json.dumps(t))
    return root, bench, c, t


def test_a_sound_run_is_correct_and_traced_reads_the_cell_metrics(tiny_tenants):
    root, bench, _, _ = tiny_tenants
    line, checks = harness.run_cell(bench, "tenants8.arena", SEED, 0.5, False, "cpu",
                                    time.perf_counter(), root)
    assert line["correct"], checks
    line, checks = harness.run_cell(bench, "tenants8.arena", SEED + 1, 0.5, True, "cpu",
                                    time.perf_counter(), root)
    assert line["correct"], checks
    assert {"tenant_sync_ms", "tenant_dispatch_ms", "staging_ms", "audit_booking_ms",
            "call_ms_p95"} <= set(line["metrics"])
    # No device trace on the CPU: the device readers find nothing.
    assert "tenant_wave_roofline" not in line["metrics"]


def test_the_bfloat16_control_fails_the_cell(tiny_tenants):
    _, _, config, traffic = tiny_tenants
    rec = control.control_record(tenant_wave, config, traffic, SEED, 8, 2)
    checks, failed = tenant_wave.judge(config, traffic, SEED, rec, 6)
    assert not all(v["value"] <= v["limit"] for v in checks.values())
    assert checks["lanes"]["value"] > 0 and failed


def test_the_reference_is_the_solo_facade_reference_tenant_by_tenant(tiny_tenants):
    _, _, config, traffic = tiny_tenants
    g = tenant_wave.TenantTraffic(config, traffic, SEED)
    for c in range(3):
        got = tenants_ref.call_answers(config, traffic, g, c, FLOAT32)
        for t in range(g.n):
            solo = types.SimpleNamespace(sigma=g.sigma[t], now=g.now,
                                         bodies_of=lambda c, t=t: g.bodies_of(t, c))
            want = facade.call_answers(config, {**traffic, "vouched": VOUCHED[t]}, solo, c,
                                       FLOAT32)
            for f in ("status", "ring", "sigma_eff", "saga_step_state", "npart",
                      "session_state", "fsm_error", "terminated_at", "chain", "merkle_root"):
                np.testing.assert_array_equal(got[t][f], want[f], err_msg=f"{c} {t} {f}")
            assert got[t]["released"] == want["released"] == VOUCHED[t]
            assert got[t]["delta_cursor"] == (c + 1) * SHARES[t] * g.turns
