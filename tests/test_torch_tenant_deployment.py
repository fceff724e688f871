"""The tenant deployment on the port, on the CPU: the tenant arena's
batched wave held to the benchmark's plain per-tenant reference
(`hvbench/reference/tenants.py`), the cell's judge, and the arena's spans
and counters.

* a small skewed arena (4 tenants of 7 / 3 / 2 / 1 sessions a call,
  bucket 8, 3 turns, vouched lanes, DeltaLogs that wrap inside the test)
  through the benchmark's driver, `TenantArena.create_sessions_batch` ->
  `add_vouch` -> `governance_wave_batch` -> `free_edge_rows`: over
  several calls each tenant's lanes, sessions, chains, roots, released
  count, frontier roots, audit index and DeltaLog cursor equal its own
  reference bit for bit;
* the `tenants8.arena` cell at a tiny size through the harness comes out
  correct;
* a record with one tenant's root flipped fails the judge, and so does a
  record with two tenants' answers swapped;
* a wave records the spans `tenant_sync`, `tenant_staging` and
  `tenant_fanout`, and the counters `tenant.lanes` (the real lanes) and
  `tenant.padded_lanes` (T x bucket), `tenant.commits` and
  `tenant.copied_back`.
"""

from __future__ import annotations

import copy
import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest

from hvbench import harness
from hvbench.drivers import tenant_wave
from hvbench.reference import FLOAT32
from hvbench.reference import tenants as tenants_ref
from hypervisor_tpu_torch.observability import profiling

REPO = Path(__file__).resolve().parents[1]
SHARES = [7, 3, 2, 1]
VOUCHED = [2, 1, 1, 0]
BUCKET = 8
DELTA_LOG = 48  # tenant 0 appends 21 rows a call: its log wraps from the third call
SEED = 2**31 + 28


def cell() -> tuple[dict, dict]:
    config = json.loads((REPO / "hvbench/configs/tenants8.json").read_text())
    traffic = json.loads((REPO / "hvbench/traffic/arena.json").read_text())
    config.update(tenants=len(SHARES), actors=8)
    config["capacity"].update(max_agents=8 + 3 * BUCKET, max_sessions=512, max_vouch_edges=64,
                              max_sagas=16, max_elevations=16, delta_log_capacity=DELTA_LOG,
                              event_log_capacity=64, trace_log_capacity=64)
    traffic.update(tenant_sessions=SHARES, tenant_vouched=VOUCHED, bucket=BUCKET,
                   warmup_calls=1, profile_calls=1, check_calls=3, input_pool=4)
    return config, traffic


@pytest.fixture(scope="module")
def run():
    """Six calls of the tiny cell, every call kept, then collected."""
    config, traffic = cell()
    drv = tenant_wave.Driver(config, traffic, SEED, "cpu")
    drv.setup()
    kept = {}
    for _ in range(6):
        c = drv.calls
        drv.call()
        kept[c] = drv.keep()
    return config, traffic, drv.collect(kept)


def test_every_tenant_equals_its_reference_over_wrapping_calls(run):
    config, traffic, rec = run
    g = tenant_wave.TenantTraffic(config, traffic, SEED)
    assert sorted(rec["kept"]) == list(range(1, 7))
    for c, got in rec["kept"].items():
        want = tenants_ref.call_answers(config, traffic, g, c, FLOAT32)
        assert len(got) == len(want) == len(SHARES)
        for t, (x, w) in enumerate(zip(got, want)):
            for f in tenant_wave.LANE_FIELDS + tenant_wave.SESSION_FIELDS + ("merkle_root",):
                np.testing.assert_array_equal(x[f], w[f], err_msg=f"call {c} tenant {t} {f}")
            np.testing.assert_array_equal(x["lane_status"], w["status"])
            np.testing.assert_array_equal(x["chain"], w["chain"], err_msg=f"call {c} tenant {t}")
            assert x["released"] == w["released"] == VOUCHED[t]
            assert x["frontier"] == w["frontier"]
            np.testing.assert_array_equal(x["audit_counts"], w["audit_counts"])
            np.testing.assert_array_equal(x["audit_digests"], w["audit_digests"])
            assert x["delta_cursor"] == x["cursor_mirror"] == w["delta_cursor"]
            assert not any(tenant_wave.tenant_checks(x, w).values()), (c, t)
    # Tenant 0's log wrapped more than once, tenant 3's not at all.
    last = rec["kept"][6]
    assert last[0]["delta_cursor"] == 7 * 7 * 3 > 2 * DELTA_LOG
    assert last[3]["delta_cursor"] == 7 * 1 * 3 < DELTA_LOG


def test_the_judge_passes_the_run(run):
    config, traffic, rec = run
    checks, failed = tenant_wave.judge(config, traffic, SEED, rec, window_calls=6)
    assert all(v["value"] == 0 for v in checks.values()), checks
    assert not failed


def flip_root(rec: dict) -> dict:
    bad = copy.deepcopy(rec)
    bad["kept"][3][2]["merkle_root"][0, 5] ^= np.uint32(1)
    return bad


def swap_tenants(rec: dict) -> dict:
    bad = copy.deepcopy(rec)
    tenants = bad["kept"][4]
    tenants[1], tenants[2] = tenants[2], tenants[1]
    return bad


@pytest.mark.parametrize("fault", [flip_root, swap_tenants])
def test_a_planted_fault_fails_the_judge(run, fault):
    config, traffic, rec = run
    checks, failed = tenant_wave.judge(config, traffic, SEED, fault(rec), window_calls=6)
    assert any(v["value"] > v["limit"] for v in checks.values()), checks
    assert failed == ({3} if fault is flip_root else {4})


def test_the_cell_at_a_tiny_size_is_correct(tmp_path):
    for d in ("configs", "traffic", "kernels"):
        shutil.copytree(REPO / "hvbench" / d, tmp_path / "hvbench" / d)
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    config, traffic = cell()
    (tmp_path / "hvbench/configs/tenants8.json").write_text(json.dumps(config))
    (tmp_path / "hvbench/traffic/arena.json").write_text(json.dumps(traffic))
    bench = harness.load_bench(tmp_path)
    line, checks = harness.run_cell(bench, "tenants8.arena", SEED, 0.3, True, "cpu",
                                    time.perf_counter(), tmp_path)
    assert line["correct"], checks
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert {"tenant_sync_ms", "tenant_dispatch_ms", "staging_ms", "audit_booking_ms",
            "call_ms_p95"} <= set(line["metrics"])


def test_a_wave_records_the_arena_spans_and_counters():
    config, traffic = cell()
    drv = tenant_wave.Driver(config, traffic, SEED + 1, "cpu")
    drv.setup()
    profiling.reset_spans()
    drv.call()
    totals = profiling.span_totals()
    spans = {p: v[0] for p, v in totals["spans"].items()}
    # One commit before the batched create, one before the batched wave.
    assert spans["tenant_sync"] == 2
    assert spans["tenant_staging"] == spans["tenant_fanout"] == 1
    assert spans["tenant_staging/staging"] == len(SHARES)
    assert spans["tenant_fanout/audit_booking"] == len(SHARES)
    counters = totals["counters"]
    assert counters["tenant.lanes"] == sum(SHARES)
    assert counters["tenant.padded_lanes"] == len(SHARES) * BUCKET
    # The vouches the client wrote into three tenants' lent slices commit
    # in place; nothing was rebound, so nothing is copied back.
    assert counters["tenant.commits"] == sum(1 for v in VOUCHED if v)
    assert counters["tenant.copied_back"] == 0
    drv.collect({})
