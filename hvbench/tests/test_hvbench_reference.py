"""The plain reference equals the port's CPU path at tiny sizes, for each
traffic: a whole run of each cell on the CPU comes out correct, every
number compared at 0. Its bfloat16 control comes out not correct."""

from __future__ import annotations

import importlib
import time

import pytest

from hvbench import control, harness
from hvbench.reference import FLOAT32
from hvbench.tests.conftest import SEED

CELLS = ("gov10k.wave10k", "gov10k_2m.wave32", "pipeline10k.headline")


@pytest.mark.parametrize("workload", CELLS)
def test_a_cpu_run_of_the_port_is_correct(tiny, workload):
    root, bench = tiny
    line, checks = harness.run_cell(bench, workload, SEED, 0.5, False, "cpu",
                                    time.perf_counter(), root)
    assert line["correct"], checks
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert all(c["value"] == 0 for c in checks.values())
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_the_bfloat16_control_is_not_correct(tiny, workload):
    root, bench = tiny
    _, config, traffic = harness.cell_spec(bench, workload, root)
    mod = importlib.import_module(f"hvbench.drivers.{traffic['driver']}")
    warmup, calls = int(traffic["warmup_calls"]), 12
    rec = control.control_record(mod, config, traffic, SEED, calls, warmup)
    checks, failed = mod.judge(config, traffic, SEED, rec, calls - warmup)
    assert failed and any(c["value"] > c["limit"] for c in checks.values()), checks


@pytest.mark.parametrize("workload", CELLS)
def test_the_float32_reference_in_the_programs_place_is_correct(tiny, workload):
    root, bench = tiny
    _, config, traffic = harness.cell_spec(bench, workload, root)
    mod = importlib.import_module(f"hvbench.drivers.{traffic['driver']}")
    warmup, calls = int(traffic["warmup_calls"]), 12
    rec = control.control_record(mod, config, traffic, SEED, calls, warmup)
    # The same record at float32: only the precision differs from the control's.
    f32 = mod.reference_record(config, traffic, SEED, calls, sorted(rec["kept"]), FLOAT32)
    checks, failed = mod.judge(config, traffic, SEED, f32, calls - warmup)
    assert not failed and all(c["value"] == 0 for c in checks.values()), checks
