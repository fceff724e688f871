"""A configuration, a traffic mix and a per-layer metric are added by new
files alone: a copy of the benchmark with a dummy of each, and entries in
its `BENCHMARK.json`, runs the dummy cell and reports the dummy metric."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

from hvbench.tests.conftest import REPO, make_tiny

SCRIPT = """
import json, sys, time
from pathlib import Path
from hvbench import harness
root = Path.cwd()
bench = harness.load_bench(root)
line, _ = harness.run_cell(bench, "dummy.cell", 5, 0.3, True, "cpu", time.perf_counter(), root)
print(json.dumps({"correct": line["correct"], "metrics": line["metrics"]}))
"""


def test_new_files_add_a_cell_a_mix_and_a_metric(tmp_path):
    bench = make_tiny(tmp_path)
    shutil.copytree(REPO / "hvbench", tmp_path / "hvbench", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("configs", "traffic", "tests", "__pycache__"))
    hv = tmp_path / "hvbench"
    cfg = json.loads((hv / "configs/gov10k.json").read_text())
    (hv / "configs/dummy.json").write_text(json.dumps({**cfg, "name": "dummy", "actors": 32}))
    mix = json.loads((hv / "traffic/wave32.json").read_text())
    (hv / "traffic/dummy_mix.json").write_text(json.dumps({**mix, "sessions": 5, "vouched": 2,
                                                           "actions": 9, "pad_to": [8, 8]}))
    (hv / "metrics/dummy_calls.py").write_text(
        "def read(t):\n    return float(len(t.calls_ms))\n")
    bench["configs"].append({"name": "dummy", "source": "https://example.org/dummy",
                             "file": "hvbench/configs/dummy.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy", "traffic": "dummy_mix",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy_calls", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "entry", "moves": "sessions_per_s",
                               "workloads": ["dummy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600,
                         env={"PYTHONPATH": f"{tmp_path}:{REPO}", "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert got["metrics"]["dummy_calls"]["value"] >= 1
    assert "audit_booking_ms" not in got["metrics"]  # listed for other cells only
