"""The command's contract on a machine without a card, and the check that
no run loads JAX or the JAX package."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from hvbench import harness
from hvbench.run import forbidden_modules
from hvbench.tests.conftest import REPO, SEED

ARGS = ["-m", "hvbench.run", "--workload", "pipeline10k.headline", "--seed", str(SEED),
        "--seconds", "1", "--trace", "0"]


def clean_env(tmp_path) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env.update(CUDA_VISIBLE_DEVICES="", HOME=str(tmp_path))
    return env


def test_a_run_without_a_card_exits_non_zero_and_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, *ARGS], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env=clean_env(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_a_checkout_of_only_the_benchmark_exits_non_zero(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "hvbench", tmp_path / "hvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {**clean_env(tmp_path), "PYTHONPATH": str(tmp_path)}
    out = subprocess.run([sys.executable, *ARGS], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names():
    assert forbidden_modules(["hypervisor_tpu_torch", "hypervisor_tpu_torch.state",
                              "jaxtyping", "flax_like", "numpy"]) == []
    assert forbidden_modules(["hypervisor_tpu.state", "jax.numpy", "jaxlib", "flax.linen",
                              "torch"]) == ["flax", "hypervisor_tpu", "jax", "jaxlib"]


SCRIPT = """
import json, sys, time
from pathlib import Path
from hvbench import harness
from hvbench.run import forbidden_modules
root = Path(sys.argv[1])
line, _ = harness.run_cell(harness.load_bench(root), sys.argv[2], 3, 0.3, False, "cpu",
                           time.perf_counter(), root)
print(json.dumps({"correct": line["correct"], "bad": forbidden_modules(sys.modules)}))
"""


@pytest.mark.parametrize("workload", ("gov10k_2m.wave32", "pipeline10k.headline"))
def test_a_run_loads_no_jax(tiny, tmp_path, workload):
    root, _ = tiny
    env = {**clean_env(tmp_path), "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(root), workload], cwd=REPO,
                         capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "bad": []}


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    code = ("import sys, hvbench.reference.facade, hvbench.reference.pipeline; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'hypervisor_tpu', 'hypervisor_tpu_torch', 'torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={**clean_env(tmp_path), "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.chip
def test_one_short_run_on_the_card_is_correct(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    t0 = time.perf_counter()
    bench = harness.load_bench(REPO)
    line, checks = harness.run_cell(bench, "pipeline10k.headline", SEED, 2.0, False, "cuda",
                                    t0, REPO)
    assert line["correct"], checks
    assert line["device"]["platform"] == "gpu"
