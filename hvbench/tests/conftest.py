"""Fixtures of the benchmark's CPU tests: a checkout of tiny cells.

`tiny` is a directory laid out as a checkout (`BENCHMARK.json`,
`hvbench/configs`, `hvbench/traffic`, `hvbench/kernels`) whose cells keep
the real cells' names and shapes of traffic at sizes the CPU runs in
seconds: 64 actors, waves of 12 sessions padded to 16, a DeltaLog of 128
rows (it wraps from the fourth call), pipelines of 40 lanes.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
SEED = 2**31 + 12_345


def make_tiny(root: Path, delta_log: int = 128) -> dict:
    (root / "hvbench").mkdir(parents=True, exist_ok=True)
    for d in ("configs", "traffic", "kernels"):
        shutil.copytree(REPO / "hvbench" / d, root / "hvbench" / d, dirs_exist_ok=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name in ("gov10k", "gov10k_2m"):
        cfg = root / f"hvbench/configs/{name}.json"
        gov = json.loads(cfg.read_text())
        gov.update(actors=64, capacity=dict(
            max_agents=64 + 48, max_sessions=4096, max_vouch_edges=256, max_sagas=64,
            max_steps_per_saga=16, max_elevations=64, delta_log_capacity=delta_log,
            event_log_capacity=256, trace_log_capacity=256))
        cfg.write_text(json.dumps(gov))
    for name in ("wave10k", "wave32"):
        f = root / f"hvbench/traffic/{name}.json"
        t = json.loads(f.read_text())
        t.update(sessions=12, vouched=3, actions=40, pad_to=[16, 16], warmup_calls=2,
                 profile_calls=2, check_calls=3, input_pool=4)
        f.write_text(json.dumps(t))
    f = root / "hvbench/traffic/headline.json"
    t = json.loads(f.read_text())
    t.update(lanes=40, warmup_calls=1, profile_calls=2, check_calls=3, input_pool=4)
    f.write_text(json.dumps(t))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    return root, make_tiny(root)


@pytest.fixture(scope="session")
def tiny_unwrapped(tmp_path_factory):
    """The tiny cells with a DeltaLog that never wraps in a short run: a
    wave that leaves sessions unarchived is then judged, where a wrap
    would make the program refuse the wave."""
    root = tmp_path_factory.mktemp("checkout_unwrapped")
    return root, make_tiny(root, delta_log=65_536)
