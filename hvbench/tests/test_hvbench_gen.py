"""The traffic generator is deterministic from `--seed`, takes seeds past
32 bits, and reads the rows a wave will claim as the state claims them."""

from __future__ import annotations

import json

import numpy as np
import torch

from hvbench import gen
from hvbench.tests.conftest import REPO

CONFIG = json.loads((REPO / "hvbench/configs/gov10k.json").read_text())
WAVE = {**json.loads((REPO / "hvbench/traffic/wave10k.json").read_text()),
        "sessions": 100, "vouched": 10, "actions": 300, "input_pool": 3}
PIPE = {**json.loads((REPO / "hvbench/traffic/headline.json").read_text()),
        "lanes": 50, "input_pool": 3}
BIG = 2**33 + 7


def test_facade_traffic_is_a_function_of_the_seed():
    a, b, c = (gen.FacadeTraffic(CONFIG, WAVE, s) for s in (BIG, BIG, BIG + 1))
    for call in (0, 4):
        assert np.array_equal(a.bodies_of(call).copy(), b.bodies_of(call).copy())
        assert all(np.array_equal(x, y) for x, y in zip(a.actions_of(call), b.actions_of(call)))
        assert a.now(call) == b.now(call)
    assert not np.array_equal(a.bodies_of(1).copy(), c.bodies_of(1).copy())
    assert not np.array_equal(a.bodies_of(0).copy(), a.bodies_of(WAVE["input_pool"]).copy())


def test_facade_traffic_keeps_sizes_across_seeds():
    for s in (0, 1, BIG):
        g = gen.FacadeTraffic(CONFIG, WAVE, s)
        assert g.bodies_of(2).shape == (3, 100, 16)
        assert g.actions_of(2)[0].shape == (300,)
        assert (g.sigma[:10] == np.float32(0.5)).all() and (g.sigma[10:] == np.float32(0.8)).all()


def test_pipeline_bodies_are_a_function_of_the_seed():
    a, b, c = (gen.PipelineTraffic(PIPE, s).device_bodies(torch.device("cpu"))
               for s in (BIG, BIG, 3))
    assert a.shape == (3, 3, 50, 16) and a.dtype == torch.int32
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_sample_is_seeded_and_bounded():
    def draw(seed):
        s = gen.Sample(5, seed)
        for i in range(200):
            if s.admit(i):
                s.kept[i] = i
        return sorted(s.kept)

    assert draw(BIG) == draw(BIG) and len(draw(BIG)) == 5
    assert draw(BIG) != draw(BIG + 1)


def test_claimed_rows_are_the_rows_the_state_claims():
    from hypervisor_tpu_torch.config import HypervisorConfig, TableCapacity
    from hypervisor_tpu_torch.state import HypervisorState

    st = HypervisorState(HypervisorConfig(capacity=TableCapacity(max_agents=40)), device="cpu")
    for b in (16, 16, 16, 8):
        want = gen.claimed_rows(st._next_agent_slot, st._free_agent_slots, 40, b)
        got = st._claim_wave_rows(b)
        assert np.array_equal(want, got)
        st._free_agent_slots.extend(got.tolist())
