"""The traffic generator: every input a cell sends, made from `--seed`.

One general generator reads a traffic mix's parameters (a JSON file under
`hvbench/traffic/`) and a configuration's (under `hvbench/configs/`) and
makes the inputs of each call. Every seed gives the same sizes, the same
number of calls a second's worth of work and the same arrivals (closed
loop, back to back); only the random contents differ.

The facade traffic is a copy of `chip_smoke.py`'s `facade_actions` and
`prepare_facade_wave` (lines 700-726 at commit c365212: 10,000 sessions,
vouch edges of bond 0.30 toward the rows the wave's first lanes claim,
sigma 0.5 on those lanes and 0.8 on the rest, random delta bodies, the
standing actors' actions with uniform slots and 10% ring-0 probes),
changed in three ways: the vouchee rows may come from the free list
(`claimed_rows`) as well as from the bump allocator, the contents come
from a pool of `input_pool` draws with the call index folded into each
body (every call's chain differs), and the wave's clock is virtual,
`now_step_s` a call, so the gateway's refills and windows repeat.

The pipeline traffic is `chip_smoke.py`'s `pipeline_inputs("bench")`
(lines 4832-4847): sigma 0.8, all trustworthy, floor 0.60, all active,
with a pool of seeded delta bodies made on the device.

Nothing here imports the program.
"""

from __future__ import annotations

import random

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator for one stream of one seed (any
    non-negative integer, also past 32 bits)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), int(stream)]))


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for a `torch.Generator`, from one stream of one seed."""
    return int(np.random.SeedSequence([int(seed), int(stream)]).generate_state(2, np.uint64)[0]
               >> np.uint64(1))


# ── the facade lifecycle wave ────────────────────────────────────────


class FacadeTraffic:
    """The inputs of every call of a facade-wave cell.

    Call c creates `sessions` sessions, vouches for the first `vouched`
    lanes' rows, and runs one wave of `sessions` joins (one a session,
    sigma `sigma_vouched` on the vouched lanes and `sigma` on the rest),
    `turns` delta bodies a session and `actions` gateway actions by the
    configuration's standing actors, at the virtual time `now(c)`."""

    def __init__(self, config: dict, traffic: dict, seed: int) -> None:
        self.k = int(traffic["sessions"])
        self.vouched = int(traffic["vouched"])
        self.turns = int(traffic["turns"])
        self.n_actions = int(traffic["actions"])
        self.pool = int(traffic["input_pool"])
        self.now_step = float(traffic["now_step_s"])
        self.n_actors = int(config["actors"])
        g = rng(seed, 1)
        self.bodies = g.integers(0, 2**32, (self.pool, self.turns, self.k, 16), dtype=np.uint32)
        self.action_actor = g.integers(0, self.n_actors, (self.pool, self.n_actions),
                                       dtype=np.int64)
        probe = g.uniform(size=(self.pool, self.n_actions)) < float(traffic["probe_share"])
        self.required_rings = np.where(probe, 0, 2).astype(np.int8)
        self.sigma = np.full(self.k, float(traffic["sigma"]), np.float32)
        self.sigma[:self.vouched] = float(traffic["sigma_vouched"])

    def now(self, c: int) -> float:
        return self.now_step * (c + 1)

    def session_ids(self, c: int) -> list:
        return [f"c{c}:s{i}" for i in range(self.k)]

    def dids(self, c: int) -> list:
        return [f"did:c{c}:{i}" for i in range(self.k)]

    def bodies_of(self, c: int) -> np.ndarray:
        """u32[T, K, 16]: pool draw c mod P with c folded into word 0."""
        out = self.bodies[c % self.pool].copy()
        out[:, :, 0] ^= np.uint32(c & 0xFFFFFFFF)
        return out

    def actions_of(self, c: int) -> tuple[np.ndarray, np.ndarray]:
        """(actor index i64[A], required ring i8[A]) of call c."""
        return self.action_actor[c % self.pool], self.required_rings[c % self.pool]


def claimed_rows(next_slot: int, free: list, capacity: int, b_wave: int) -> np.ndarray:
    """The agent rows a wave of `b_wave` lanes will claim, in lane order:
    the bump allocator's next rows while they last, then the free list
    from its end (`HypervisorState._claim_wave_rows`, state.py:773-791 at
    commit c365212), read without claiming them."""
    fresh_n = min(b_wave, capacity - next_slot)
    need = b_wave - fresh_n
    if need > len(free):
        raise RuntimeError(f"the wave needs {need} free agent rows and {len(free)} are free")
    fresh = np.arange(next_slot, next_slot + fresh_n, dtype=np.int64)
    recycled = np.asarray(free[len(free) - need:][::-1], np.int64)
    return np.concatenate([fresh, recycled])


# ── the headline pipeline ────────────────────────────────────────────


class PipelineTraffic:
    """The inputs of a pipeline cell: `pool` batches of `lanes` lanes and
    `turns` delta bodies, made on `device` by one `torch.Generator` call;
    call c sends batch c mod pool."""

    def __init__(self, traffic: dict, seed: int) -> None:
        self.s = int(traffic["lanes"])
        self.turns = int(traffic["turns"])
        self.pool = int(traffic["input_pool"])
        self.sigma = float(traffic["sigma"])
        self.floor = float(traffic["min_sigma_eff"])
        self.seed = seed

    def device_bodies(self, device):
        """int32[pool, T, S, 16] u32 bits on `device`."""
        import torch

        gen = torch.Generator(device=device)
        gen.manual_seed(torch_seed(self.seed, 2))
        words = torch.randint(0, 2**32, (self.pool, self.turns, self.s, 16), dtype=torch.int64,
                              generator=gen, device=device)
        return (words - 2**31).to(torch.int32) ^ torch.tensor(-2**31, dtype=torch.int32,
                                                               device=device)

    def lane_inputs(self) -> dict:
        """The lanes' columns as numpy (the same for every batch)."""
        return {"sigma_raw": np.full(self.s, self.sigma, np.float32),
                "trustworthy": np.ones(self.s, bool),
                "min_sigma_eff": np.full(self.s, self.floor, np.float32),
                "active": np.ones(self.s, bool)}


# ── the seeded sample of answers ─────────────────────────────────────


class Sample:
    """A uniform sample of at most `k` of the calls offered, drawn from
    the seed (reservoir sampling): which calls' answers are compared."""

    def __init__(self, k: int, seed: int) -> None:
        self.k = int(k)
        self.rand = random.Random(int(np.random.SeedSequence([int(seed), 3]).generate_state(1)[0]))
        self.seen = 0
        self.kept: dict[int, object] = {}

    def admit(self, index: int) -> bool:
        """Whether call `index`'s answer is kept; the caller then stores
        it in `kept[index]`. A call admitted later may evict it."""
        self.seen += 1
        if len(self.kept) >= self.k:
            j = self.rand.randrange(self.seen)
            if j >= self.k:
                return False
            del self.kept[sorted(self.kept)[j]]
        self.kept[index] = None
        return True
