"""The headline pipeline, `ops.pipeline.governance_pipeline`.

Set-up makes the traffic's pool of delta-body batches on the device from
the seed (`gen.PipelineTraffic`) and the lanes' columns. A call is one
`governance_pipeline` over batch c mod pool, then
`torch.cuda.synchronize()`. The pipeline keeps no state between calls.
The judge makes the kept calls' batches anew from the seed, so that an
input the program wrote over in place cannot reach the reference.
"""

from __future__ import annotations

import time
from collections import Counter

import numpy as np

from hvbench import gen
from hvbench import work
from hvbench.reference import FLOAT32, Precision, differ
from hvbench.reference import pipeline as ref
from hvbench.trace import maybe_span

LANE_FIELDS = ("ring", "sigma_eff", "session_state", "saga_step_state", "merkle_root", "status")
FIELDS = LANE_FIELDS + ("consensus",)


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, spans=None) -> None:
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.spans = device, spans
        self.gen = gen.PipelineTraffic(traffic, seed)
        self.sessions_per_call = self.gen.s
        self.calls = 0
        self.last = None
        self.setup_stages: dict = {}

    def sync(self) -> None:
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def setup(self) -> None:
        import torch

        from hypervisor_tpu_torch import resolve_device
        from hypervisor_tpu_torch.config import TrustConfig
        from hypervisor_tpu_torch.ops import pipeline

        self.dev = resolve_device(self.device)
        self.fn = pipeline.governance_pipeline
        self.trust = TrustConfig(**self.config["trust"])
        t = time.perf_counter()
        self.bodies = self.gen.device_bodies(self.dev)
        self.lanes = {k: torch.from_numpy(v).to(self.dev)
                      for k, v in self.gen.lane_inputs().items()}
        self.sync()
        self.setup_stages["inputs"] = time.perf_counter() - t
        t = time.perf_counter()
        for _ in range(int(self.traffic["warmup_calls"])):
            self.call()
        self.sync()
        self.setup_stages["warmup_calls"] = time.perf_counter() - t

    def call(self) -> float:
        c = self.calls
        batch = self.bodies[c % self.gen.pool]
        t = time.perf_counter_ns()
        with maybe_span(self.spans, "dispatch"):
            result = self.fn(delta_bodies=batch, trust=self.trust, **self.lanes)
        self.sync()
        ms = (time.perf_counter_ns() - t) / 1e6
        self.last = result._asdict()
        self.calls += 1
        return ms

    def keep(self) -> dict:
        return self.last

    def roofline_work(self) -> list:
        s, t = self.gen.s, self.gen.turns
        pairs, dup = work.tree_pairs([t] * s, 1 << max(0, (t - 1).bit_length()))
        return [("chain_digests", dict(turns=t, lanes=s)),
                ("tree_roots", dict(lanes=s, leaves=s * t, pairs=pairs, dup_pairs=dup))]

    def collect(self, kept: dict) -> dict:
        out = {}
        for c, ans in kept.items():
            h = {f: ans[f].cpu().numpy() for f in FIELDS}
            h["merkle_root"] = h["merkle_root"].view(np.uint32)
            out[c] = h
        self.bodies = self.lanes = self.last = None
        return {"calls": self.calls, "kept": out, "device": self.dev.type}


def reference_record(config: dict, traffic: dict, seed: int, calls: int, kept_calls,
                     prec: Precision) -> dict:
    """The record a program computing at `prec` would leave: the control
    puts it in the program's place, on the device a run uses (the card
    where there is one)."""
    import torch

    g = gen.PipelineTraffic(traffic, seed)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    bodies = batch_bodies(g, device, kept_calls)
    lanes = g.lane_inputs()
    kept = {c: ref.answers(lanes, bodies[c % g.pool], config["trust"], prec) for c in kept_calls}
    return {"calls": calls, "kept": kept, "device": device}


def batch_bodies(g: gen.PipelineTraffic, device: str, calls) -> dict:
    """{batch: u32[T, S, 16]} of the calls' batches, made anew from the
    seed by the generator of the device the run used."""
    import torch

    pool = g.device_bodies(torch.device(device))
    return {j: pool[j].cpu().numpy().view(np.uint32) for j in sorted({c % g.pool for c in calls})}


def judge(config: dict, traffic: dict, seed: int, rec: dict, window_calls: int):
    g = gen.PipelineTraffic(traffic, seed)
    lanes = g.lane_inputs()
    bodies = batch_bodies(g, rec["device"], rec["kept"])
    bad, failed = Counter(), set()
    for c, got in rec["kept"].items():
        want = ref.answers(lanes, bodies[c % g.pool], config["trust"], FLOAT32)
        d = np.zeros(g.s, bool)
        for f in LANE_FIELDS:
            d |= differ(got[f], want[f])
        cons = differ(got["consensus"], want["consensus"])
        bad["lanes"] += int(d.sum())
        bad["consensus_sums"] += int(cons.sum())
        if d.any() or cons.any():
            failed.add(c)
    bad["missing_calls"] = max(0, min(int(traffic["check_calls"]), window_calls)
                               - len(rec["kept"]))
    return ({n: {"value": int(bad[n]), "limit": 0}
             for n in ("lanes", "consensus_sums", "missing_calls")}, failed)
