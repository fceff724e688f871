"""The port's roofline observatory, on the CPU.

The reference models each jitted program with XLA's cost analysis; the
port counts each watched program's first dispatch of a signature (aten
ops under a dispatch mode, kernels through `kernels.work.kernel_work`),
under the reference's names, series and knobs (ROADMAP C.2). So:

* the host-only functions are held to the reference's at tolerance 0 on
  the same inputs: `_shift_of`, `publish`'s join arithmetic given the
  same `ProgramCost`, stage walls and phase model, `floor_model`,
  `summary`'s layout and `STAGE_OF_PROGRAM`;
* the count of a small facade wave, with its phase split, is checked on
  its own terms;
* `kernel_work` at `chip_smoke.py`'s kernel-timing shapes is pinned to
  the numbers its inline model gave before the model moved into the
  package;
* every series published is named.

Each case swaps a fresh registry into the module(s) it drives, so the
process-global registry other tests count into is left alone.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from hypervisor_tpu.observability import metrics as ref_mp
from hypervisor_tpu.observability import roofline as ref_roofline
from hypervisor_tpu_torch.config import DEFAULT_CONFIG, HypervisorConfig, TableCapacity
from hypervisor_tpu_torch.kernels import work
from hypervisor_tpu_torch.models import SessionConfig
from hypervisor_tpu_torch.observability import health as port_health
from hypervisor_tpu_torch.observability import metrics as port_mp
from hypervisor_tpu_torch.observability import profiling
from hypervisor_tpu_torch.observability import roofline
from hypervisor_tpu_torch.observability.attribution import HV_PHASES
from hypervisor_tpu_torch.state import HypervisorState

#: Peaks and floors set the same on both packages for the join cases.
ENV = {"HV_ROOFLINE": "1", "HV_ROOFLINE_PEAK_BW_GBS": "64", "HV_ROOFLINE_PEAK_FLOPS_G": "2000",
       "HV_ROOFLINE_PEAK_INT_OPS_G": "2000", "HV_ROOFLINE_DISPATCH_FLOOR_US": "30",
       "HV_ROOFLINE_MIN_SAMPLES": "2", "HV_ROOFLINE_SHIFT_TOL": "0.1"}
#: The wave's walls, in µs, sampled into both host planes.
WALLS = (180.0, 240.0, 300.0)
SHARES = {"admission": 0.2, "fsm_saga": 0.1, "audit": 0.4, "gateway": 0.0, "epilogue": 0.3}
PHASE_BYTES = {"admission": 4_096, "fsm_saga": 1_024, "audit": 16_384, "gateway": 0,
               "epilogue": 2_048, "glue": 512}


@pytest.fixture
def fresh(monkeypatch):
    """Fresh registries in both modules and the same knobs."""
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(ref_roofline, "_REGISTRY", ref_roofline.RooflineRegistry())
    monkeypatch.setattr(roofline, "_REGISTRY", roofline.RooflineRegistry())
    return ref_roofline._REGISTRY, roofline._REGISTRY


def cost(mod, **kw):
    base = dict(program="governance_wave", sig_key="k", signature=(("a", "f32[4]"),),
                captured_at=0.0, compile_wall_ms=1.0, flops=1.0e5, bytes_accessed=2.5e6)
    base.update(kw)
    return mod.ProgramCost(**base)


def ref_metrics():
    return ref_mp.Metrics()


def port_metrics():
    return port_mp.Metrics(device="cpu")


def seeded(reg, mod, entry, phase_bytes=None, shares=None):
    """Land `entry` in `reg` (as a resolved model) with a phase model and
    shares."""
    with reg._lock:
        reg._models.setdefault(entry.program, {})[entry.sig_key] = entry
        if phase_bytes is not None:
            reg._phase_models[entry.program] = dict(phase_bytes)
    reg.set_phase_shares(shares)


def walls(metrics, mp, samples=WALLS, stage="governance_wave"):
    for us in samples:
        metrics.observe_us(mp.STAGE_LATENCY[stage], us)


def roofline_gauges(snap, mp) -> dict:
    rows = {}
    for name, handles in (("bytes", mp.ROOFLINE_MODELED_BYTES), ("flops", mp.ROOFLINE_MODELED_FLOPS),
                          ("bw", mp.ROOFLINE_ACHIEVED_BW_FRAC), ("mfu", mp.ROOFLINE_MFU),
                          ("phase_bytes", mp.ROOFLINE_PHASE_BYTES),
                          ("phase_flops", mp.ROOFLINE_PHASE_FLOPS),
                          ("phase_bw", mp.ROOFLINE_PHASE_BW_FRAC),
                          ("phase_mfu", mp.ROOFLINE_PHASE_MFU)):
        for key, h in handles.items():
            rows[(name, key)] = float(snap.gauges[h.index])
    rows["distance"] = float(snap.gauges[mp.ROOFLINE_FLOOR_DISTANCE.index])
    return rows


# ── host functions against the reference ─────────────────────────────


@pytest.mark.parametrize("prev,cur", [
    (None, 2.0e6), (2.0e6, 2.1e6), (2.0e6, 2.5e6), (2.0e6, 1.0e6), (0.0, 1.0e6), (2.0e6, None),
])
def test_shift_of_matches_reference(fresh, prev, cur):
    def shift(mod):
        p = None if prev is None else cost(mod, bytes_accessed=prev)
        return mod.RooflineRegistry._shift_of(p, cost(mod, bytes_accessed=cur, captured_at=5.0))

    assert shift(roofline) == shift(ref_roofline)


@pytest.mark.parametrize("flops", [1.0e5, 0.0])
def test_publish_join_arithmetic_matches_reference(fresh, flops):
    ref_reg, port_reg = fresh
    ref_m, port_m = ref_metrics(), port_metrics()
    for mod, reg, m, mp in ((ref_roofline, ref_reg, ref_m, ref_mp),
                            (roofline, port_reg, port_m, port_mp)):
        entry = cost(mod, flops=flops, **({"int_ops": 0.0} if mod is roofline else {}))
        seeded(reg, mod, entry, PHASE_BYTES, SHARES)
        seeded(reg, mod, cost(mod, program="saga_table_tick", bytes_accessed=1.0e5, flops=flops,
                              **({"int_ops": 0.0} if mod is roofline else {})))
        walls(m, mp)
        walls(m, mp, (40.0, 60.0), "saga_round")
        mod.publish(m)
    want, got = roofline_gauges(ref_m.snapshot(), ref_mp), roofline_gauges(port_m.snapshot(), port_mp)
    assert got == want
    assert want[("bytes", "governance_wave")] == 2.5e6 and want["distance"] > 0


def test_floor_model_matches_reference(fresh):
    for kw in (dict(), dict(bytes_accessed=9.0e7), dict(bytes_accessed=0.0)):
        want = ref_roofline.floor_model(cost(ref_roofline, **kw))
        got = roofline.floor_model(cost(roofline, int_ops=0.0, **kw), "cpu")
        if want is None:
            assert got is None
            continue
        assert {k: got[k] for k in want} == want
        assert got["ops_floor_us"] < got["modeled_floor_us"]


def test_summary_layout_matches_reference(fresh):
    ref_reg, port_reg = fresh
    ref_m, port_m = ref_metrics(), port_metrics()
    outs = []
    for mod, reg, m, mp in ((ref_roofline, ref_reg, ref_m, ref_mp),
                            (roofline, port_reg, port_m, port_mp)):
        seeded(reg, mod, cost(mod), PHASE_BYTES, SHARES)
        walls(m, mp)
        outs.append(mod.summary(m))
    want, got = outs
    assert sorted(got) == sorted(want)
    assert sorted(got["programs"]["governance_wave"]) == sorted(want["programs"]["governance_wave"])
    assert set(want["programs"]["governance_wave"]["model"]) <= set(
        got["programs"]["governance_wave"]["model"])
    assert set(want["peaks"]) <= set(got["peaks"])
    for key in ("headroom", "worst_program", "phases", "hbm", "captures", "pending"):
        assert got[key] == want[key], key
    assert {k: got["floor"][k] for k in want["floor"]} == want["floor"]
    row_keys = ("stage", "wall_p50_us", "achieved_bw_frac", "mfu", "modeled_floor_us", "distance")
    for key in row_keys:
        assert got["programs"]["governance_wave"][key] == want["programs"]["governance_wave"][key]
    json.dumps(got)


def test_stage_of_program_and_vocabularies_match_reference():
    assert roofline.STAGE_OF_PROGRAM == ref_roofline.STAGE_OF_PROGRAM
    assert roofline.PHASE_PROGRAMS == ref_roofline.PHASE_PROGRAMS
    assert roofline.WAVE_PHASES == ref_roofline.WAVE_PHASES == HV_PHASES
    for program, stage in roofline.STAGE_OF_PROGRAM.items():
        assert program in port_mp.ROOFLINE_PROGRAMS and stage in port_mp.STAGE_LATENCY


def test_disabled_observatory_is_a_noop(fresh, monkeypatch):
    monkeypatch.setenv("HV_ROOFLINE", "0")
    m = port_metrics()
    seeded(roofline._REGISTRY, roofline, cost(roofline), PHASE_BYTES, SHARES)
    walls(m, port_mp)
    roofline.publish(m)
    assert not any(roofline_gauges(m.snapshot(), port_mp).values())
    assert roofline.summary(m) == {"enabled": False}
    with roofline.counting() as count:
        torch.ones(4) + 1
    assert count is None


# ── the peaks ────────────────────────────────────────────────────────


@pytest.mark.parametrize("name,known", [("NVIDIA H100 80GB HBM3", True), ("Some Other Card", False)])
def test_cuda_peaks_come_from_the_card_table(monkeypatch, name, known):
    for k in ("HV_ROOFLINE_PEAK_BW_GBS", "HV_ROOFLINE_PEAK_FLOPS_G", "HV_ROOFLINE_PEAK_INT_OPS_G"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: name)
    pk = roofline.peak_rates("cuda")
    if known:
        assert (pk["peak_bw_bytes_s"], pk["peak_flops_s"], pk["peak_int_ops_s"]) == (
            3.35e12, 67e12, 16.75e12)
    else:
        assert pk["peak_bw_bytes_s"] is pk["peak_flops_s"] is pk["peak_int_ops_s"] is None
        assert roofline.floor_model(cost(roofline, int_ops=0.0), "cuda") is None
        monkeypatch.setenv("HV_ROOFLINE_PEAK_BW_GBS", "2000")
        assert roofline.peak_rates("cuda")["peak_bw_bytes_s"] == 2.0e12


def test_cpu_peaks_are_the_reference_nominal_figures(monkeypatch):
    for k in ("HV_ROOFLINE_PEAK_BW_GBS", "HV_ROOFLINE_PEAK_FLOPS_G", "HV_ROOFLINE_PEAK_INT_OPS_G"):
        monkeypatch.delenv(k, raising=False)
    pk, want = roofline.peak_rates("cpu"), ref_roofline.peak_rates("cpu")
    assert {k: pk[k] for k in want} == want
    assert pk["peak_int_ops_s"] == 2.0e12


# ── the count ────────────────────────────────────────────────────────


def small_state():
    cap = TableCapacity(max_agents=256, max_sessions=64, max_vouch_edges=64, max_sagas=8,
                        delta_log_capacity=512, event_log_capacity=64, trace_log_capacity=128)
    return HypervisorState(HypervisorConfig(capacity=cap), device="cpu")


def facade_wave(st, rnd: int, lanes: int = 8):
    slots = st.create_sessions_batch([f"roof:r{rnd}:{i}" for i in range(lanes)],
                                     SessionConfig(min_sigma_eff=0.0))
    st.run_governance_wave(slots, [f"did:roof:r{rnd}:{i}" for i in range(lanes)], slots.copy(),
                           np.full(lanes, 0.8, np.float32), np.zeros((2, lanes, 16), np.uint32),
                           float(rnd), pad_to=(16, 16))


def test_a_facade_wave_is_counted_once_with_its_phase_split(fresh, monkeypatch):
    import hypervisor_tpu_torch.state as state_mod

    # A fresh watch over the wave's entry, so this test's first dispatch
    # is a novel signature whatever earlier tests dispatched.
    monkeypatch.setattr(port_health, "_LOG", port_health._CompileLog())
    monkeypatch.setattr(state_mod, "_WAVE",
                        port_health.CompileWatch("governance_wave", state_mod._WAVE._fn))
    st = small_state()
    facade_wave(st, 0)
    st.metrics_snapshot()
    reg = roofline._REGISTRY
    entry = reg.latest("governance_wave")
    assert entry is not None and entry.bytes_accessed > 0 and entry.ops > 0
    assert entry.kernels == {}  # the CPU takes each kernel's plain version: aten ops
    assert entry.int_ops > 0 and entry.flops > 0
    phases = reg.phase_model("governance_wave")
    for phase in ("admission", "fsm_saga", "audit", "epilogue"):
        assert phases[phase] > 0, phase
    assert phases["gateway"] == 0
    assert sum(phases.values()) == entry.bytes_accessed
    captures = reg.captures
    for rnd in (1, 2):
        facade_wave(st, rnd)
    st.metrics_snapshot()
    assert reg.captures == captures, "a repeated signature was counted again"
    snap = st.metrics_snapshot()
    assert snap.gauges[port_mp.ROOFLINE_MODELED_BYTES["governance_wave"].index] == entry.bytes_accessed
    assert snap.gauges[port_mp.ROOFLINE_ACHIEVED_BW_FRAC["governance_wave"].index] > 0
    out = st.roofline_summary()
    assert out["backend"] == "cpu" and out["hbm"]["tables_total_bytes"] > 0
    assert out["programs"]["governance_wave"]["model"]["bytes_accessed"] == entry.bytes_accessed


def test_kernel_launches_add_their_model_to_every_open_count(fresh):
    with roofline.counting() as outer:
        with profiling.stage_scope("delta_chain"):
            work.note_launch("sha256_words", messages=10, blocks=2)
        with roofline.counting() as inner:
            work.note_launch("chain_digests", turns=3, lanes=4)
    work.note_launch("chain_digests", turns=3, lanes=4)  # no count open: nothing
    sha, chain = work.kernel_work("sha256_words", messages=10, blocks=2), work.kernel_work(
        "chain_digests", turns=3, lanes=4)
    assert outer.kernels == {"sha256_words": 1, "chain_digests": 1}
    assert inner.kernels == {"chain_digests": 1}
    assert outer.bytes == sha[0] + chain[0] and outer.int_ops == sha[1] + chain[1]
    assert outer.phase_bytes["audit"] == sha[0] and outer.phase_bytes["glue"] == chain[0]


def test_the_count_follows_the_op_rules():
    a = torch.arange(1024, dtype=torch.int32)
    idx = torch.tensor([3, 5, 7], dtype=torch.int64)
    with roofline.counting() as c:
        a.view(32, 32)                      # a view: nothing
        torch.empty(4096)                   # no memory touched
    assert c.bytes == 0 and c.ops == 0
    with roofline.counting() as c:
        a[idx]                              # a gather reads what it gathers
    assert c.bytes == idx.numel() * 8 + 2 * 3 * 4
    with roofline.counting() as c:
        a.index_put_((idx,), torch.tensor([1, 2, 3], dtype=torch.int32))
    assert c.bytes == idx.numel() * 8 + 3 * 4 + 3 * 4
    with roofline.counting() as c:
        b = a.to(torch.float32) * 2.0
    assert c.flops == 2 * b.numel() and c.bytes == 1024 * (4 + 4) * 2


def test_the_count_never_breaks_a_dispatch(fresh, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("count failed")

    monkeypatch.setattr(roofline.ProgramCount, "add_op", boom)
    with roofline.counting():
        out = torch.arange(4) * 3
    assert out.tolist() == [0, 3, 6, 9]


def test_shift_events_fan_out_at_the_drain(fresh):
    st = small_state()
    events = []
    st.health.add_listener(lambda kind, payload: events.append((kind, payload)))
    reg = roofline._REGISTRY
    for nbytes in (1.0e6, 2.0e6):
        count = roofline.ProgramCount()
        count.bytes = nbytes
        reg.note_compile("governance_wave", count, detail=(("a", "x"),))
        st.metrics_snapshot()
    assert [k for k, _ in events if k == "roofline_shift"] == ["roofline_shift"]
    shift = dict(events)["roofline_shift"]
    assert shift["prev_bytes"] == 1.0e6 and shift["bytes"] == 2.0e6


def test_every_published_series_is_named(fresh):
    m = port_metrics()
    seeded(roofline._REGISTRY, roofline, cost(roofline, int_ops=5.0e4), PHASE_BYTES, SHARES)
    walls(m, port_mp)
    roofline.publish(m)
    names = {line.split("{")[0].split(" ")[0] for line in m.snapshot().to_prometheus().splitlines()
             if line.startswith("hv_roofline_") and not line.endswith(" 0")
             and not line.endswith(" 0.0")}
    assert names == {"hv_roofline_modeled_bytes", "hv_roofline_modeled_flops",
                     "hv_roofline_achieved_bw_frac", "hv_roofline_mfu",
                     "hv_roofline_floor_distance"}


# ── one model of each kernel's work ──────────────────────────────────

#: `chip_smoke.py`'s inline model before it moved into the package,
#: evaluated at its kernel-timing shapes: 10,000 lanes of 3 deltas, 9,000
#: admitted, 9,500 agent rows written, 65,536 edges, 16,384 agents, 1,000
#: vouched, 30,000 ring rows, a 4,096-message strip of 2 blocks, 8,192
#: sagas of 16 steps and a depth-3 cascade.
PINNED = {
    "contribution_toward": (dict(edges=65_536, agents=16_384), (1245184, 524288)),
    "chain_digests": (dict(turns=3, lanes=10_000), (3200000, 81240000)),
    "tree_roots": (dict(lanes=10_000, leaves=30_000, pairs=30_000, dup_pairs=10_000),
                   (1320000, 116230000)),
    "admission_block": (dict(lanes=10_000, admitted=9_000), (1529000, 400000)),
    "fsm_saga_block": (dict(sessions=10_000, lanes=10_000, edges=65_536, vouched=1_000,
                            agents=16_384, agent_hits=9_500), (710220, 631296)),
    "chain_digests_ring": (dict(turns=3, lanes=10_000, rows=30_000), (6360004, 81240000)),
    "sha256_words": (dict(messages=4_096, blocks=2), (655360, 11292672)),
    "saga_tick_block": (dict(sagas=8_192, steps=16), (794640, 425984)),
    "slash_cascade": (dict(edges=65_536, agents=16_384, depths=3), (1376272, 2949120)),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_kernel_work_pinned_at_the_timing_shapes(name):
    shapes, want = PINNED[name]
    assert work.kernel_work(name, **shapes) == want


def test_kernel_work_join_form_and_tree_pairs():
    # B4's join form: 7,000 lanes on 1,750 sessions, 6,500 admitted.
    assert work.kernel_work("admission_block", lanes=7_000, admitted=6_500, contribution=False,
                            sessions=1_750)[0] == 963_500
    assert work.tree_pairs([3] * 10_000, 4) == (30_000, 10_000)
    assert work.tree_pairs([0, 1, 2, 5], 8) == (1 + 3 + 2 + 1, 1 + 1)
    with pytest.raises(KeyError):
        work.kernel_work("no_such_kernel")
    assert dataclasses.is_dataclass(roofline.ProgramCost)
    assert set(work.PEAKS["NVIDIA H100 80GB HBM3"]) == {"hbm_bytes_s", "f32_ops_s", "int32_ops_s"}
    assert DEFAULT_CONFIG.trust.max_cascade_depth + 1 == 3
