"""Shifting-workload-mix soak: the autopilot's proving ground.

A three-phase open workload (calm -> lifecycle-heavy burst -> settle)
built by concatenating seeded `loadgen.generate_trace` phases on one
virtual timeline. Against a deliberately small STATIC config (narrow
bucket set, shallow queues) the burst sheds `queue_full`; under the
autopilot the grow rule widens the closed bucket set (pre-warming the
new tiles first) and deepens the queues, so the same trace holds
goodput. `run_autopilot_soak` reports both runs:

  * goodput_ratio autopilot vs static (the >= 20% improvement floor),
  * p99 vs the stated smoke SLO (autopilot run),
  * decision count + the ledger's decisions digest,
  * UNPLANNED recompiles after warmup (raw post-warm telemetry minus
    the ledger-bracketed pre-warm compiles — pinned zero) and raw
    counts alongside, so the accounting is honest,
  * digest identity across two replays of the SAME trace + seed (the
    autopilot replay contract).
"""

from __future__ import annotations

from typing import Optional

from hypervisor_tpu_torch.autopilot.rules import AutopilotConfig
from hypervisor_tpu_torch.serving.front_door import ServingConfig
from hypervisor_tpu_torch.serving.loadgen import WorkloadSpec, generate_trace

#: The shifting mix: (phase spec overrides, virtual offset gap). Rates
#: are per-phase arrival intensities; the burst is lifecycle-heavy (the
#: tenant-dense hot class) so the narrow static bucket set saturates.
_PHASES_QUICK = (
    {"rate_hz": 120.0, "duration_s": 0.4, "lifecycle_fraction": 0.6},
    {"rate_hz": 2200.0, "duration_s": 0.6, "lifecycle_fraction": 0.95},
    {"rate_hz": 150.0, "duration_s": 0.4, "lifecycle_fraction": 0.6},
)
_PHASES_FULL = (
    {"rate_hz": 150.0, "duration_s": 0.8, "lifecycle_fraction": 0.6},
    {"rate_hz": 2600.0, "duration_s": 1.0, "lifecycle_fraction": 0.95},
    {"rate_hz": 200.0, "duration_s": 0.8, "lifecycle_fraction": 0.6},
)


def shifting_trace(
    seed: int, quick: bool = False
) -> tuple[list[dict], list[dict]]:
    """Concatenate per-phase seeded traces on one virtual timeline.

    Session/agent ids get a `p<i>:` prefix so phases never collide;
    the result is sorted like any loadgen trace and fully determined by
    (seed, quick). Returns (events, phase specs as dicts).
    """
    phases = _PHASES_QUICK if quick else _PHASES_FULL
    events: list[dict] = []
    offset = 0.0
    specs: list[dict] = []
    for i, overrides in enumerate(phases):
        spec = WorkloadSpec(
            seed=seed + i,
            max_lifetime_s=2.0,
            **overrides,
        )
        specs.append(spec.to_dict())
        for e in generate_trace(spec):
            e2 = dict(e)
            sid = f"p{i}:{e['sid']}"
            e2["t"] = round(e["t"] + offset, 6)
            if "did" in e2:
                e2["did"] = e2["did"].replace(e["sid"], sid)
            e2["sid"] = sid
            events.append(e2)
        offset += spec.duration_s
    events.sort(key=lambda e: (e["t"], e["sid"], e["kind"]))
    return events, specs


def static_config(quick: bool = False) -> ServingConfig:
    """The deliberately narrow baseline the autopilot is scored
    against: two small buckets and SHALLOW queues — the burst phase
    arrives faster per tick than the static depths can absorb, so the
    baseline sheds `queue_full` until the autopilot deepens the queues
    and widens the closed bucket set. Join/action deadlines stay tight
    (the library defaults) so flushes are latency-driven in both runs
    and the comparison isolates the backpressure knobs."""
    return ServingConfig(
        buckets=(4, 8),
        action_queue_depth=32,
        lifecycle_queue_depth=16,
        terminate_queue_depth=64,
        saga_queue_depth=64,
        lifecycle_deadline_s=0.4,
        terminate_deadline_s=0.5,
    )


def run_autopilot_soak(
    seed: int = 17,
    quick: bool = False,
    slo_p99_ms: float = 1500.0,
    tick_s: float = 0.02,
    include_static: bool = True,
    replays: int = 2,
    autopilot_config: Optional[AutopilotConfig] = None,
    device="cuda",
) -> dict:
    """Static vs autopilot on the same shifting trace, double-replayed.

    The reference's `autopilot_soak` row: the goodput improvement, p99
    against the stated SLO, the decisions, zero UNPLANNED recompiles,
    zero invariant violations, bit-identical decision digests across
    replays. Each run builds a fresh `HypervisorState` of the default
    tables on `device` ("cuda" by default; it raises without CUDA).
    """
    from hypervisor_tpu_torch.serving.loadgen import run_soak
    from hypervisor_tpu_torch.state import HypervisorState

    trace, phase_specs = shifting_trace(seed, quick=quick)
    cfg = autopilot_config or AutopilotConfig()
    spec = WorkloadSpec(seed=seed)  # header only; arrivals come from trace

    def one(autopilot: bool) -> dict:
        return run_soak(
            spec=spec,
            trace=[dict(e) for e in trace],
            state=HypervisorState(device=device),
            serving_config=static_config(quick=quick),
            tick_s=tick_s,
            slo_p99_ms=slo_p99_ms,
            autopilot=autopilot,
            autopilot_config=cfg if autopilot else None,
        )

    runs = [one(autopilot=True) for _ in range(max(1, replays))]
    ap = runs[0]
    ap_pilot = ap["autopilot"]
    digests = [r["autopilot"]["digest"] for r in runs]
    soak_digests = [r["decisions_digest"] for r in runs]
    row: dict = {
        "seed": seed,
        "quick": quick,
        "events": len(trace),
        "phases": phase_specs,
        "slo_p99_ms": slo_p99_ms,
        "p99_ms": ap["latency_ms"]["p99"],
        "slo_ok": ap["slo_ok"],
        "goodput_ratio": ap["goodput_ratio"],
        "shed": ap["shed"],
        "buckets_final": ap["buckets"],
        "decisions": ap_pilot["decisions"],
        "decision_outcomes": ap_pilot["outcomes"],
        "decisions_digest": digests[0],
        "digest_match": len(set(digests)) == 1
        and len(set(soak_digests)) == 1,
        "replays": len(runs),
        # Compile accounting (the zero-UNPLANNED-recompile contract):
        # `recompiles_after_warmup` is already net of the ledger-
        # bracketed pre-warm compiles; raw + planned ride alongside.
        "compiles_after_warmup": ap["compiles_after_warmup"],
        "recompiles_after_warmup": ap["recompiles_after_warmup"],
        "recompiles_after_warmup_raw": ap.get(
            "recompiles_after_warmup_raw", ap["recompiles_after_warmup"]
        ),
        "prewarm": ap_pilot["prewarm"],
        "invariant_violations": ap["invariant_violations"],
        "last_decisions": ap_pilot["last"],
    }
    if include_static:
        static = one(autopilot=False)
        gain = (
            (ap["goodput_ratio"] - static["goodput_ratio"])
            / static["goodput_ratio"]
            if static["goodput_ratio"]
            else 0.0
        )
        row["static"] = {
            "goodput_ratio": static["goodput_ratio"],
            "p99_ms": static["latency_ms"]["p99"],
            "shed": static["shed"],
            "buckets": static["buckets"],
        }
        row["goodput_improvement"] = round(gain, 4)
    return row


__all__ = ["run_autopilot_soak", "shifting_trace", "static_config"]
