"""Open-workload load generator + sustained-soak harness.

Closed-loop benches (fixed-shape waves, one request class) flatter a
serving system; production traffic is an OPEN stream — arrivals do not
wait for completions. This module generates that stream and drives it
through the serving front door:

  * **Seeded Poisson arrivals** — session arrivals are a Poisson
    process at `rate_hz` (exponential inter-arrival times from one
    `numpy.RandomState`), split between ephemeral one-wave lifecycles
    and long-lived sessions.
  * **Heavy-tailed session lifetimes** — long-lived sessions live for
    a Pareto-distributed time (`lifetime_alpha`, scaled to
    `lifetime_mean_s`), so a soak always carries a long-session tail —
    the population shape that breaks naive schedulers.
  * **Replayable trace files** — `generate_trace` produces a plain
    event list (virtual timestamps, no wall clock anywhere);
    `save_trace`/`load_trace` round-trip it through JSONL. The SAME
    trace + seed yields identical admission/shed decisions and
    identical Merkle chain heads (`run_soak` reports both digests;
    pinned by `tests/unit/test_serving.py`).

`run_soak` drives a trace on a VIRTUAL clock (tick cadence `tick_s`):
queue-wait latency is virtual (deterministic), wave execution time is
measured wall clock — the composition a real deployment observes. The
report carries goodput, p50/p99 latency, shed rate by reason, deadline
misses, and the compile-telemetry recompile count after warmup (the
zero-recompile contract), and lands in `bench_suite --soak` as the
`soak` trajectory row gated by `benchmarks/regression.py`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np

from hypervisor_tpu_torch.ops.merkle import BODY_WORDS
from hypervisor_tpu_torch.serving.front_door import FrontDoor, ServingConfig
from hypervisor_tpu_torch.serving.scheduler import WaveScheduler


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One open workload, fully determined by its fields (seed included)."""

    seed: int = 0
    rate_hz: float = 200.0          # session arrivals per virtual second
    duration_s: float = 5.0         # virtual arrival window
    lifecycle_fraction: float = 0.6  # share of arrivals that are ephemeral
    lifetime_mean_s: float = 0.5    # long-lived session mean lifetime
    lifetime_alpha: float = 1.5     # Pareto tail index (heavier when -> 1)
    max_lifetime_s: float = 30.0    # tail clip so a soak always drains
    joins_per_session: int = 2      # long-lived: extra members (>= 1)
    actions_per_member: float = 2.0  # mean gateway actions per member
    saga_fraction: float = 0.2      # long-lived sessions that run a saga
    sigma_mean: float = 0.75
    sigma_low_fraction: float = 0.1  # share of low-trust arrivals
    turns: int = 1                  # audit turns per lifecycle

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def generate_trace(spec: WorkloadSpec) -> list[dict]:
    """The workload as a sorted event list (virtual time, seeded)."""
    rng = np.random.RandomState(spec.seed)
    events: list[dict] = []
    t = 0.0
    n = 0
    while True:
        t += float(rng.exponential(1.0 / spec.rate_hz))
        if t >= spec.duration_s:
            break
        sid = f"soak:s{n}"
        n += 1

        def sigma() -> float:
            if rng.uniform() < spec.sigma_low_fraction:
                return round(float(rng.uniform(0.05, 0.3)), 4)
            return round(
                float(np.clip(rng.normal(spec.sigma_mean, 0.1), 0.0, 1.0)), 4
            )

        if rng.uniform() < spec.lifecycle_fraction:
            events.append(
                {
                    "t": round(t, 6),
                    "kind": "lifecycle",
                    "sid": sid,
                    "did": f"did:{sid}:a0",
                    "sigma": sigma(),
                    "body_seed": int(rng.randint(0, 2**31)),
                }
            )
            continue
        lifetime = float(
            min(
                spec.max_lifetime_s,
                (rng.pareto(spec.lifetime_alpha) + 1.0)
                * spec.lifetime_mean_s
                * (spec.lifetime_alpha - 1.0)
                / spec.lifetime_alpha,
            )
        )
        events.append({"t": round(t, 6), "kind": "create", "sid": sid})
        n_joins = max(1, int(spec.joins_per_session))
        for j in range(n_joins):
            tj = t + float(rng.uniform(0.0, min(0.05, lifetime / 2)))
            events.append(
                {
                    "t": round(tj, 6),
                    "kind": "join",
                    "sid": sid,
                    "did": f"did:{sid}:a{j}",
                    "sigma": sigma(),
                }
            )
            n_actions = int(rng.poisson(spec.actions_per_member))
            for _ in range(n_actions):
                ta = t + float(rng.uniform(0.05, max(lifetime, 0.06)))
                events.append(
                    {
                        "t": round(ta, 6),
                        "kind": "action",
                        "sid": sid,
                        "did": f"did:{sid}:a{j}",
                        "required_ring": int(rng.choice((0, 2, 2, 2, 3))),
                        "read_only": bool(rng.uniform() < 0.5),
                    }
                )
        if rng.uniform() < spec.saga_fraction:
            ts = t + float(rng.uniform(0.05, max(lifetime, 0.06)))
            events.append(
                {
                    "t": round(ts, 6),
                    "kind": "saga",
                    "sid": sid,
                    "ok": bool(rng.uniform() < 0.9),
                }
            )
        events.append(
            {"t": round(t + lifetime, 6), "kind": "terminate", "sid": sid}
        )
    events.sort(key=lambda e: (e["t"], e["sid"], e["kind"]))
    return events


def save_trace(path, spec: WorkloadSpec, events: list[dict]) -> Path:
    """JSONL trace file: a spec header line, then one event per line."""
    path = Path(path)
    with path.open("w") as f:
        f.write(json.dumps({"workload_spec": spec.to_dict()}) + "\n")
        for e in events:
            f.write(json.dumps(e) + "\n")
    return path


def load_trace(path) -> tuple[WorkloadSpec, list[dict]]:
    lines = Path(path).read_text().splitlines()
    header = json.loads(lines[0])
    spec = WorkloadSpec(**header["workload_spec"])
    return spec, [json.loads(line) for line in lines[1:] if line.strip()]


def _lifecycle_bodies(seed: int, turns: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return rng.randint(
        0, 2**32, (turns, BODY_WORDS), dtype=np.uint64
    ).astype(np.uint32)


def _quantile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def run_soak(
    spec: Optional[WorkloadSpec] = None,
    trace: Optional[list[dict]] = None,
    state=None,
    serving_config: Optional[ServingConfig] = None,
    tick_s: float = 0.01,
    slo_p99_ms: float = 250.0,
    attach_integrity: bool = True,
    integrity_every: int = 8,
    autopilot: bool = False,
    autopilot_config=None,
) -> dict:
    """Drive one open-workload trace through a warmed front door.

    Returns the soak report (the `soak` BENCH trajectory row). The
    virtual clock drives arrivals and queue-wait latency; wave wall
    time is measured. Decisions digest + chain-heads digest are the
    replay-determinism keys.

    With `autopilot=True` an `autopilot.Autopilot` attaches after
    warmup and steps once per virtual tick (decision windows pace
    themselves on the virtual clock, so the decision stream is as
    replayable as the admission stream). Its grow-rule pre-warms are
    ledger-bracketed PLANNED compiles: the report's
    `recompiles_after_warmup` is net of them (the zero-UNPLANNED-
    recompile contract) with the raw count alongside.
    """
    from hypervisor_tpu_torch.state import HypervisorState

    spec = spec or WorkloadSpec()
    if trace is None:
        trace = generate_trace(spec)
    if state is None:
        state = HypervisorState()
    plane = None
    if attach_integrity and state.integrity is None:
        from hypervisor_tpu_torch.integrity import IntegrityPlane

        plane = IntegrityPlane(state, every=integrity_every)
    front = FrontDoor(state, serving_config)
    sched = WaveScheduler(front)

    warm_t0 = time.perf_counter()
    baseline = sched.warm(now=0.0)
    warm_s = time.perf_counter() - warm_t0
    pilot = None
    if autopilot:
        from hypervisor_tpu_torch.autopilot import Autopilot

        pilot = Autopilot(state, sched, config=autopilot_config)
    wall_t0 = time.perf_counter()

    decisions = hashlib.sha256()
    offered = {
        "join": 0, "action": 0, "lifecycle": 0, "terminate": 0, "saga": 0,
    }
    orphaned = 0
    saga_count = 0
    tickets = []
    slot_of_sid: dict[str, int] = {}
    live_sids: set[str] = set()

    def note(eid: int, outcome: str) -> None:
        decisions.update(f"{eid}:{outcome};".encode())

    def submit(eid: int, e: dict, now: float) -> None:
        nonlocal orphaned, saga_count
        kind = e["kind"]
        if kind == "create":
            slot_of_sid[e["sid"]] = state.create_session(
                e["sid"], sched._lifecycle_config(), now=now
            )
            live_sids.add(e["sid"])
            note(eid, "created")
            return
        if kind == "lifecycle":
            offered["lifecycle"] += 1
            out = front.submit_lifecycle(
                e["sid"], e["did"], e["sigma"],
                delta_bodies=_lifecycle_bodies(e["body_seed"], spec.turns),
                now=now,
            )
        elif kind == "join":
            offered["join"] += 1
            slot = slot_of_sid.get(e["sid"])
            if slot is None or e["sid"] not in live_sids:
                orphaned += 1
                note(eid, "orphan")
                return
            out = front.submit_join(slot, e["did"], e["sigma"], now=now)
        elif kind == "action":
            offered["action"] += 1
            slot = slot_of_sid.get(e["sid"])
            row = (
                state.agent_row(e["did"], slot) if slot is not None else None
            )
            if row is None or e["sid"] not in live_sids:
                # Member never admitted (shed/refused) or session gone
                # — deterministic given deterministic admission.
                orphaned += 1
                note(eid, "orphan")
                return
            out = front.submit_action(
                row["slot"],
                required_ring=e["required_ring"],
                is_read_only=e["read_only"],
                now=now,
            )
        elif kind == "saga":
            offered["saga"] += 1
            slot = slot_of_sid.get(e["sid"])
            if slot is None or e["sid"] not in live_sids:
                orphaned += 1
                note(eid, "orphan")
                return
            saga_slot = state.create_saga(
                f"{e['sid']}:saga{saga_count}", slot, [{"has_undo": False}]
            )
            saga_count += 1
            out = front.submit_saga_step(saga_slot, e["ok"], now=now)
        elif kind == "terminate":
            offered["terminate"] += 1
            slot = slot_of_sid.get(e["sid"])
            if slot is None or e["sid"] not in live_sids:
                orphaned += 1
                note(eid, "orphan")
                return
            live_sids.discard(e["sid"])
            out = front.submit_terminate(slot, now=now)
        else:  # pragma: no cover — trace files are generated here
            raise ValueError(f"unknown trace event kind {kind!r}")
        if out.refused:
            note(eid, f"shed:{out.kind}")
        else:
            note(eid, "queued")
            tickets.append(out)

    # ── the soak loop: virtual ticks, arrivals submitted in order ────
    idx = 0
    now = 0.0
    horizon = (max(e["t"] for e in trace) if trace else 0.0) + tick_s
    while now <= horizon or idx < len(trace):
        while idx < len(trace) and trace[idx]["t"] <= now:
            submit(idx, trace[idx], trace[idx]["t"])
            idx += 1
        sched.tick(now=now)
        if pilot is not None:
            pilot.step(now)
        now += tick_s
    # Drain the tail so every accepted request resolves.
    sched.drain(now=now)
    if pilot is not None:
        # One closing window so tail decisions get their outcome
        # attribution before the report snapshots the ledger.
        pilot.step(now)

    wall_s = time.perf_counter() - wall_t0
    after = {
        k: v - baseline[k]
        for k, v in {
            "programs": 0, "compiles": 0, "recompiles": 0,
            "donation_failures": 0,
        }.items()
    }
    from hypervisor_tpu_torch.observability import health as health_plane

    summary = health_plane.compile_summary(last=0)
    for k in after:
        after[k] = summary[k] - baseline[k]
    # Planned pre-warm compiles (autopilot grow rule, ledger-bracketed)
    # net out of the post-warm telemetry: the contract is zero
    # UNPLANNED recompiles, and the raw counts ride the report so the
    # subtraction is auditable.
    planned_compiles = pilot.prewarm["compiles"] if pilot else 0
    planned_recompiles = pilot.prewarm["recompiles"] if pilot else 0

    latencies = sorted(
        t.latency_s * 1e3 for t in tickets if t.latency_s is not None
    )
    per_kind: dict[str, list[float]] = {}
    for t in tickets:
        if t.latency_s is not None:
            per_kind.setdefault(t.kind, []).append(t.latency_s * 1e3)
    for v in per_kind.values():
        v.sort()
    served = sum(front.served.values())
    offered_total = sum(offered.values())
    shed_total = sum(front.shed.values())
    virtual_s = max(now, 1e-9)

    violations = 0
    if plane is not None or state.integrity is not None:
        from hypervisor_tpu_torch.observability import metrics as mp

        snap = state.metrics_snapshot()
        violations = int(snap.counter(mp.INTEGRITY_VIOLATIONS))

    chain_digest = hashlib.sha256()
    for s in sorted(state._chain_seed):
        chain_digest.update(
            np.asarray(state._chain_seed[s], np.uint32).tobytes()
        )

    p99 = _quantile(latencies, 0.99)
    report = {
        "spec": spec.to_dict(),
        "events": len(trace),
        "offered": dict(offered, total=offered_total),
        "served": served,
        "orphaned": orphaned,
        "shed": dict(front.shed),
        "shed_rate": round(shed_total / offered_total, 4) if offered_total else 0.0,
        "goodput_ops_s": round(served / virtual_s, 1),
        "goodput_ratio": (
            round(served / offered_total, 4) if offered_total else 0.0
        ),
        "arrival_rate_hz": spec.rate_hz,
        "virtual_duration_s": round(virtual_s, 3),
        "latency_ms": {
            "n": len(latencies),
            "p50": round(_quantile(latencies, 0.5), 3),
            "p95": round(_quantile(latencies, 0.95), 3),
            "p99": round(p99, 3),
            "max": round(latencies[-1], 3) if latencies else 0.0,
        },
        "latency_p99_ms_by_kind": {
            k: round(_quantile(v, 0.99), 3)
            for k, v in sorted(per_kind.items())
        },
        # Per-class latency spread (round 14): the trajectory's
        # class-level drift signal — presence-gated by regression.py.
        "latency_ms_by_kind": {
            k: {
                "n": len(v),
                "p50": round(_quantile(v, 0.5), 3),
                "p99": round(_quantile(v, 0.99), 3),
            }
            for k, v in sorted(per_kind.items())
        },
        # Critical-path attribution (round 14): per-class decomposition
        # quantiles, the attribution-sum invariant's worst error, the
        # wave-phase shares (one trace drain, post-soak), and exemplar
        # coverage — presence-gated by regression.py.
        "latency_attribution": {
            **front.attribution.summary(),
            "phase_shares": front.attribution.phase_shares(state.tracer),
        },
        # Burn-rate plane: per-class final burn state + the replayable
        # alert log digest (same trace + seed => identical alerts).
        "slo": front.slo.summary(),
        "slo_p99_ms": slo_p99_ms,
        "slo_ok": bool(p99 <= slo_p99_ms),
        "deadline_misses": front.deadline_misses,
        "waves": dict(front.waves),
        "padded_lanes": front.padded_lanes,
        "buckets": list(front.config.buckets),
        "compiles_after_warmup": after["compiles"] - planned_compiles,
        "recompiles_after_warmup": after["recompiles"] - planned_recompiles,
        "invariant_violations": violations,
        "decisions_digest": decisions.hexdigest(),
        "chain_heads_digest": chain_digest.hexdigest(),
        "warm_s": round(warm_s, 3),
        "wall_s": round(wall_s, 3),
    }
    if pilot is not None:
        report["compiles_after_warmup_raw"] = after["compiles"]
        report["recompiles_after_warmup_raw"] = after["recompiles"]
        report["autopilot"] = pilot.summary(last=16)
    return report


__all__ = [
    "WorkloadSpec",
    "generate_trace",
    "load_trace",
    "run_soak",
    "save_trace",
]
