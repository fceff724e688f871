"""Live terminal summary of the device metrics plane (`metrics --watch`).

Drives governance traffic through a `HypervisorState` and renders the
metrics plane the way an operator would watch a scrape target: counters,
occupancy gauges, and per-stage latency quantiles drawn from the
log-bucket histograms — one `snapshot()` (a single device read) per
refresh.

Usage::

    python -m hypervisor_tpu_torch.examples.metrics_watch             # one frame
    python -m hypervisor_tpu_torch.examples.metrics_watch --watch     # until ^C
    python -m hypervisor_tpu_torch.examples.metrics_watch --rounds 5 --sessions 256
    python -m hypervisor_tpu_torch.examples.metrics_watch --prometheus
    python -m hypervisor_tpu_torch.examples.metrics_watch --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from hypervisor_tpu_torch.examples._watch_common import build_state, drive_round, watch_loop


def render(snap) -> str:
    from hypervisor_tpu_torch.observability import metrics as mp

    lines = [
        f"hypervisor metrics plane @ {time.strftime('%H:%M:%S')}",
        "",
        "counters",
    ]
    for handle in (
        mp.WAVE_TICKS, mp.ADMITTED, mp.REFUSED, mp.SESSIONS_ARCHIVED,
        mp.BONDS_RELEASED, mp.SAGA_STEPS_COMMITTED, mp.SAGA_STEPS_FAILED,
        mp.GATEWAY_ALLOWED, mp.GATEWAY_DENIED, mp.SLASHED, mp.CLIPPED,
        mp.EVENTS_MIRRORED,
    ):
        lines.append(f"  {handle.name:40s} {snap.counter(handle):>12,}")
    lines.append("gauges")
    for handle in (
        *mp.RING_AGENTS, mp.AGENTS_ACTIVE, mp.QUARANTINED,
        mp.BREAKER_TRIPPED, mp.SESSIONS_LIVE, mp.VOUCH_EDGES_ACTIVE,
    ):
        label = handle.name + handle.label_str()
        lines.append(f"  {label:40s} {snap.gauge(handle):>12,.0f}")
    lines.append("stage latency (host bracket, µs)")
    lines.append(f"  {'stage':28s} {'n':>8s} {'p50':>10s} {'p95':>10s}")
    for stage, n, (p50, p95) in mp.iter_stage_quantiles(snap):
        lines.append(f"  {stage:28s} {n:>8,} {p50:>10,.1f} {p95:>10,.1f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sessions", type=int, default=64, help="lanes per wave")
    ap.add_argument("--rounds", type=int, default=1, help="waves to drive")
    ap.add_argument("--watch", action="store_true", help="refresh until ^C")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the state (cpu on a machine without a card)")
    ap.add_argument(
        "--prometheus", action="store_true",
        help="print the raw text exposition instead of the summary",
    )
    args = ap.parse_args(argv)

    state = build_state(args.sessions * max(args.rounds, 1) + 64, device=args.device)
    progress = {"rnd": 0, "driving": True}

    def tick() -> None:
        for _ in range(args.rounds):
            if progress["driving"]:
                progress["driving"] = drive_round(
                    state, args.sessions, progress["rnd"], prefix="watch"
                )
            progress["rnd"] += 1

    def frame() -> str:
        if args.prometheus:
            return state.metrics_prometheus().rstrip("\n")
        return render(state.metrics_snapshot())

    return watch_loop(
        frame, watch=args.watch, interval=args.interval, tick=tick
    )


if __name__ == "__main__":
    sys.exit(main())
