"""Flight-recorder demo: drive waves, reconstruct spans, export a trace.

Drives governance traffic through a `HypervisorState` with the trace
plane on, then drains the flight recorder the way an operator would:
prints the reconstructed span trees (`hv.<stage>` nesting per wave) and
writes a Chrome `trace_event` JSON file you can load in Perfetto
(https://ui.perfetto.dev) or chrome://tracing.

Usage::

    python -m hypervisor_tpu_torch.examples.trace_watch         # 1 round, tree + file
    python -m hypervisor_tpu_torch.examples.trace_watch --rounds 3 --sessions 64
    python -m hypervisor_tpu_torch.examples.trace_watch --out /tmp/hv_trace.json
    python -m hypervisor_tpu_torch.examples.trace_watch --otlp  # OTLP-lite JSON form
    python -m hypervisor_tpu_torch.examples.trace_watch --sample 0.25
    python -m hypervisor_tpu_torch.examples.trace_watch --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from hypervisor_tpu_torch.examples._watch_common import build_state, drive_round


def print_tree(span, depth: int = 0) -> None:
    dur = span.end_us - span.start_us
    print(
        "  " * depth
        + f"{span.name}  span={span.span_word:08x}  {dur / 1e3:.3f} ms"
    )
    for child in span.children:
        print_tree(child, depth + 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--sessions", type=int, default=16)
    ap.add_argument("--out", type=str, default="/tmp/hv_trace.json")
    ap.add_argument("--otlp", action="store_true")
    ap.add_argument("--sample", type=float, default=None,
                    help="head-based per-session sample rate (0..1)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the state (cpu on a machine without a card)")
    args = ap.parse_args(argv)
    if args.sample is not None:
        os.environ["HV_TRACE_SAMPLE"] = str(args.sample)

    from hypervisor_tpu_torch.observability import tracing

    state = build_state(args.sessions * max(args.rounds, 1) + 64, device=args.device)
    for rnd in range(args.rounds):
        drive_round(
            state, args.sessions, rnd, prefix="trace",
            turns=2, random_sigma=False,
        )

    spans = state.tracer.drain()
    print(f"flight recorder: {len(spans)} reconstructed wave(s)\n")
    for root in spans:
        print(f"wave {root.wave_seq}  trace={root.trace_id}")
        print_tree(root)
        print()

    doc = (
        tracing.to_otlp(spans, state.tracer)
        if args.otlp
        else tracing.to_chrome_trace(spans, state.tracer)
    )
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    kind = "OTLP-lite" if args.otlp else "Chrome trace_event"
    print(f"wrote {kind} JSON to {args.out}")
    if not args.otlp:
        print("load it at https://ui.perfetto.dev or chrome://tracing")

    summary = state.flight_summary()
    print(
        f"ring: {summary['ring_cursor']}/{summary['ring_capacity']} rows, "
        f"{summary['waves_indexed']} waves indexed, "
        f"sample_rate={summary['sample_rate']}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
