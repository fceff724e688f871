"""The knee of an open-loop serving cell: the highest virtual arrival rate
at which the front door sheds nothing over a window's worth of arrivals.

    python3 -m hvbench.knee --workload gov10k.serving --seeds <n> [<n> ...]
        --sessions <N> --lo <hz> --hi <hz> --steps <k>

For each seed it bisects the traffic's `rate_hz` between `--lo` (which
must shed nothing) and `--hi` (which must shed), running the cell's
driver on the CPU until `--sessions` sessions have arrived or the first
request is shed, and prints one JSON line a seed and the least knee over
the seeds. Shedding follows the virtual clock alone (queue depths
against deadlines in virtual seconds), so the CPU finds the same knee
the card would; the tables are cut to what `--sessions` sessions need,
which moves no virtual time.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

from hvbench import harness


def sheds(driver_mod, config: dict, traffic: dict, seed: int, rate: float, sessions: int,
          device: str) -> tuple[int, int]:
    """(requests shed, sessions arrived) at `rate`, stopping at the first shed."""
    drv = driver_mod.Driver(config, {**traffic, "rate_hz": rate, "warmup_calls": 0}, seed,
                            device)
    drv.setup()
    while drv.arrived < sessions and not sum(drv.shed.values()):
        drv.call()
    return sum(drv.shed.values()), drv.arrived


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="hvbench.knee")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sessions", type=int, required=True)
    p.add_argument("--lo", type=float, required=True)
    p.add_argument("--hi", type=float, required=True)
    p.add_argument("--steps", type=int, default=7)
    p.add_argument("--device", default="cpu")
    args = p.parse_args(argv)
    root = Path.cwd()
    _, config, traffic = harness.cell_spec(harness.load_bench(root), args.workload, root)
    driver_mod = importlib.import_module(f"hvbench.drivers.{traffic['driver']}")
    cap = dict(config["capacity"])
    cap["max_sessions"] = min(cap["max_sessions"], 1 << (2 * args.sessions).bit_length())
    config = {**config, "capacity": cap}
    knees = []
    for seed in args.seeds:
        lo, hi, runs = args.lo, args.hi, []
        for rate in (lo, hi):
            shed, arrived = sheds(driver_mod, config, traffic, seed, rate, args.sessions,
                                  args.device)
            runs.append({"rate_hz": rate, "shed": shed, "arrived": arrived})
        if runs[0]["shed"] or not runs[1]["shed"]:
            print(json.dumps({"seed": seed, "error": "the bracket does not hold", "runs": runs}))
            return 1
        for _ in range(args.steps):
            mid = round((lo + hi) / 2, 3)
            shed, arrived = sheds(driver_mod, config, traffic, seed, mid, args.sessions,
                                  args.device)
            runs.append({"rate_hz": mid, "shed": shed, "arrived": arrived})
            lo, hi = (lo, mid) if shed else (mid, hi)
        knees.append(lo)
        print(json.dumps({"seed": seed, "knee_hz": lo, "sheds_at_hz": hi, "runs": runs}),
              flush=True)
    print(json.dumps({"workload": args.workload, "sessions": args.sessions,
                      "knee_hz": min(knees), "seeds": args.seeds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
