"""The lower-precision control of the comparison that decides `correct`.

    python3 -m hvbench.control --workload <cell> --seeds <n> [<n> ...] --calls <c>

puts the plain reference, computed in bfloat16 (each float32 result
rounded to the nearest bfloat16: the step below the configuration's
float32), in the program's place for a run of `--calls` calls, draws the
same seeded sample of answers a run draws, and judges it with the
comparison every run uses. Each seed prints one JSON line with the
numbers compared; the control must come out not correct. It needs no
card: the control's answers are the reference's, at the cell's own size.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

from hvbench import gen, harness
from hvbench.reference import BFLOAT16


def control_record(driver_mod, config: dict, traffic: dict, seed: int, calls: int,
                   warmup: int) -> dict:
    """The record a bfloat16 program would leave after `warmup` calls of
    set-up and `calls - warmup` in the window."""
    sample = gen.Sample(int(traffic["check_calls"]), seed)
    for c in range(warmup, calls):
        sample.admit(c)
    return driver_mod.reference_record(config, traffic, seed, calls, sorted(sample.kept),
                                       BFLOAT16)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="hvbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--calls", type=int, required=True,
                   help="calls a run makes, set-up's warm-up calls included")
    args = p.parse_args(argv)
    root = Path.cwd()
    bench = harness.load_bench(root)
    _, config, traffic = harness.cell_spec(bench, args.workload, root)
    driver_mod = importlib.import_module(f"hvbench.drivers.{traffic['driver']}")
    warmup = int(traffic["warmup_calls"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        rec = control_record(driver_mod, config, traffic, seed, args.calls, warmup)
        checks, failed = driver_mod.judge(config, traffic, seed, rec, args.calls - warmup)
        correct = all(v["value"] <= v["limit"] for v in checks.values())
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "bfloat16",
                          "correct": correct, "failed_calls": len(failed),
                          "seconds": time.perf_counter() - t0, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
