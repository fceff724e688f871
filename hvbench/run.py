"""Run one cell of the port's benchmark once.

    python3 -m hvbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It builds the port's kernels into the
port's own cache (`hypervisor_tpu_torch/_build/`), builds the cell's
state from the seed and warms its shapes (set-up, `setup_s`), measures a
closed loop of back-to-back calls for `--seconds`, judges a seeded
sample of the answers against the plain reference, and prints one JSON
line last on standard output. With `--trace 1` the line carries the
per-layer metrics, the profiled window and its breakdown instead of the
end-to-end metrics.

It needs an NVIDIA card: without one it exits non-zero and prints no
result. It refuses to print a result when the process holds JAX or the
JAX package (compared by whole top-level module names).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402

# One process with few threads: the host paces every cell.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

#: Top-level module names that may not be loaded in a run's process.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "hypervisor_tpu"})
#: Build and kernel caches, inside the checkout at fixed paths.
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "CUDA_CACHE_PATH": "cuda"}


def forbidden_modules(names) -> list:
    """The forbidden top-level names among module names."""
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)


def parse(argv):
    p = argparse.ArgumentParser(prog="hvbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    root = Path.cwd()
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(root / ".hvbench_cache" / sub)
    from hvbench import harness

    bench = harness.load_bench(root)
    cell, _, _ = harness.cell_spec(bench, args.workload, root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"hvbench: the cell needs {cell['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.zeros((), device="cuda")
    t_init = time.perf_counter()
    from hypervisor_tpu_torch.kernels import _build

    _build.build_all()
    print(json.dumps({"setup_stages_s": {"python_torch_cuda_init": t_init - T_START,
                                         "kernel_build": time.perf_counter() - t_init}}),
          file=sys.stderr)
    line, checks = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                                    bool(args.trace), "cuda", T_START, root)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"hvbench: the run loaded forbidden modules: {bad}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
