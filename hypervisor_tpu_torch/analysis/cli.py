"""hvlint CLI — `python -m hypervisor_tpu_torch.analysis`.

Exit codes: 0 clean (suppressed-only is clean), 1 unsuppressed
findings, 2 usage/internal error. `--json` emits the machine-readable
report.

Tier A is pure-AST (the analyzed modules are never imported and no
device is touched). Tier B runs the dispatched functions on `--device`,
the card by default; a run on a machine without CUDA must ask for
`--device cpu`, and a CUDA run never drops to the CPU by itself.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional

from hypervisor_tpu_torch.analysis import rules_ast
from hypervisor_tpu_torch.analysis.findings import (
    Finding,
    apply_suppressions,
    load_suppressions,
    unsuppressed,
)

_ANALYSIS_DIR = Path(__file__).resolve().parent

TIER_B_RULES = ("HVB001", "HVB002", "HVB003")
ALL_RULES = rules_ast.TIER_A_RULES + TIER_B_RULES


def default_package_dir() -> Path:
    return _ANALYSIS_DIR.parent


def default_tests_dir(package_dir: Path) -> Optional[Path]:
    """The repo's `tests/` (shared with the reference; the twin rule
    reads only the port's `test_torch_*.py` there, `rules_ast.TEST_GLOB`)."""
    cand = package_dir.parent / "tests"
    return cand if cand.exists() else None


def run(
    tier: str = "a",
    package_dir: Optional[Path] = None,
    tests_dir: Optional[Path] = None,
    baseline_path: Optional[Path] = None,
    suppressions_path: Optional[Path] = None,
    device: str = "cuda",
) -> dict:
    """One full analysis pass; returns the report payload."""
    package_dir = package_dir or default_package_dir()
    tests_dir = tests_dir or default_tests_dir(package_dir)
    baseline_path = baseline_path or (_ANALYSIS_DIR / "baseline.json")
    if suppressions_path is None:
        suppressions_path = _ANALYSIS_DIR / "suppressions.json"

    raw: list[Finding] = []
    tiers_run = []
    tier_a_ms = tier_b_ms = None
    programs: list[str] = []
    wrappers: dict = {}
    b_device = None
    if tier in ("a", "all"):
        t0 = time.monotonic()
        raw += rules_ast.run_tier_a(
            package_dir, tests_dir=tests_dir, baseline_path=baseline_path
        )
        tier_a_ms = round((time.monotonic() - t0) * 1000.0, 1)
        tiers_run.append("A")
    if tier in ("b", "all"):
        from hypervisor_tpu_torch.analysis import dispatch_lint

        t1 = time.monotonic()
        raw += dispatch_lint.run_tier_b(package_dir, device=device)
        tier_b_ms = round((time.monotonic() - t1) * 1000.0, 1)
        programs = list(dispatch_lint.run_tier_b.last_programs)
        wrappers = dict(dispatch_lint.run_tier_b.last_wrappers)
        b_device = dispatch_lint.run_tier_b.last_device
        tiers_run.append("B")

    rules = (
        rules_ast.TIER_A_RULES if tier == "a"
        else TIER_B_RULES if tier == "b"
        else ALL_RULES
    )
    sups, sup_findings = load_suppressions(suppressions_path)
    all_findings = apply_suppressions(
        raw, sups, suppressions_file=suppressions_path.name,
        active_rules=set(rules),
    ) + sup_findings
    open_findings = unsuppressed(all_findings)
    return {
        "tool": "hvlint",
        "tiers": tiers_run,
        "rules": list(rules),
        "package": str(package_dir),
        "files_analyzed": sum(1 for _ in package_dir.rglob("*.py")),
        "findings": [f.to_dict() for f in all_findings],
        "counts": {
            "findings": len(open_findings),
            "suppressed": sum(1 for f in all_findings if f.suppressed),
            "suppressions_on_file": len(sups),
        },
        "tier_a_ms": tier_a_ms,
        "tier_b_ms": tier_b_ms,
        "tier_b_device": b_device,
        "tier_b_programs": programs,
        "tier_b_inplace_writes": wrappers,
        "ok": not open_findings,
    }


def write_baseline(
    package_dir: Optional[Path] = None, path: Optional[Path] = None
) -> Path:
    """Refresh analysis/baseline.json from the current tree (a reviewed
    operation: the registries are wire formats)."""
    from hypervisor_tpu_torch.analysis.walker import Project

    package_dir = package_dir or default_package_dir()
    path = path or (_ANALYSIS_DIR / "baseline.json")
    project = Project.load(package_dir)
    reg = rules_ast.current_registries(project)
    reg["_comment"] = (
        "hvlint HVA004 append-only baseline of the port: EventType wire "
        "codes, metric registration order, WAL record tags. Refresh ONLY "
        "via `python -m hypervisor_tpu_torch.analysis --write-baseline` "
        "in a reviewed change."
    )
    path.write_text(json.dumps(reg, indent=2, sort_keys=True) + "\n")
    return path


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="hvlint",
        description=(
            "Static contract analyzer for the port's dispatch, WAL, lock "
            "and kernel-twin planes."
        ),
    )
    ap.add_argument(
        "--tier", choices=("a", "b", "all"), default="a",
        help="a: pure-AST rules (default, no device); b: dispatch-time "
             "lints on --device; all: both",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="Tier B's torch device (default cuda; pass cpu without a card)",
    )
    ap.add_argument("--json", action="store_true", help="machine output")
    ap.add_argument(
        "--package", type=Path, default=None,
        help="package dir to analyze (default: this hypervisor_tpu_torch tree)",
    )
    ap.add_argument("--tests", type=Path, default=None)
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--suppressions", type=Path, default=None)
    ap.add_argument(
        "--write-baseline", action="store_true",
        help="refresh the HVA004 baseline from the current tree and exit",
    )
    args = ap.parse_args(argv)

    if args.write_baseline:
        path = write_baseline(args.package, args.baseline)
        print(f"baseline refreshed: {path}")
        return 0

    try:
        report = run(
            tier=args.tier,
            package_dir=args.package,
            tests_dir=args.tests,
            baseline_path=args.baseline,
            suppressions_path=args.suppressions,
            device=args.device,
        )
    except Exception as exc:  # pragma: no cover - internal error path
        print(f"hvlint internal error: {exc!r}", file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps(report, indent=2))
    else:
        shown = [Finding(**f) for f in report["findings"]]
        for f in shown:
            if not f.suppressed:
                print(f.render())
        counts = report["counts"]
        tiers = "+".join(report["tiers"])
        print(
            f"hvlint tier {tiers}: {counts['findings']} finding(s), "
            f"{counts['suppressed']} suppressed, "
            f"{report['files_analyzed']} files"
            + (
                f", {len(report['tier_b_programs'])} programs run on "
                f"{report['tier_b_device']}: {', '.join(report['tier_b_programs'])}"
                if report["tier_b_programs"] else ""
            )
        )
    return 0 if report["ok"] else 1


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
