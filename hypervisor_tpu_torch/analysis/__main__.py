"""`python -m hypervisor_tpu_torch.analysis` — the hvlint CLI.

Guarded: the type-surface test imports every package module, so the
CLI must only run when this file is executed as a program.
"""

if __name__ == "__main__":
    import sys

    from hypervisor_tpu_torch.analysis.cli import main

    sys.exit(main())
