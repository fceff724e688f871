"""The tenant wave's kernels' share of their roofline, in %:
`kernel_roofline` with the kernels narrowed to the fragments listed in
`hvbench/kernels/tenant/tenant_wave.json` (the contribution's, B4's, B5's
and B2's tenant forms and B3). The modelled work is a call's work in
those kernels at its real sessions and lanes, totalled over the tenants
(`hvbench.work`: the `_tenants` forms and `tree_roots`); the arena pads
every tenant to one bucket, so the share reads low by the padding."""

import dataclasses
import json
from pathlib import Path

from hvbench.metrics import kernel_roofline

PATTERNS = json.loads((Path(__file__).resolve().parents[1] / "kernels" / "tenant"
                       / "tenant_wave.json").read_text())["patterns"]


def read(t):
    return kernel_roofline.read(dataclasses.replace(t, kernel_patterns=PATTERNS))
