"""The saga round's (kernel B7's) share of its roofline, in %:
`kernel_roofline` with the kernels narrowed to the fragments listed in
`hvbench/kernels/saga_tick.json`. The modelled work is a call's B7 work
at its live sagas (`hvbench.work` `saga_tick_block`, one round each of
the rounds a call takes); B7 ticks the whole table, so the share reads
low by the table's size over the live sagas."""

import dataclasses
import json
from pathlib import Path

from hvbench.metrics import kernel_roofline

PATTERNS = json.loads((Path(__file__).resolve().parents[1] / "kernels" / "saga_tick.json")
                      .read_text())["patterns"]


def read(t):
    return kernel_roofline.read(dataclasses.replace(t, kernel_patterns=PATTERNS))
