"""Shared scaffolding for the terminal watchers.

`metrics_watch.py`, `trace_watch.py`, and `hv_top.py` all follow one
shape: build a `HypervisorState` on a torch device,
drive demo governance traffic through full-pipeline waves, and render
a refreshing ANSI frame. The loop, the traffic driver, and the table
renderer live here so the three watchers cannot drift.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Optional, Sequence

import numpy as np


def build_state(max_sessions: int, device="cuda"):
    """A HypervisorState on `device` whose session table fits the demo
    traffic."""
    import dataclasses

    from hypervisor_tpu_torch.config import DEFAULT_CONFIG
    from hypervisor_tpu_torch.state import HypervisorState

    config = dataclasses.replace(
        DEFAULT_CONFIG,
        capacity=dataclasses.replace(
            DEFAULT_CONFIG.capacity,
            max_sessions=max(
                max_sessions, DEFAULT_CONFIG.capacity.max_sessions
            ),
        ),
    )
    return HypervisorState(config, device=device)


def drive_round(
    state,
    n_sessions: int,
    rnd: int,
    prefix: str = "watch",
    turns: int = 3,
    random_sigma: bool = True,
) -> bool:
    """One full-pipeline wave: n_sessions sessions live and die.

    Returns False once the session table has no room left — slot
    allocation is monotonic (no recycling), so a long watch run
    eventually exhausts it; the watcher then keeps refreshing the
    display on the traffic already recorded instead of crashing.
    """
    from hypervisor_tpu_torch.models import SessionConfig
    from hypervisor_tpu_torch.ops.merkle import BODY_WORDS

    try:
        slots = state.create_sessions_batch(
            [f"{prefix}:r{rnd}:s{i}" for i in range(n_sessions)],
            SessionConfig(min_sigma_eff=0.0),
        )
    except RuntimeError:
        return False
    rng = np.random.RandomState(rnd)
    bodies = rng.randint(
        0, 2**32, size=(turns, n_sessions, BODY_WORDS), dtype=np.uint64
    ).astype(np.uint32)
    sigma = (
        rng.uniform(0.3, 0.95, n_sessions).astype(np.float32)
        if random_sigma
        else np.full(n_sessions, 0.8, np.float32)
    )
    state.run_governance_wave(
        slots,
        [f"did:{prefix}:r{rnd}:{i}" for i in range(n_sessions)],
        slots.copy(),
        sigma,
        bodies,
        now=state.now(),
    )
    return True


def fmt_table(
    rows: Sequence[Sequence[str]],
    header: Optional[Sequence[str]] = None,
    indent: str = "  ",
) -> list[str]:
    """Plain monospace table: auto column widths, right-aligned numbers
    (cells the caller already formatted), left-aligned first column."""
    all_rows = ([list(header)] if header else []) + [list(r) for r in rows]
    if not all_rows:
        return []
    widths = [
        max(len(str(row[c])) for row in all_rows if c < len(row))
        for c in range(max(len(r) for r in all_rows))
    ]
    out = []
    for row in all_rows:
        cells = [
            str(cell).ljust(widths[c]) if c == 0 else str(cell).rjust(widths[c])
            for c, cell in enumerate(row)
        ]
        out.append(indent + "  ".join(cells).rstrip())
    return out


def watch_loop(
    frame: Callable[[], str],
    *,
    watch: bool,
    interval: float,
    tick: Optional[Callable[[], None]] = None,
) -> int:
    """Render `frame()` once, or refresh until ^C with ANSI clear+home.

    `tick` (when given) runs before every frame — the traffic driver —
    so drivers and pure pollers share one loop.
    """
    try:
        while True:
            if tick is not None:
                tick()
            text = frame()
            if watch:
                sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
            print(text, flush=True)
            if not watch:
                return 0
            time.sleep(interval)
    except KeyboardInterrupt:
        return 0
