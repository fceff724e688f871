"""Helpers that hold two runs of one seeded sequence equal (the port
against the reference on the CPU, or a card run against its CPU rerun):
each keeps out of the comparison what depends on a process's history or
on wall time, and nothing else."""

from __future__ import annotations

import contextlib
import re


def same_health_on_every_run(hv) -> None:
    """Keep a facade's health plane from parting two runs: its
    `recompile` events stay off the bus (a compile counts a novel
    abstract signature in a process-global watch, so a second run in the
    same process meets none, and each bus event draws an id from the
    shared counter), and the watchdog stays unarmed (its deadlines are
    each run's own stage times). Every other health kind bridges as it
    is. Works on either package's `Hypervisor`."""
    health = hv.state.health
    bridge = hv._on_health_event
    health._listeners[health._listeners.index(bridge)] = (
        lambda kind, payload: None if kind == "recompile" else bridge(kind, payload))
    health.min_samples = 1 << 62


@contextlib.contextmanager
def recompile_events_off(facade_cls):
    """`same_health_on_every_run` for facades a caller does not hold
    (an example builds its own): while the context is open, every
    facade of `facade_cls` (either package's `core.Hypervisor`) built
    keeps `recompile` events off its bus."""
    bridge = facade_cls._on_health_event

    def drop_recompiles(self, kind, payload):
        if kind != "recompile":
            bridge(self, kind, payload)

    facade_cls._on_health_event = drop_recompiles
    try:
        yield
    finally:
        facade_cls._on_health_event = bridge


def supervisor_accounting(sup) -> dict:
    """A `Supervisor.summary()` without its wall times and paths: the
    recovery latencies cut to their count, the checkpoint to its step
    and WAL seq, the journal without its path, and the last restore
    without its host-clock stamp, wall time and paths."""
    out = sup.summary()
    out["recovery_latency_ms"] = out["recovery_latency_ms"]["n"]
    if out["checkpoint"] is not None:
        out["checkpoint"] = {k: out["checkpoint"][k] for k in ("step", "wal_seq")}
    if out["journal"] is not None:
        out["journal"].pop("path")
    last = out["restores"]["last"]
    if last is not None:
        out["restores"]["last"] = {k: v for k, v in last.items()
                                   if k not in ("at", "wall_ms", "checkpoint", "wal")}
    return out


_CLOCK = re.compile(r"\b\d{2}:\d{2}:\d{2}\b")
_TIMED = re.compile(r"-?\d[\d,]*(?:\.\d+)?(?:e[+-]?\d+)?\s?(?:ms|µs|us|s)\b")
#: Panels whose every number is a wall time or follows from one (the
#: stage-latency quantiles, the watchdog's stragglers, the SLO burn
#: rates and latency splits, the roofline's measured distances): each is
#: cut to its first word.
TIMING_PANELS = ("stage latency", "watchdog", "slo ", "roofline")


def masked_output(text: str, device_names=(), panels=TIMING_PANELS) -> list[str]:
    """The lines an example printed, with what depends on the device or
    on wall time masked: clock stamps, every number with a time unit,
    the given device names (longest first: a card's name, `cuda:0`,
    `cuda`, `cpu`), and the bodies of `panels` (the timing panels by
    default), each cut to its first word up to the next blank line.
    Roots, statuses, counts and every other printed value stay, so two
    runs of one seeded sequence compare line for line."""
    names = sorted({str(n) for n in device_names if n}, key=len, reverse=True)
    out: list[str] = []
    cut = False
    for line in text.splitlines():
        if cut:
            if line.strip():
                continue
            cut = False
        panel = next((p for p in panels if line.startswith(p)), None)
        if panel is not None:
            out.append(f"{panel.strip()} <masked>")
            cut = True
            continue
        line = _TIMED.sub("<t>", _CLOCK.sub("<clock>", line))
        for name in names:
            line = re.sub(rf"(?<![\w-]){re.escape(name)}(?![\w-])", "<device>", line)
        out.append(line)
    return out
