"""Helpers that hold two runs of one seeded sequence equal (the port
against the reference on the CPU, or a card run against its CPU rerun):
each keeps out of the comparison what depends on a process's history or
on wall time, and nothing else."""

from __future__ import annotations


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
