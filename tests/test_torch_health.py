"""The port's health plane against the reference's, on the CPU.

Counterparts of `tests/unit/test_health.py` on
`hypervisor_tpu_torch.observability.health` and the port's
`HypervisorState(device="cpu")`, with the reference unarmed
(`HV_WAVE_PALLAS=0`, `HV_ROOFLINE=0`): the watchdog over the tracer's
bracket (deadlines from the stages' own host-plane histograms), the
occupancy high-water marks and the capacity warnings that fire once per
upward crossing, the footprint protocol (tensor metadata, no transfer),
`health_summary` / `memory_summary`, the compile watch around the
module-level dispatch entries, and the facade's bridge of the health
events onto its bus.

Tolerance 0, with these set apart: wall times (uptime, stage quantiles,
compile wall), and the compile counts, which count novel signatures on
the port (ROADMAP C.2, `test_torch_metrics.
test_compile_counters_count_novel_signatures`). Two differences are
pinned by name: `health_summary["backend"]` is the tables' torch device
type, and the port's bundle-free `serving`/`slo` panels stay disabled
until the serving plane (ROADMAP A5).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import hypervisor_tpu as REF_PKG
import hypervisor_tpu_torch as PORT_PKG
from hypervisor_tpu.observability import health as jax_health
from hypervisor_tpu.observability import metrics as jax_metrics
from hypervisor_tpu_torch.observability import health as port_health
from hypervisor_tpu_torch.observability import metrics as port_metrics
from hypervisor_tpu_torch.testing import same_health_on_every_run
from tests.test_torch_metrics import both, unarmed  # noqa: F401
from tests.test_torch_resilience import PORT, rich_sequence

#: Small rings, so the sequence crosses the 0.85 warn line.
TIGHT = dict(event_log_capacity=16, trace_log_capacity=24, max_agents=24)


def health_mod(pkg):
    return jax_health if pkg.ref else port_health


def metrics_mod(pkg):
    return jax_metrics if pkg.ref else port_metrics


def new_metrics(pkg):
    return jax_metrics.Metrics() if pkg.ref else port_metrics.Metrics(device="cpu")


@dataclasses.dataclass
class _Record:
    """A closed wave bracket, as `tracing.WaveRecord` hands the watchdog."""

    stage: str
    t0_us: float
    t1_us: float
    wave_seq: int = 7
    trace: object = dataclasses.field(
        default_factory=lambda: type("T", (), {"full_id": "trace-7"})())


def masked_health(h: dict) -> dict:
    """`health_summary` with wall times and compile counts set apart."""
    h = dict(h)
    h.pop("uptime_s")
    h.pop("compiles")
    h.pop("backend")
    h["stages"] = {k: v["n"] for k, v in h["stages"].items()}
    h["watchdog"] = {k: v for k, v in h["watchdog"].items() if k != "deadlines_us"}
    return h


def test_watchdog_flags_stragglers_against_the_stage_deadline():
    def run(pkg, clock):
        m = new_metrics(pkg)
        mon = health_mod(pkg).HealthMonitor(m, k=4.0, floor_us=1_000.0, min_samples=32)
        seen = []
        mon.add_listener(lambda kind, payload: seen.append((kind, payload)))
        handle = metrics_mod(pkg).STAGE_LATENCY["saga_round"]
        cold = mon.observe_wave(_Record("saga_round", 0.0, 1e9))
        for us in np.linspace(100.0, 900.0, 40):
            m.observe_us(handle, float(us))
        deadline = mon.deadline_us("saga_round")
        within = mon.observe_wave(_Record("saga_round", 0.0, deadline))
        over = mon.observe_wave(_Record("saga_round", 0.0, deadline + 1.0))
        return (cold, deadline, within, over.to_dict(), seen, mon.watchdog_summary(),
                m.snapshot().counter(metrics_mod(pkg).WAVE_STRAGGLERS))

    ref, port = both(run)
    assert port == ref
    assert port[0] is None and port[2] is None and port[6] == 1
    assert port[4][0][0] == "straggler" and port[5]["straggler_count"] == 1


def test_occupancy_high_water_and_warnings_match_reference():
    """The all-ops sequence on small rings, a drain after every op: the
    live rows, high-water marks and the capacity warnings (one per
    upward crossing) are the reference's."""

    def run(pkg, clock):
        st = pkg.state(**TIGHT)
        events = []
        st.health.add_listener(lambda kind, payload: events.append((kind, payload)))
        occupancy = []

        def after():
            st.metrics_snapshot()
            occupancy.append(st.health.occupancy_summary())

        rich_sequence(st, pkg, 2, after=after)
        return occupancy, [e for e in events if e[0] == "capacity"], st.memory_summary()

    ref, port = both(run)
    assert port[0] == ref[0]
    assert port[1] == ref[1] and port[1], "the small rings crossed no warn line"
    assert port[2] == ref[2]
    assert port[2]["warnings_fired"] == len(port[1])
    assert {"agents", "metrics", "trace_log"} <= set(port[2]["tables"])


def test_footprints_are_the_references_bytes_and_capacities():
    def run(pkg, clock):
        st = pkg.state()
        return {name: t.footprint() for name, t in st.health_tables().items()}

    ref, port = both(run)
    assert port == ref
    assert port_health.hbm_total_bytes(port) == jax_health.hbm_total_bytes(ref)


def test_health_summary_matches_reference():
    def run(pkg, clock):
        st = pkg.state()
        rich_sequence(st, pkg, 1)
        return st.health_summary()

    ref, port = both(run)
    assert masked_health(port) == masked_health(ref)
    assert set(port["compiles"]) == set(ref["compiles"])
    assert port["stages"].keys() == ref["stages"].keys()


def test_health_summary_backend_is_the_torch_device_type():
    """ROADMAP C.2: the reference names `jax.default_backend()`; the port
    names the device type its tables live on. The serving and SLO panels
    are disabled until the serving plane is ported (ROADMAP A5)."""
    st = PORT.state()
    h = st.health_summary()
    assert h["backend"] == st.device.type == "cpu"
    assert h["serving"] == {"enabled": False} and h["slo"] == {"enabled": False}


def test_recompile_events_fan_out_to_subscribed_monitors():
    m = port_metrics.Metrics(device="cpu")
    mon = port_health.HealthMonitor(m)
    seen = []
    mon.add_listener(lambda kind, payload: seen.append((kind, payload)))
    import torch

    watch = port_health.instrument("test_recompile_fanout", lambda x: x)
    watch(torch.zeros(3))
    watch(torch.zeros(5))
    kinds = [k for k, _ in seen]
    assert kinds == ["recompile"]
    assert seen[0][1]["program"] == "test_recompile_fanout"
    assert seen[0][1]["changed"] == ["x: float32[3] -> float32[5]"]
    assert seen[0][1]["donation_failed"] is False


def test_the_dispatch_entries_are_watched_under_the_references_names():
    """Every program the port's compile watch names is a reference
    program name (the port has no donated or tenant twins)."""
    import hypervisor_tpu.integrity.plane  # noqa: F401  (registers its watches)
    import hypervisor_tpu.state  # noqa: F401
    import hypervisor_tpu_torch.integrity.plane  # noqa: F401
    import hypervisor_tpu_torch.state  # noqa: F401

    port = set(port_health._LOG._watches)
    ref = set(jax_health._LOG._watches)
    programs = {p for p in port if not p.startswith("test_")}
    assert programs <= ref
    assert {"governance_wave", "admit_batch", "saga_table_tick", "slash_cascade",
            "terminate_batch", "gateway_check_actions", "update_gauges", "integrity_check",
            "integrity_repair_agents"} <= programs


def test_capacity_warnings_reach_the_facade_bus():
    """The facade bridges the health plane's events onto its bus: a drain
    that crosses the warn line lands one `health.capacity_warning` row,
    the same on both packages."""

    def run(pkg, clock):
        mod = REF_PKG if pkg.ref else PORT_PKG
        bus = mod.HypervisorEventBus()
        hv = mod.Hypervisor(state=pkg.state(**TIGHT), event_bus=bus)
        same_health_on_every_run(hv)
        st = hv.state
        s = st.create_session("s:cap", pkg.models.SessionConfig(min_sigma_eff=0.0,
                                                                 max_participants=32), now=0.0)
        for i in range(22):
            st.enqueue_join(s, f"did:cap:{i}", 0.8)
        st.flush_joins(now=1.0)
        st.metrics_snapshot()
        st.metrics_snapshot()  # a second drain above the line: no second warning
        rows = [(e.event_type.value, e.payload) for e in bus.all_events
                if e.event_type.value == "health.capacity_warning"]
        return rows

    ref, port = both(run)
    assert port == ref
    assert [p["table"] for _, p in port] == ["agents"]


def test_health_plane_launches_nothing():
    """The footprints and the occupancy pass read tensor metadata and the
    drained snapshot only (no device column is read or written)."""
    st = PORT.state()
    before = {n: t.footprint() for n, t in st.health_tables().items()}
    st.health.publish_footprints(st.health_tables())
    snap = st.metrics.snapshot()
    st.health.update_occupancy(snap)
    assert {n: t.footprint() for n, t in st.health_tables().items()} == before
    with pytest.raises(AttributeError):
        port_health.CompileWatch("x", lambda: None).lower  # no jit object to delegate to
