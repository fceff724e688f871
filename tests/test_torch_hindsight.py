"""The port's hindsight plane against the reference's, on the CPU.

Counterparts of `tests/unit/test_history.py` and `test_incidents.py`
over the state: the tiered history fed by every drain (no drain of its
own), its digest and conservation witness, `history_query`, and the
incident recorder on the health fan-out (its `wal` and `trace` context
providers, the facade's `events` provider), driven by the seeded all-ops
sequence (`test_torch_resilience.rich_sequence`) with a drain after
every op, a straggler, a degraded-mode entry and an integrity violation.
Both states share the same `hindsight_clock`; the reference runs unarmed
(`HV_WAVE_PALLAS=0`, `HV_ROOFLINE=0`).

Tolerance 0: `history.digest()` and the conservation witness, every
series' points, the incident ids, the bundles' rule-input fields
(`rule` and the trigger without its advisory keys) and their `wal`
blocks. The two compile series of the declared set
(`hv_compiles_total`, `hv_recompiles_total`) count differently on the
two packages (ROADMAP C.2), so the digests compare over the declared set
without them, and `test_only_the_compile_series_part` pins that they are
the only series that part.
"""

from __future__ import annotations

import numpy as np

import hypervisor_tpu as REF_PKG
import hypervisor_tpu_torch as PORT_PKG
from hypervisor_tpu.observability import history as jax_history
from hypervisor_tpu.observability import incidents as jax_incidents
from hypervisor_tpu.resilience import Supervisor as JaxSupervisor
from hypervisor_tpu_torch.observability import history as port_history
from hypervisor_tpu_torch.observability import incidents as port_incidents
from hypervisor_tpu_torch.resilience.supervisor import Supervisor as PortSupervisor
from hypervisor_tpu_torch.testing import same_health_on_every_run
from tests.test_torch_metrics import both, unarmed  # noqa: F401
from tests.test_torch_resilience import rich_sequence

COMPILE_SERIES = ("hv_compiles_total", "hv_recompiles_total")
SERIES = tuple(s for s in port_history.DEFAULT_SERIES if s not in COMPILE_SERIES)


def hindsight_run(pkg, clock, series=SERIES, bus: bool = False):
    """The sequence: every op of the all-ops sequence with a drain after
    it, then a straggler, a degraded entry and exit, and one more drain.
    The history plane samples `series`."""
    mod = REF_PKG if pkg.ref else PORT_PKG
    hv = mod.Hypervisor(state=pkg.state(), event_bus=mod.HypervisorEventBus()) if bus else None
    if hv is not None:
        same_health_on_every_run(hv)
    st = hv.state if bus else pkg.state()
    hist_mod = jax_history if pkg.ref else port_history
    st.history = hist_mod.HistoryPlane(series=series, metrics=st.metrics)
    st.incidents.history = st.history
    st.hindsight_clock = lambda: clock.t - 1_767_225_600.0

    def after():
        clock.advance(0.5)
        st.metrics_snapshot()

    rich_sequence(st, pkg, 7, after=after)
    st.health.emit_event("straggler", {"stage": "governance_wave", "trace_id": "t:1",
                                       "wave_seq": 3, "duration_us": 9e6})
    sup = (JaxSupervisor if pkg.ref else PortSupervisor)(st, sleep=lambda s: None)
    clock.advance(60.0)
    sup.force_degraded("hindsight test")
    sup.force_recovered()
    clock.advance(1.0)
    st.metrics_snapshot()
    return st, hv


def rule_fields(bundle: dict, mod) -> dict:
    trigger = {k: v for k, v in bundle["trigger"].items()
               if k not in mod.ADVISORY_PAYLOAD_KEYS}
    return {"id": bundle["id"], "class": bundle["class"], "kind": bundle["kind"],
            "seq": bundle["seq"], "now": bundle["now"], "rule": bundle["rule"],
            "trigger": trigger, "wal": bundle["context"]["wal"]}


def test_history_digest_and_conservation_match_reference():
    def run(pkg, clock):
        st, _ = hindsight_run(pkg, clock)
        witness = st.history.verify_conservation()
        query = st.history_query()
        points = {s: st.history_query(series=s, tier=t)["points"]
                  for s in SERIES for t in (0, 1, 2)}
        clipped = st.history_query(series="hv_sessions_live", start=10.0, end=20.0)
        return st.history.digest(), witness, query, points, clipped

    ref, port = both(run)
    assert port[0] == ref[0]
    assert port[1] == ref[1] and port[1]["ok"]
    assert port[2] == ref[2] and port[2]["conservation"] is True
    assert port[3] == ref[3]
    assert port[4] == ref[4] and port[4]["points"]
    assert port[2]["samples"] > 40


def test_only_the_compile_series_part():
    """ROADMAP C.2: over the whole declared set, every series but the two
    compile counters holds the same points on both packages."""

    def run(pkg, clock):
        st, _ = hindsight_run(pkg, clock, series=port_history.DEFAULT_SERIES)
        return {s: st.history.query(s, None, None, 0) for s in port_history.DEFAULT_SERIES}

    ref, port = both(run)
    assert port_history.DEFAULT_SERIES == jax_history.DEFAULT_SERIES
    for s in SERIES:
        assert port[s] == ref[s], s
    for s in COMPILE_SERIES:
        assert len(port[s]) == len(ref[s]), s


def test_incident_ids_and_rule_fields_match_reference():
    def run(pkg, clock):
        st, hv = hindsight_run(pkg, clock, bus=True)
        mod = jax_incidents if pkg.ref else port_incidents
        summary = st.incidents_summary()
        bundles = [rule_fields(st.incident_bundle(row["id"]), mod) for row in summary["last"]]
        for b in bundles:
            b["wal"] = {**b["wal"], "checkpoint": None}
        contexts = sorted(st.incident_bundle(summary["last"][0]["id"])["context"])
        trace = st.incident_bundle(summary["last"][0]["id"])["context"]["trace"]
        kinds = [e.event_type.value for e in hv.event_bus.all_events
                 if e.event_type.value.startswith("incident.")]
        replay = all(st.incidents.replay_check(row["id"]) for row in summary["last"])
        # A bundle's size counts its context, whose trace block holds wall
        # times (and the reference's its ledger block).
        for row in summary["last"]:
            row.pop("bytes")
        return summary, bundles, contexts, trace["trace_id"], kinds, replay

    ref, port = both(run)
    assert port[0] == ref[0]
    assert port[0]["captured"] >= 2
    assert {"watchdog.straggler", "resilience.degraded_entered"} <= set(port[0]["classes"])
    assert port[1] == ref[1]
    assert port[3] == ref[3]
    assert port[4] == ref[4] and port[4]
    assert port[5] is ref[5] is True
    # The port's bundle carries the blocks of the planes it has: history,
    # the WAL pointer, the SLO panel, the trace fragment and the facade's
    # bus slice; only the autopilot's ledger block waits (ROADMAP A7).
    assert port[2] == ["events", "history", "slo", "trace", "wal"]
    assert set(ref[2]) - set(port[2]) == {"ledger"}


def test_a_missing_incident_is_none_and_the_wal_block_points_at_the_journal(tmp_path):
    def run(pkg, clock):
        st = pkg.state()
        st.hindsight_clock = lambda: 2.5
        st.journal = pkg.wal.WriteAheadLog(tmp_path / ("r.log" if pkg.ref else "p.log"),
                                           fsync=False)
        st.create_session("s:wal", pkg.models.SessionConfig(), now=0.0)
        iid = st.incidents.observe("integrity_violation", {"total": 1, "unrepairable": 0})
        bundle = st.incident_bundle(iid)
        return st.incident_bundle("nope"), iid, bundle["context"]["wal"], bundle["rule"]

    ref, port = both(run)
    assert port == ref and port[0] is None and port[2]["wal_seq"] == 1
    assert np.isfinite(port[3]["now"])
