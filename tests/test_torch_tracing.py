"""The port's flight recorder drain against the reference's, on the CPU.

Counterparts of `tests/unit/test_tracing.py`'s reconstruction and export
cases on `hypervisor_tpu_torch.observability.tracing` and the state's
`session_trace` / `flight_summary`, with the reference unarmed
(`HV_WAVE_PALLAS=0`, `HV_ROOFLINE=0`): after the seeded all-ops sequence
(`test_torch_resilience.rich_sequence`), the span trees of three
sessions, with the audit annotation on the newest wave; the recorder's
summary; the Chrome `trace_event` and OTLP-lite exports; the bus-event
join; `TraceContext.child`; and the watchdog hook on the bracket.

Tolerance 0 on everything but wall times, which are each machine's
clock: span start/end, `duration_us`, and the exports' timestamps are
masked; so is the exporters' service name (each package names itself).
"""

from __future__ import annotations

import hypervisor_tpu as REF_PKG
import hypervisor_tpu_torch as PORT_PKG
from hypervisor_tpu.observability import tracing as jax_tracing
from hypervisor_tpu_torch.observability import tracing as port_tracing
from hypervisor_tpu_torch.testing import same_health_on_every_run
from tests.test_torch_metrics import both, unarmed  # noqa: F401
from tests.test_torch_resilience import PORT, rich_sequence

_TIMES = {"ts", "dur", "startTimeUnixNano", "endTimeUnixNano", "timeUnixNano", "ts_us"}


def tracing_mod(pkg):
    return jax_tracing if pkg.ref else port_tracing


def tree(span) -> tuple:
    """A span tree without its times."""
    return (span.name, span.stage, span.trace_id, span.span_word, span.parent_span_word,
            span.wave_seq, [masked(e) for e in span.events], [tree(c) for c in span.children])


def masked(obj):
    """A JSON-like export with its times and service names masked."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k in _TIMES:
                out[k] = "t"
            elif k == "stringValue" and str(v).startswith("hypervisor_tpu"):
                out[k] = "service"
            elif k == "args" and isinstance(v, dict) and str(v.get("name", "")).startswith(
                    "hypervisor_tpu"):
                out[k] = {"name": "service"}
            elif k == "scope":
                out[k] = "scope"
            else:
                out[k] = masked(v)
        return out
    if isinstance(obj, list):
        return [masked(v) for v in obj]
    return obj


def traced_run(pkg, clock, bus: bool = False):
    mod = REF_PKG if pkg.ref else PORT_PKG
    hv = mod.Hypervisor(state=pkg.state(), event_bus=mod.HypervisorEventBus()) if bus else None
    if hv is not None:
        same_health_on_every_run(hv)
    st = hv.state if bus else pkg.state()
    rich_sequence(st, pkg, 7)
    return st, hv


def test_session_trace_span_trees_match_reference():
    def run(pkg, clock):
        st, _ = traced_run(pkg, clock)
        slots = sorted(st._audit_rows)[:3]
        traces = {s: [tree(sp) for sp in st.session_trace(s)] for s in slots}
        return slots, traces

    ref, port = both(run)
    assert port[0] == ref[0] and len(port[0]) == 3
    assert port[1] == ref[1]
    annotated = [e for spans in port[1].values() for root in spans[-1:]
                 for e in _walk_events(root)]
    assert any(e["name"] == "audit.delta_recorded" for e in annotated)


def _walk_events(t):
    yield from t[6]
    for c in t[7]:
        yield from _walk_events(c)


def test_flight_summary_matches_reference():
    def run(pkg, clock):
        st, _ = traced_run(pkg, clock)
        out = st.flight_summary()
        for w in out["recent_waves"]:
            w["duration_us"] = "t"
        return out

    ref, port = both(run)
    assert port == ref
    assert port["ring_cursor"] > 0 and port["recent_waves"]


def test_chrome_and_otlp_exports_match_reference_in_structure():
    def run(pkg, clock):
        st, _ = traced_run(pkg, clock)
        tr = tracing_mod(pkg)
        spans = st.tracer.drain()
        slot = sorted(st._audit_rows)[0]
        annotated = st.session_trace(slot)
        return (masked(tr.to_chrome_trace(spans, st.tracer)),
                masked(tr.to_otlp(spans, st.tracer)), masked(tr.to_otlp(annotated)),
                masked(tr.to_chrome_trace(annotated)))

    ref, port = both(run)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert b == a, f"export {i} diverged"
    assert port[0]["traceEvents"] and port[1]["resourceSpans"][0]["scopeSpans"][0]["spans"]


def test_unix_anchor_orders_the_otlp_times():
    st = PORT.state()
    rich_sequence(st, PORT, 1)
    spans = st.tracer.drain()
    otlp = port_tracing.to_otlp(spans, st.tracer)["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert all(s["endTimeUnixNano"] >= s["startTimeUnixNano"] for s in otlp)
    assert st.tracer.unix_us(0.0) == st.tracer._unix0 * 1e6
    assert otlp[0]["startTimeUnixNano"] >= int(st.tracer._unix0 * 1e9) - 1


def test_bus_events_join_onto_the_spans():
    def run(pkg, clock):
        st, hv = traced_run(pkg, clock, bus=True)
        spans = st.tracer.drain()
        n = tracing_mod(pkg).attach_bus_events(spans, hv.event_bus)
        events = [masked(e) for root in spans for sp in root.walk() for e in sp.events]
        return n, events

    ref, port = both(run)
    assert port == ref


def test_trace_context_child_matches_reference():
    for word in (0, 1, 0xDEADBEEF, 0xFFFFFFFF):
        for stage in port_tracing.TRACE_STAGES:
            p = port_tracing.TraceContext(trace=5, span=word, wave_seq=3, sampled=True)
            r = jax_tracing.TraceContext(trace=5, span=word, wave_seq=3, sampled=True)
            assert int(p.child(stage).span) == int(r.child(stage).span)
            assert p.child(stage).wave_seq == 3


def test_closed_brackets_reach_the_watchdog():
    seen = []
    tracer = port_tracing.Tracer(capacity=16, device="cpu")
    tracer.health = type("Watch", (), {"observe_wave": lambda self, r: seen.append(r)})()
    h = tracer.begin_wave("saga_round", sessions=[1], lanes=4)
    tracer.end_wave(h, tracer.table)
    assert seen == [h.record] and tracer.last_closed is h.record
