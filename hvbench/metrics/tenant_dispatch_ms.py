"""Host milliseconds a call enqueuing the tenant arena's batched wave: the
harness's `tenant_dispatch` span around `tenancy.arena._TENANT_WAVE_DONATED`
(the instrumented `ops.pipeline.tenant_governance_wave`: every kernel in
its tenant form, the tallies and the gauges epilogue over the stacked
tables), over the measured window."""


def read(t):
    total = t.spans_ms.get("tenant_dispatch")
    return None if total is None or not t.calls_ms else total / len(t.calls_ms)
