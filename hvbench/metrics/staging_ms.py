"""Host milliseconds a call in the harness's `staging` span (`HypervisorState._stage_wave_lanes`), over the
measured window (the span wraps the program's call from the harness)."""


def read(t):
    total = t.spans_ms.get("staging")
    return None if total is None or not t.calls_ms else total / len(t.calls_ms)
