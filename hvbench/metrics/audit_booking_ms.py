"""Host milliseconds a call in the harness's `audit_booking` span (`HypervisorState._book_wave_audit`), over the
measured window (the span wraps the program's call from the harness)."""


def read(t):
    total = t.spans_ms.get("audit_booking")
    return None if total is None or not t.calls_ms else total / len(t.calls_ms)
