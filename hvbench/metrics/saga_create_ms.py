"""Host milliseconds a call in the harness's `saga_create` span (the call's
`create_sagas` and `create_sagas_from_dsl` blocks), over the measured
window."""


def read(t):
    total = t.spans_ms.get("saga_create")
    return None if total is None or not t.calls_ms else total / len(t.calls_ms)
