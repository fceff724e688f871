"""Host milliseconds a call in the harness's `saga_reads` span: the saga
scheduler's reads of the table (`sagas_settled`, `saga_work`,
`fanout_dispatch`, `saga_timeouts`, `isolation_gate`) over every round,
over the measured window."""


def read(t):
    total = t.spans_ms.get("saga_reads")
    return None if total is None or not t.calls_ms else total / len(t.calls_ms)
