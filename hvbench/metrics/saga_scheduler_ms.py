"""Host milliseconds a call that `SagaScheduler.run_until_settled` spends
outside the table's reads and bookings: the harness's `scheduler` span
less its `saga_reads` and `saga_book` spans, i.e. the scheduler's own
Python (work lists into coroutines, the retry ladder's bookkeeping, the
outcome dicts) and the executors' awaits on the event loop, over the
measured window."""


def read(t):
    total = t.spans_ms.get("scheduler")
    if total is None or not t.calls_ms:
        return None
    net = total - t.spans_ms.get("saga_reads", 0.0) - t.spans_ms.get("saga_book", 0.0)
    return net / len(t.calls_ms)
