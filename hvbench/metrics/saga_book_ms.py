"""Host milliseconds a call in the harness's `saga_book` span: the saga
scheduler's bookings (`saga_round`, kernel B7 on the card, and
`fanout_settle`) over every round, enqueue and outcome packing, over the
measured window."""


def read(t):
    total = t.spans_ms.get("saga_book")
    return None if total is None or not t.calls_ms else total / len(t.calls_ms)
