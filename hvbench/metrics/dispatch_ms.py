"""Host milliseconds a call enqueuing the fused wave (`state._WAVE`, the
instrumented `ops.pipeline.governance_wave`), less the gateway's and the
epilogue's enqueue inside it, over the measured window."""


def read(t):
    total = t.spans_ms.get("dispatch")
    if total is None or "gateway" not in t.spans_ms or not t.calls_ms:
        return None
    net = total - t.spans_ms["gateway"] - t.spans_ms.get("epilogue", 0.0)
    return net / len(t.calls_ms)
