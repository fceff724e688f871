"""Device milliseconds a call: the union of the device's intervals in the
profiled window of whole calls (torch.profiler), over its calls."""


def read(t):
    p = t.profile
    if p is None or not p.calls or p.busy_s <= 0:
        return None
    return p.busy_s * 1e3 / p.calls
