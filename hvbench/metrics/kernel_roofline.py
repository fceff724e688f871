"""The chain and root kernels' share of their roofline, in %: the least
time the card needs for the chain and root work the profiled calls'
shapes need (`hvbench.work`: bytes at 3.35 TB/s or integer instructions
at 16.75 T/s, the larger), over the profiled device time of the kernels
whose names hold a fragment listed under `hvbench/kernels/`."""


def read(t):
    p = t.profile
    if p is None or not t.kernel_patterns:
        return None
    spent = sum(s for name, (s, _) in p.ops.items()
                if any(frag in name for frag in t.kernel_patterns))
    if spent <= 0:
        return None
    return 100.0 * t.model_s_per_call * p.calls / spent
