"""The 95th percentile of every call's latency in the measured window:
host clock around the entry (`run_governance_wave` or
`governance_pipeline`), ended by `torch.cuda.synchronize()`."""

import numpy as np


def read(t):
    return float(np.percentile(t.calls_ms, 95)) if t.calls_ms else None
