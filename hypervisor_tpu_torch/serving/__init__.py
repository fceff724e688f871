"""Serving front door: continuous admission, deadline-aware wave
batching, and the open-workload soak harness.

The subsystem that turns the fused dispatch floor into a serving
system (ROADMAP item 4):

  * `FrontDoor` — bounded ingestion queues per request class with the
    PR 4 degraded-mode shedding as the overload valve; sheds are typed
    `Refusal` values (HTTP 429 + Retry-After at the API), accepted
    requests are `Ticket`s resolved by the wave that serves them.
  * `WaveScheduler` — coalesces pending requests into shape-bucketed
    waves (a CLOSED set of padded batch shapes, so the jit cache stays
    warm) and dispatches when a bucket fills or a deadline approaches,
    draining through the fused one-program wave paths.
  * `loadgen` — seeded Poisson arrivals, heavy-tailed lifetimes,
    replayable trace files, and `run_soak` (the `bench_suite --soak`
    row gated by `benchmarks/regression.py`).

Round 14 armed the latency observatory over this plane
(`observability.attribution` + `observability.slo`): every `Ticket`
carries a CausalTraceId from submit and resolves with a critical-path
decomposition (queue_wait + pad_wait + wave_wall, partitioning the
measured latency exactly), the front door aggregates per-class
decomposition histograms with `/metrics` exemplars, a per-class
multi-window burn-rate engine alerts onto the event bus (the
supervisor can flip degraded mode on a critical burn), and
`Refusal.retry_after_s` derives from live depth x observed drain rate.
"""

from hypervisor_tpu_torch.serving.front_door import (
    FrontDoor,
    Refusal,
    ServingConfig,
    Ticket,
)
from hypervisor_tpu_torch.serving.loadgen import (
    WorkloadSpec,
    generate_trace,
    load_trace,
    run_soak,
    save_trace,
)
from hypervisor_tpu_torch.serving.scheduler import WaveScheduler

__all__ = [
    "FrontDoor",
    "Refusal",
    "ServingConfig",
    "Ticket",
    "WaveScheduler",
    "WorkloadSpec",
    "generate_trace",
    "load_trace",
    "run_soak",
    "save_trace",
]
