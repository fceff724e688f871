"""Observability plane: the metrics registry and its drain (`metrics`),
causal trace ids, the flight recorder (`tracing`), the structured event
bus (`event_bus`), whose rows the facade mirrors into the device
EventLog, the runtime health plane (`health`: compile telemetry around
the dispatch entries, occupancy over the `footprint()` protocol, the
wave watchdog) and the hindsight plane (`history`, `incidents`).
`attribution` + `slo` are the latency observatory over the serving front
door: per-ticket critical-path decomposition with /metrics exemplars, and
the per-class multi-window burn-rate engine. `roofline` is the roofline
observatory: a process-global registry of byte and instruction models
counted at each program's first dispatch of a signature, joined with the
measured stage walls against the card's peaks. `profiling` opens
`torch.profiler` windows and the `hv.<stage>` ranges."""

from hypervisor_tpu_torch.observability import (
    attribution,
    health,
    history,
    incidents,
    metrics,
    profiling,
    roofline,
    slo,
    tracing,
)
from hypervisor_tpu_torch.observability.causal_trace import (
    CausalTraceId,
    device_key_of,
    fnv1a32,
)
from hypervisor_tpu_torch.observability.event_bus import (
    EventHandler,
    EventType,
    HypervisorEvent,
    HypervisorEventBus,
)

__all__ = [
    "CausalTraceId",
    "EventHandler",
    "EventType",
    "HypervisorEvent",
    "HypervisorEventBus",
    "attribution",
    "device_key_of",
    "fnv1a32",
    "health",
    "history",
    "incidents",
    "metrics",
    "profiling",
    "roofline",
    "slo",
    "tracing",
]
