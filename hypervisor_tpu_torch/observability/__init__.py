"""Observability plane: the metrics registry and its drain (`metrics`),
causal trace ids, the flight recorder (`tracing`), the structured event
bus (`event_bus`), whose rows the facade mirrors into the device
EventLog, the runtime health plane (`health`: compile telemetry around
the dispatch entries, occupancy over the `footprint()` protocol, the
wave watchdog) and the hindsight plane (`history`, `incidents`). The
roofline and profiling observatories arrive with a later slice (ROADMAP
A4b), the SLO engine and the critical-path attribution with the serving
plane (A5)."""

from hypervisor_tpu_torch.observability import health, history, incidents, metrics, tracing
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
    "device_key_of",
    "fnv1a32",
    "health",
    "history",
    "incidents",
    "metrics",
    "tracing",
]
