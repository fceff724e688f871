"""Observability plane: the metrics table's layout, causal trace ids, the
flight recorder (`tracing`) and the structured event bus (`event_bus`),
whose rows the facade mirrors into the device EventLog."""

from hypervisor_tpu_torch.observability import metrics, tracing
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
    "metrics",
    "tracing",
]
