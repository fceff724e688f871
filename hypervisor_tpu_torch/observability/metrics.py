"""The metrics table's layout: the reference registry's row indices.

`hypervisor_tpu.observability.metrics` registers every counter, gauge and
histogram in one declaration order, and a row's index is its position
among its kind. The wave writes only the device-side counters declared
first and one histogram, so this module copies those handles in the
same order (same names, same indices) and the table's row counts; the
rest of the registry ports with the observability plane.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MetricHandle:
    """One registered metric: its name and its row in the table."""

    name: str
    index: int


#: The device-written counters, in the reference's declaration order.
_COUNTER_NAMES = (
    "hv_governance_wave_ticks_total",
    "hv_admission_admitted_total",
    "hv_admission_refused_total",
    "hv_sessions_archived_total",
    "hv_bonds_released_total",
    "hv_saga_steps_committed_total",
    "hv_saga_steps_failed_total",
    "hv_gateway_actions_allowed_total",
    "hv_gateway_actions_denied_total",
    "hv_liability_slashed_total",
    "hv_liability_clipped_total",
    "hv_events_mirrored_total",
)
COUNTERS = tuple(MetricHandle(n, i) for i, n in enumerate(_COUNTER_NAMES))
(
    WAVE_TICKS,
    ADMITTED,
    REFUSED,
    SESSIONS_ARCHIVED,
    BONDS_RELEASED,
    SAGA_STEPS_COMMITTED,
    SAGA_STEPS_FAILED,
    GATEWAY_ALLOWED,
    GATEWAY_DENIED,
    SLASHED,
    CLIPPED,
    EVENTS_MIRRORED,
) = COUNTERS

#: Row counts of the full reference registry (counters, gauges, histograms).
N_COUNTERS = 92
N_GAUGES = 189
N_HISTOGRAMS = 34

#: Lanes per dispatched admission/governance wave; it follows the 13
#: per-stage latency histograms in the reference's declaration order.
WAVE_LANES = MetricHandle("hv_wave_lanes", 13)

#: Shared histogram upper bounds, 2^0 .. 2^24 (+Inf implied).
DEFAULT_BUCKET_BOUNDS_US: tuple[float, ...] = tuple(float(1 << k) for k in range(25))
