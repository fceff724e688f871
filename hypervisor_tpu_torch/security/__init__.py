"""Security subsystem: rate limiting + kill switch."""

from hypervisor_tpu_torch.security.rate_limiter import (
    AgentRateLimiter,
    DEFAULT_RING_LIMITS,
    RateLimitExceeded,
    RateLimitStats,
    TokenBucket,
)
from hypervisor_tpu_torch.security.kill_switch import (
    HandoffStatus,
    KillReason,
    KillResult,
    KillSwitch,
    StepHandoff,
)

__all__ = [
    "AgentRateLimiter",
    "DEFAULT_RING_LIMITS",
    "RateLimitExceeded",
    "RateLimitStats",
    "TokenBucket",
    "HandoffStatus",
    "KillReason",
    "KillResult",
    "KillSwitch",
    "StepHandoff",
]
