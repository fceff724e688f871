"""Token-bucket rate limiting over the agent table's `rl_tokens` and
`rl_stamp` columns (`hypervisor_tpu.ops.rate_limit`): one branch-free
refill, or refill and consume, for every bucket, with each ring's rate
and burst, and the bucket recreated full when a row's ring changes."""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from hypervisor_tpu_torch.config import DEFAULT_CONFIG, RateLimitConfig


class RateDecision(NamedTuple):
    allowed: torch.Tensor  # bool[N]
    tokens: torch.Tensor   # f32[N] bucket levels after the decision
    stamp: torch.Tensor    # f32[N] refill stamps (all `now`)


def per_ring(ring: torch.Tensor, values: Sequence[float]) -> torch.Tensor:
    """f32 `values[ring]` for rings clamped to 0..3, built from scalars on
    the ring's device (no table crosses from the host)."""
    r = ring.to(torch.int32).clamp(0, 3)
    out = torch.full(r.shape, float(np.float32(values[3])), dtype=torch.float32,
                     device=ring.device)
    for i in (2, 1, 0):
        out = out.masked_fill(r == i, float(np.float32(values[i])))
    return out


def refill(
    tokens: torch.Tensor,
    stamp: torch.Tensor,
    ring: torch.Tensor,
    now: torch.Tensor | float,
    config: RateLimitConfig = DEFAULT_CONFIG.rate_limit,
) -> torch.Tensor:
    """f32[N]: every bucket's level rolled forward to `now`, capped at its
    ring's burst: min(burst, tokens + max(now - stamp, 0) * rate), the
    multiply and the add rounded separately."""
    from hypervisor_tpu_torch.ops.admission import f32_scalar

    now_f = f32_scalar(now, tokens.device)
    elapsed = torch.clamp(now_f - stamp, min=0.0)
    return torch.minimum(per_ring(ring, config.ring_bursts),
                         tokens + elapsed * per_ring(ring, config.ring_rates))


def consume(
    tokens: torch.Tensor,
    stamp: torch.Tensor,
    ring: torch.Tensor,
    now: torch.Tensor | float,
    cost: torch.Tensor | float = 1.0,
    config: RateLimitConfig = DEFAULT_CONFIG.rate_limit,
) -> RateDecision:
    """Refill every bucket to `now`, then take `cost` (a scalar or f32[N])
    from each bucket that covers it; a refused bucket keeps its refilled
    level. Every stamp moves to `now`."""
    from hypervisor_tpu_torch.ops.admission import f32_scalar

    now_f = f32_scalar(now, tokens.device)
    refilled = refill(tokens, stamp, ring, now_f, config)
    cost_t = (cost.to(torch.float32) if isinstance(cost, torch.Tensor)
              else f32_scalar(cost, tokens.device))
    allowed = refilled >= cost_t
    return RateDecision(allowed=allowed, tokens=torch.where(allowed, refilled - cost_t, refilled),
                        stamp=now_f.expand(stamp.shape).clone())


def reset_on_ring_change(
    tokens: torch.Tensor,
    ring_changed: torch.Tensor,
    new_ring: torch.Tensor,
    config: RateLimitConfig = DEFAULT_CONFIG.rate_limit,
) -> torch.Tensor:
    """f32[N]: the buckets recreated full at the new ring's burst where the
    ring changed, the others as they were."""
    return torch.where(ring_changed, per_ring(new_ring, config.ring_bursts), tokens)
