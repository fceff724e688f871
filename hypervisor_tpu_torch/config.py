"""Typed configuration: the fields of `hypervisor_tpu.config` the governance
wave reads, copied with the same names and defaults, so a configuration
means the same thing in both packages. Later slices add the fields their
modules read."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TrustConfig:
    """Ring thresholds on sigma_eff."""

    ring1_threshold: float = 0.95
    ring2_threshold: float = 0.60


@dataclasses.dataclass(frozen=True)
class RateLimitConfig:
    """Per-ring token-bucket bursts, indexed by ring 0..3."""

    ring_bursts: tuple[float, float, float, float] = (200.0, 100.0, 40.0, 10.0)


@dataclasses.dataclass(frozen=True)
class TableCapacity:
    """Static capacities of the device-resident tables."""

    max_agents: int = 16_384
    max_sessions: int = 4_096
    max_vouch_edges: int = 65_536
    delta_log_capacity: int = 65_536
    trace_log_capacity: int = 8_192


@dataclasses.dataclass(frozen=True)
class HypervisorConfig:
    """Top-level config (the wave's subsystems only)."""

    trust: TrustConfig = TrustConfig()
    rate_limit: RateLimitConfig = RateLimitConfig()
    capacity: TableCapacity = TableCapacity()


DEFAULT_CONFIG = HypervisorConfig()
