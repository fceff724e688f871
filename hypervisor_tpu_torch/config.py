"""Typed configuration: the fields of `hypervisor_tpu.config` the governance
wave (its action gateway and sanitizer included), the saga plane, the
slash cascade, the state's security surface and the facade's host
engines (vouching, the liability ledger, the history verifier) read, copied with the same names and defaults, so a
configuration means the same thing in both packages."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TrustConfig:
    """Ring thresholds on sigma_eff, the Nexus score scale, the vouching
    limits, and the slash cascade's depth, floor and wipe margin."""

    ring1_threshold: float = 0.95
    ring2_threshold: float = 0.60
    score_scale: float = 1000.0          # Nexus 0-1000 -> 0.0-1.0
    min_voucher_sigma: float = 0.50
    default_bond_pct: float = 0.20
    max_exposure: float = 0.80           # of voucher sigma, across vouchees
    max_cascade_depth: int = 2
    sigma_floor: float = 0.05
    cascade_wipe_epsilon: float = 0.01   # sigma_after < floor+eps => cascade


@dataclasses.dataclass(frozen=True)
class BreachConfig:
    """The sliding-window breach detector the gateway runs per action."""

    window_seconds: float = 60.0
    window_capacity: int = 1000
    min_calls_for_analysis: int = 5
    low_threshold: float = 0.3
    medium_threshold: float = 0.5
    high_threshold: float = 0.7
    critical_threshold: float = 0.9
    circuit_breaker_cooldown_seconds: float = 30.0


@dataclasses.dataclass(frozen=True)
class ElevationConfig:
    """Sudo-with-TTL ring elevation: the TTL a grant gets by default and
    the cap on any requested TTL."""

    default_ttl_seconds: float = 300.0
    max_ttl_seconds: float = 3600.0


@dataclasses.dataclass(frozen=True)
class RateLimitConfig:
    """Per-ring token-bucket refill rates (per second) and bursts,
    indexed by ring 0..3."""

    ring_rates: tuple[float, float, float, float] = (100.0, 50.0, 20.0, 5.0)
    ring_bursts: tuple[float, float, float, float] = (200.0, 100.0, 40.0, 10.0)


@dataclasses.dataclass(frozen=True)
class LedgerConfig:
    """Liability-ledger risk weights, the clean-session credit and the
    admission gate's probation and deny thresholds."""

    slash_weight: float = 0.15
    quarantine_weight: float = 0.10
    fault_weight: float = 0.05
    clean_session_credit: float = 0.05
    probation_threshold: float = 0.3
    deny_threshold: float = 0.6


@dataclasses.dataclass(frozen=True)
class QuarantineConfig:
    """How long a quarantine holds a row by default."""

    default_duration_seconds: float = 300.0


@dataclasses.dataclass(frozen=True)
class VerifierConfig:
    """Transaction-history verification: the history depth and hash
    length a trustworthy agent shows."""

    min_history_depth: int = 5
    min_hash_length: int = 16


@dataclasses.dataclass(frozen=True)
class TableCapacity:
    """Static capacities of the device-resident tables."""

    max_agents: int = 16_384
    max_sessions: int = 4_096
    max_vouch_edges: int = 65_536
    max_sagas: int = 8_192
    max_steps_per_saga: int = 16
    max_elevations: int = 4_096
    delta_log_capacity: int = 65_536
    event_log_capacity: int = 65_536
    trace_log_capacity: int = 8_192
    #: Read by no table; kept so a checkpoint's `capacity` record is the
    #: reference's, field for field.
    max_participants_per_session: int = 64


@dataclasses.dataclass(frozen=True)
class HypervisorConfig:
    """Top-level config composing every ported subsystem's knobs."""

    trust: TrustConfig = TrustConfig()
    breach: BreachConfig = BreachConfig()
    elevation: ElevationConfig = ElevationConfig()
    rate_limit: RateLimitConfig = RateLimitConfig()
    ledger: LedgerConfig = LedgerConfig()
    quarantine: QuarantineConfig = QuarantineConfig()
    verifier: VerifierConfig = VerifierConfig()
    capacity: TableCapacity = TableCapacity()


DEFAULT_CONFIG = HypervisorConfig()
