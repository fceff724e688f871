"""Degraded-mode policy: what keeps flowing when the supervisor sheds.

A leaf module on purpose — `hypervisor_tpu_torch.state` imports it to enforce
the policy at the dispatch sites (admission staging, saga fan-out), so
nothing here may import back into the state/runtime layers.

The policy table (docs/OPERATIONS.md "Recovery & fault domains"):

    path                       degraded behaviour
    ─────────────────────────  ──────────────────────────────────────
    enqueue_join               REFUSED (DegradedModeRefusal) — new
                               admissions are load the plane sheds;
                               with `admission_sigma_floor` set and
                               `shed_admissions` off, ONLY joins below
                               the floor shed (the sybil damper's
                               targeted posture — honest traffic flows)
    fanout_dispatch            PAUSED (empty work list) — saga groups
                               stay PENDING until the mode exits
    terminate_sessions         FLOWS — draining live work is exactly
                               what a degraded plane must keep doing
    stage_delta / flush_deltas FLOWS — audit commits must never stall
    saga_round (cursor walk)   FLOWS — in-flight sagas settle

Shedding refuses LOUDLY (an exception, not a silent -1): a caller that
treats a shed join as "queued" would wait forever on an admission that
was never staged.

The **admission-rate sybil damper** (`AdmissionDamper`) also lives here
— a leaf by the same rule, consulted by `HypervisorState.enqueue_join`.
It watches the join stream through a sliding window of (timestamp,
sigma) samples; when the arrival rate exceeds `rate_threshold` AND the
low-sigma fraction exceeds `low_sigma_fraction`, it installs a TARGETED
`DegradedPolicy` (admission_sigma_floor set, shed_admissions off) so
the flood sheds at the gate — before a sybil can consume a staging slot
or an agent row — while honest joins keep flowing. The damper removes
ONLY the policy it installed (identity-checked), so it composes with a
supervisor that flips the full shed policy for its own reasons.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque


#: Fallback policy-swap lock for state-like objects without a
#: `_policy_lock` (e.g. bare test doubles); real HypervisorStates carry
#: their own.
_FALLBACK_POLICY_LOCK = threading.Lock()


class DegradedModeRefusal(RuntimeError):
    """An operation shed by the active degraded-mode policy."""


class SybilShedRefusal(DegradedModeRefusal):
    """A low-sigma join shed by the admission-rate sybil damper."""


@dataclasses.dataclass(frozen=True)
class DegradedPolicy:
    """What the supervisor flips on when thresholds trip.

    Frozen: the active policy is shared state read on dispatch paths
    from any thread — mode changes swap the whole object
    (`HypervisorState.degraded_policy`), never mutate one in place.

    `admission_sigma_floor` is the sybil damper's targeted variant:
    when > 0 (and `shed_admissions` is off) only joins whose sigma_raw
    falls below the floor are refused — a flood of low-trust identities
    damps while honest admissions keep flowing.
    """

    shed_admissions: bool = True
    pause_saga_fanout: bool = True
    admission_sigma_floor: float = 0.0
    reason: str = ""
    entered_at: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class AdmissionDamper:
    """Sliding-window join-rate monitor that trips the targeted shed.

    Attach with `state.admission_damper = AdmissionDamper(...)`;
    `enqueue_join` calls `note_join(sigma_raw, now)` on every staging
    attempt (BEFORE the shed gate decides). The damper is deliberately
    clock-explicit — `now` is the state's epoch-relative device time —
    so a seeded scenario replay sees the identical trip schedule.

    Trip condition, evaluated over the last `window_seconds`:

        joins/s > rate_threshold  AND  low-sigma fraction > low_sigma_fraction

    where "low sigma" means sigma_raw < `sigma_floor`. On trip the
    damper installs `DegradedPolicy(shed_admissions=False,
    admission_sigma_floor=sigma_floor)` onto the state (only if no
    policy is already active — a supervisor's full shed outranks the
    targeted one) and holds it until the windowed rate falls back under
    `exit_rate` (default: half the trip rate), then removes it — but
    only the exact policy object it installed.
    """

    def __init__(
        self,
        *,
        rate_threshold: float = 50.0,
        low_sigma_fraction: float = 0.5,
        sigma_floor: float = 0.5,
        window_seconds: float = 1.0,
        exit_rate: float | None = None,
    ) -> None:
        if rate_threshold <= 0 or window_seconds <= 0:
            raise ValueError("rate_threshold and window_seconds must be > 0")
        self.rate_threshold = rate_threshold
        self.low_sigma_fraction = low_sigma_fraction
        self.sigma_floor = sigma_floor
        self.window_seconds = window_seconds
        self.exit_rate = (
            exit_rate if exit_rate is not None else rate_threshold / 2.0
        )
        self._window: deque[tuple[float, bool]] = deque()
        self._installed: DegradedPolicy | None = None
        # enqueue_join is documented multi-producer and calls note_join
        # BEFORE the staging lock; the check-then-act on _installed /
        # state.degraded_policy must not race (an orphaned policy would
        # shed low-sigma joins forever).
        self._lock = threading.Lock()
        self.trips = 0
        self.damped = 0  # joins refused while our policy was active

    # -- accounting (called by the state's admission path) ---------------

    def _expire(self, now: float) -> None:
        horizon = now - self.window_seconds
        while self._window and self._window[0][0] <= horizon:
            self._window.popleft()

    def windowed_rate(self, now: float) -> float:
        with self._lock:
            self._expire(now)
            return len(self._window) / self.window_seconds

    def note_join(self, state, sigma_raw: float, now: float) -> None:
        """Record one join attempt and (un)install the targeted policy.

        Runs BEFORE the shed gate so the attempt that crosses the
        threshold is already damped. Never raises — the gate does.
        Serialized: concurrent producers stage joins outside any lock,
        so the check-then-act on the installed policy must not race.
        """
        policy = None
        with self._lock:
            self._expire(now)
            self._window.append((now, sigma_raw < self.sigma_floor))
            n = len(self._window)
            rate = n / self.window_seconds
            low = sum(1 for _, is_low in self._window if is_low)
            # Policy swaps happen under the STATE's policy lock (shared
            # with the supervisor's escalation path): identity checks
            # and writes on `state.degraded_policy` must be one atomic
            # step, or our uninstall could clear a full-shed policy the
            # supervisor swapped in between check and write.
            policy_lock = (
                getattr(state, "_policy_lock", None) or _FALLBACK_POLICY_LOCK
            )
            if self._installed is None:
                trip = (
                    rate > self.rate_threshold
                    and low / n > self.low_sigma_fraction
                )
                if trip:
                    with policy_lock:
                        if state.degraded_policy is None:
                            policy = DegradedPolicy(
                                shed_admissions=False,
                                pause_saga_fanout=False,
                                admission_sigma_floor=self.sigma_floor,
                                reason=(
                                    f"sybil flood damped: {rate:.0f} "
                                    f"joins/s ({low}/{n} below sigma "
                                    f"{self.sigma_floor:.2f})"
                                ),
                                entered_at=now,
                            )
                            state.degraded_policy = policy
                            self._installed = policy
                            self.trips += 1
            else:
                with policy_lock:
                    if state.degraded_policy is self._installed:
                        if rate < self.exit_rate:
                            state.degraded_policy = None
                            self._installed = None
                    else:
                        # Someone else replaced or cleared our policy
                        # (e.g. a supervisor escalation swapped in the
                        # full shed); forget the stale handle.
                        self._installed = None
        if policy is not None:
            # Health-plane fan-out OUTSIDE the lock (listener sets may
            # do real work; the facade bridges the kind onto the bus as
            # `adversarial.sybil_damped`).
            health = getattr(state, "health", None)
            if health is not None:
                health.emit_event("sybil_damped", policy.to_dict())

    def forget_installed(self) -> None:
        """Drop the installed-policy handle WITHOUT touching any state
        (used when the state object itself was replaced, e.g. a
        supervisor restore): the damper re-trips from its own window
        if the flood is still live."""
        with self._lock:
            self._installed = None

    def note_damped(self) -> None:
        with self._lock:
            self.damped += 1

    @property
    def active(self) -> bool:
        with self._lock:
            return self._installed is not None

    def summary(self) -> dict:
        with self._lock:
            return {
                "rate_threshold": self.rate_threshold,
                "low_sigma_fraction": self.low_sigma_fraction,
                "sigma_floor": self.sigma_floor,
                "window_seconds": self.window_seconds,
                "active": self._installed is not None,
                "trips": self.trips,
                "damped": self.damped,
            }


__all__ = [
    "AdmissionDamper",
    "DegradedModeRefusal",
    "DegradedPolicy",
    "SybilShedRefusal",
]
