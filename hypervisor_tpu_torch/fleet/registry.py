"""Seeded, digest-replayable heartbeat/lease plane for the fleet.

The liveness truth the shard-out needs: each worker holds a lease the
registry evaluates on the CALLER'S clock — the same discipline as the
SLO engine (`observability.slo`): the registry never reads wall time,
so a recorded observation schedule replays to a bit-identical
transition log and digest. Expiry walks alive -> suspected -> dead one
step at a time (never skipping a state), and recovery walks back
dead -> suspected -> alive with hysteresis: one on-time heartbeat is
not enough — `recover_beats` consecutive beats promote one step, so a
flapping worker cannot oscillate the fleet view every window.

Transitions fan out through the health plane (`HealthMonitor.
emit_event` -> `fleet.*` bus EventTypes via the core facade bridge) —
push0's detect half of detect-and-reassign (PAPERS.md): detection of a
SIGKILLed worker is pinned at <= 2 heartbeat windows by the kill drill
(`benchmarks/bench_suite.py --fleet`, verify gate 6k).

Every `HV_FLEET_*` knob is read per call (`LeaseConfig.from_env`),
never at import time (hvlint HVA002).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Callable, Optional

ALIVE = "alive"
SUSPECTED = "suspected"
DEAD = "dead"

#: The lease chain: transitions only step between adjacent entries —
#: the "never skip a state" invariant the property tests pin.
_CHAIN = (ALIVE, SUSPECTED, DEAD)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


@dataclasses.dataclass(frozen=True)
class LeaseConfig:
    """Lease-plane knobs. `from_env` resolves `HV_FLEET_*` per call
    (HVA002: no import-time env reads)."""

    #: One heartbeat window (seconds) — workers beat once per window.
    heartbeat_interval_s: float = 0.25
    #: Whole missed windows before alive flips to suspected (expiry
    #: compares `windows_since_beat >= suspect_windows`).
    suspect_windows: float = 1.0
    #: Missed windows before suspected flips to dead. The kill-drill
    #: budget is "detection <= 2 windows": with >= expiry the default
    #: lands DEAD exactly at the second missed window.
    dead_windows: float = 2.0
    #: Hysteresis: consecutive heartbeats required to promote ONE step
    #: back toward alive (dead -> suspected -> alive).
    recover_beats: int = 2

    @classmethod
    def from_env(cls, **overrides) -> "LeaseConfig":
        kw = {
            "heartbeat_interval_s": _env_float(
                "HV_FLEET_HEARTBEAT_S", cls.heartbeat_interval_s
            ),
            "suspect_windows": _env_float(
                "HV_FLEET_SUSPECT_WINDOWS", cls.suspect_windows
            ),
            "dead_windows": _env_float(
                "HV_FLEET_DEAD_WINDOWS", cls.dead_windows
            ),
            "recover_beats": _env_int(
                "HV_FLEET_RECOVER_BEATS", cls.recover_beats
            ),
        }
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class LeaseTransition:
    """One lease state change, keyed for replay like `BurnRateAlert`."""

    seq: int
    worker: str
    old: str
    new: str
    now: float  # caller's clock

    def replay_key(self) -> str:
        return (
            f"{self.seq}|{self.worker}|{self.old}->{self.new}"
            f"|{round(self.now, 6)}"
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


#: Health fan-out kind per new state (the core facade bridges these
#: onto the `fleet.*` bus EventTypes).
_KIND_OF = {
    ALIVE: "fleet_worker_recovered",
    SUSPECTED: "fleet_worker_suspected",
    DEAD: "fleet_worker_dead",
}


class FleetRegistry:
    """Heartbeat ledger + lease state machine over the caller's clock.

    Deterministic by construction: `register`/`heartbeat`/`evaluate`
    take the caller's `now`, every observation is journaled, and
    `replay()` re-runs a journal through a fresh registry — same seed
    + same observations => identical transition log and digest (the
    gate-6k bit-identity pin).
    """

    def __init__(
        self,
        config: Optional[LeaseConfig] = None,
        seed: int = 0,
        emit: Optional[Callable[[str, dict], None]] = None,
        metrics=None,
    ) -> None:
        self.config = config or LeaseConfig.from_env()
        self.seed = int(seed)
        self.emit = emit
        self.metrics = metrics
        self._workers: dict[str, dict] = {}
        self.transitions: list[LeaseTransition] = []
        self._observations: list[tuple] = []
        self._digest = hashlib.sha256(f"fleet:{self.seed}".encode())
        self._seq = 0

    # ── observations (the replayable journal) ────────────────────────

    def register(self, worker: str, now: float) -> None:
        """A worker joined the fleet: lease starts alive."""
        now = round(float(now), 6)
        self._observations.append(("register", worker, now))
        if worker in self._workers:
            return
        self._workers[worker] = {
            "state": ALIVE, "last_beat": now, "streak": 0, "joined": now,
        }
        self._record(worker, "joined", ALIVE, now, kind="fleet_worker_joined")

    def heartbeat(self, worker: str, now: float) -> None:
        """One observed heartbeat. Recovery is hysteretic: a worker
        past alive needs `recover_beats` CONSECUTIVE beats to promote
        one step back along the chain — never skipping suspected."""
        now = round(float(now), 6)
        self._observations.append(("beat", worker, now))
        w = self._workers.get(worker)
        if w is None:
            return
        gap = now - w["last_beat"]
        w["last_beat"] = now
        if w["state"] == ALIVE:
            w["streak"] = 0
            return
        # "Consecutive" means no missed window between beats: a gap
        # wider than one heartbeat interval breaks the recovery run.
        if gap > max(1e-9, float(self.config.heartbeat_interval_s)):
            w["streak"] = 0
        w["streak"] += 1
        if w["streak"] >= max(1, int(self.config.recover_beats)):
            w["streak"] = 0
            step_back = _CHAIN[_CHAIN.index(w["state"]) - 1]
            self._transition(worker, w, step_back, now)

    def evaluate(self, now: float) -> dict[str, str]:
        """Expire leases against the caller's clock: one step per call
        per worker at most (alive -> suspected, then suspected -> dead
        on a LATER evaluate) — expiry cannot skip suspected either."""
        now = round(float(now), 6)
        self._observations.append(("eval", now))
        interval = max(1e-9, float(self.config.heartbeat_interval_s))
        for worker, w in self._workers.items():
            windows = (now - w["last_beat"]) / interval
            if w["state"] == ALIVE and windows >= self.config.suspect_windows:
                w["streak"] = 0
                self._transition(worker, w, SUSPECTED, now)
            elif w["state"] == SUSPECTED and windows >= self.config.dead_windows:
                w["streak"] = 0
                self._transition(worker, w, DEAD, now)
        return self.states()

    # ── transition log + digest ──────────────────────────────────────

    def _transition(self, worker: str, w: dict, new: str, now: float) -> None:
        old = w["state"]
        assert abs(_CHAIN.index(new) - _CHAIN.index(old)) == 1, (old, new)
        w["state"] = new
        self._record(worker, old, new, now, kind=_KIND_OF[new])

    def _record(
        self, worker: str, old: str, new: str, now: float, kind: str
    ) -> None:
        t = LeaseTransition(self._seq, worker, old, new, now)
        self._seq += 1
        self.transitions.append(t)
        self._digest.update(t.replay_key().encode())
        if self.metrics is not None:
            from hypervisor_tpu_torch.observability import metrics as mp

            self.metrics.inc(mp.FLEET_LEASE_TRANSITIONS)
        if self.emit is not None:
            self.emit(kind, {
                "worker": worker, "seq": t.seq, "from": old, "to": new,
                "now": now,
            })

    def transition_digest(self) -> str:
        """sha256 over seed + every transition's replay key — the
        alert-digest discipline: bit-identical across replays of the
        same observation journal."""
        return self._digest.hexdigest()

    # ── views ────────────────────────────────────────────────────────

    def state_of(self, worker: str) -> Optional[str]:
        w = self._workers.get(worker)
        return None if w is None else w["state"]

    def states(self) -> dict[str, str]:
        return {w: rec["state"] for w, rec in self._workers.items()}

    def counts(self) -> dict[str, int]:
        out = {ALIVE: 0, SUSPECTED: 0, DEAD: 0}
        for rec in self._workers.values():
            out[rec["state"]] += 1
        return out

    @property
    def observations(self) -> tuple:
        return tuple(self._observations)

    def summary(self, tail: int = 16) -> dict:
        """JSON-able lease-plane view (the /debug/fleet registry block)."""
        return {
            "seed": self.seed,
            "config": dataclasses.asdict(self.config),
            "workers": {
                w: {
                    "state": rec["state"],
                    "last_beat": rec["last_beat"],
                    "joined": rec["joined"],
                }
                for w, rec in sorted(self._workers.items())
            },
            "counts": self.counts(),
            "transitions": [
                t.to_dict() for t in self.transitions[-tail:]
            ],
            "transition_count": len(self.transitions),
            "transition_digest": self.transition_digest(),
        }

    # ── replay ───────────────────────────────────────────────────────

    @classmethod
    def replay(
        cls,
        observations,
        config: Optional[LeaseConfig] = None,
        seed: int = 0,
    ) -> "FleetRegistry":
        """Re-run a recorded observation journal through a fresh
        registry (no emit hook, no metrics — pure state machine)."""
        reg = cls(config=config, seed=seed)
        for obs in observations:
            if obs[0] == "register":
                reg.register(obs[1], obs[2])
            elif obs[0] == "beat":
                reg.heartbeat(obs[1], obs[2])
            elif obs[0] == "eval":
                reg.evaluate(obs[1])
            else:  # pragma: no cover — unknown journal rows are a bug
                raise ValueError(f"unknown observation {obs!r}")
        return reg


__all__ = [
    "ALIVE",
    "SUSPECTED",
    "DEAD",
    "FleetRegistry",
    "LeaseConfig",
    "LeaseTransition",
]
