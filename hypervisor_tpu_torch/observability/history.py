"""HistoryPlane: tiered retained telemetry — the hindsight substrate.

Every observatory before round 19 is point-in-time: the drain that
shows degraded mode flipping has already overwritten the state that
caused it. This plane retains history WITHOUT a second drain: each
`state.metrics_snapshot()` (the system's ONE `device_get`) also feeds
a frozen sample of a DECLARED series set into tiered host-side ring
buffers:

    tier 0  raw samples            (t, value)
    tier 1  every FOLD raw points  (t_start, t_end, count, min, max, sum, last)
    tier 2  every FOLD tier-1 pts  same shape, FOLD² raw points each

Folding happens in accumulators that are independent of the retention
rings, so evicting a raw point never loses information a coarser tier
still carries — min/max/count/sum/last are CONSERVED across tier
boundaries (`verify_conservation` proves it exactly at any moment,
and the seeded property tests in `tests/unit/test_history.py` pin the
per-point fold identities).

Determinism contract (the `SignalSnapshot`/`FleetSnapshot` discipline):
timestamps are the CALLER'S clock — a virtual-clock soak feeding
`sample(values, now=vclock)` replays to a bit-identical `digest()`;
nothing in this module reads wall clock. Memory is bounded by
`HV_HISTORY_*` env knobs read PER CALL (`HistoryConfig.from_env`, the
LeaseConfig pattern — never at import time, hvlint HVA002), and every
evicted point is counted loudly (`hv_history_evictions`).
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Mapping, Optional

from hypervisor_tpu_torch.observability.snapshot import rule_digest

#: The declared series set sampled when the caller does not choose:
#: the load axis (waves/admissions/sessions), the failure axes the
#: incident taxonomy triggers on (stragglers, degraded entries, sheds,
#: integrity violations), and the compile canary.
DEFAULT_SERIES: tuple[str, ...] = (
    "hv_governance_wave_ticks_total",
    "hv_admission_admitted_total",
    "hv_admission_refused_total",
    "hv_sessions_live",
    "hv_sessions_archived_total",
    "hv_compiles_total",
    "hv_recompiles_total",
    "hv_wave_stragglers_total",
    "hv_degraded_entries_total",
    "hv_admissions_shed_total",
    "hv_integrity_violations_total",
)


@dataclasses.dataclass(frozen=True)
class HistoryConfig:
    """Retention budget, read from env PER CALL (HVA002: no
    import-time `HV_*` reads — the `LeaseConfig.from_env` pattern)."""

    raw_points: int = 256       #: tier-0 ring capacity, per series
    tier_points: int = 256      #: tier-1/2 ring capacity, per series
    fold: int = 10              #: raw points folded per tier-1 point

    @classmethod
    def from_env(cls) -> "HistoryConfig":
        def _i(name: str, default: int, floor: int) -> int:
            try:
                return max(floor, int(os.environ.get(name, default)))
            except ValueError:
                return default

        return cls(
            raw_points=_i("HV_HISTORY_RAW_POINTS", cls.raw_points, 8),
            tier_points=_i("HV_HISTORY_TIER_POINTS", cls.tier_points, 8),
            fold=_i("HV_HISTORY_FOLD", cls.fold, 2),
        )


def _fold_raw(points) -> tuple:
    """Collapse raw (t, v) points into one tier-1 aggregate point:
    (t_start, t_end, count, min, max, sum, last)."""
    vals = [v for _, v in points]
    return (
        points[0][0], points[-1][0], len(points),
        min(vals), max(vals), sum(vals), vals[-1],
    )


def _fold_aggs(points) -> tuple:
    """Collapse tier-N aggregate points into one tier-N+1 point,
    conserving min-of-mins / max-of-maxes / count / sum / last."""
    return (
        points[0][0], points[-1][1],
        sum(p[2] for p in points),
        min(p[3] for p in points),
        max(p[4] for p in points),
        sum(p[5] for p in points),
        points[-1][6],
    )


def _agg_dict(p: tuple) -> dict:
    return {
        "t_start": p[0], "t_end": p[1], "count": p[2],
        "min": p[3], "max": p[4], "mean": p[5] / p[2] if p[2] else 0.0,
        "last": p[6],
    }


class _SeriesHistory:
    """One series' three rings + fold accumulators + running totals."""

    __slots__ = ("raw", "tiers", "acc1", "acc2", "totals", "folded_out")

    def __init__(self) -> None:
        self.raw: collections.deque = collections.deque()
        self.tiers = (collections.deque(), collections.deque())
        self.acc1: list = []    # raw points awaiting the tier-1 fold
        self.acc2: list = []    # tier-1 points awaiting the tier-2 fold
        # Running whole-history aggregate (never evicted) and the fold
        # of every tier-2 point evicted from its ring — together they
        # make `verify_conservation` exact at any moment.
        self.totals: Optional[tuple] = None
        self.folded_out: Optional[tuple] = None


class HistoryPlane:
    """Tiered ring-buffer history over a declared series set.

    `sample()` is the ONLY writer and is fed from the already-drained
    host-side snapshot — zero extra `device_get` on the clean path.
    `query()`/`window()` read on the caller's clock; `digest()` is the
    replay pin (rule inputs only: retained points + counts)."""

    def __init__(self, series=DEFAULT_SERIES, metrics=None) -> None:
        self.series: tuple[str, ...] = tuple(series)
        self.metrics = metrics
        self._hist: dict[str, _SeriesHistory] = {
            name: _SeriesHistory() for name in self.series
        }
        self.samples_total = 0
        self.evictions_total = 0
        self._last_now: Optional[float] = None
        self._retained = 0  # running ring-point count (gauge fodder)
        #: (id(registry), handle_count) -> declared handles. The
        #: registry is append-only, so a matching count means the same
        #: prefix — the full walk only reruns after a registration.
        self._handle_cache: tuple = ()

    # ── the one writer ───────────────────────────────────────────────

    def sample_snapshot(self, snap, now: float) -> int:
        """Sample the declared series out of a drained
        `MetricsSnapshot` (counter/gauge rows looked up by name; a
        name absent from the registry is skipped, not an error)."""
        handles = snap.registry.handles
        key = (id(snap.registry), len(handles))
        if not self._handle_cache or self._handle_cache[0] != key:
            self._handle_cache = (key, tuple(
                h for h in handles
                if h.name in self._hist and h.kind in ("counter", "gauge")
            ))
        values: dict[str, float] = {}
        for handle in self._handle_cache[1]:
            if handle.name not in values:
                if handle.kind == "counter":
                    values[handle.name] = float(snap.counter(handle))
                else:
                    values[handle.name] = float(snap.gauge(handle))
        return self.sample(values, now)

    def sample(self, values: Mapping[str, float], now: float) -> int:
        """Append one frozen sample (caller's clock). Returns points
        evicted this call — the bounded budget counting losses."""
        cfg = HistoryConfig.from_env()
        now = round(float(now), 6)
        evicted = 0
        for name, value in values.items():
            h = self._hist.get(name)
            if h is None:
                continue
            v = float(value)
            point = (now, v)
            h.raw.append(point)
            self._retained += 1
            # Whole-history running aggregate (conservation witness) —
            # the 2-point merge inlined: this runs once per series per
            # drain, and the generic `_fold_aggs` generators were the
            # measured clean-path hot spot.
            t = h.totals
            h.totals = (now, now, 1, v, v, v, v) if t is None else (
                t[0], now, t[2] + 1,
                v if v < t[3] else t[3],
                v if v > t[4] else t[4],
                t[5] + v, v,
            )
            # The fold cascade: accumulators, independent of rings.
            h.acc1.append(point)
            if len(h.acc1) >= cfg.fold:
                t1 = _fold_raw(h.acc1)
                h.acc1.clear()
                h.tiers[0].append(t1)
                h.acc2.append(t1)
                self._retained += 1
                if len(h.acc2) >= cfg.fold:
                    t2 = _fold_aggs(h.acc2)
                    h.acc2.clear()
                    h.tiers[1].append(t2)
                    self._retained += 1
            # Retention trims (budget read this call, so a knob change
            # applies to live rings immediately).
            while len(h.raw) > cfg.raw_points:
                h.raw.popleft()
                evicted += 1
            for tier in h.tiers:
                while len(tier) > cfg.tier_points:
                    p = tier.popleft()
                    if tier is h.tiers[1]:
                        # Tier-2 is the last stop — fold the evicted
                        # aggregate into `folded_out` so conservation
                        # stays exact past the retention horizon.
                        h.folded_out = p if h.folded_out is None else (
                            _fold_aggs([h.folded_out, p])
                        )
                    evicted += 1
        self.samples_total += 1
        self.evictions_total += evicted
        self._retained -= evicted
        self._last_now = now
        self._publish(evicted)
        return evicted

    def _publish(self, evicted: int) -> None:
        # Absolute gauge sets, never counter increments: the plane
        # samples the drain itself, and bumping a counter per drain
        # would make a quiet scrape mutate scrape-visible counters
        # (the drain-idempotence contract).
        if self.metrics is None:
            return
        from hypervisor_tpu_torch.observability import metrics as mp

        self.metrics.gauge_set(mp.HISTORY_SAMPLES, self.samples_total)
        self.metrics.gauge_set(mp.HISTORY_EVICTIONS, self.evictions_total)
        self.metrics.gauge_set(
            mp.HISTORY_POINTS_RETAINED, self.points_retained()
        )

    # ── reads (caller's clock) ───────────────────────────────────────

    def points_retained(self) -> int:
        # Maintained incrementally in `sample()` (the per-drain
        # recount across every ring was measurable on the clean path).
        return self._retained

    def query(
        self,
        series: str,
        start: Optional[float] = None,
        end: Optional[float] = None,
        tier: int = 0,
        limit: int = 0,
    ) -> list[dict]:
        """Retained points of one series/tier whose time range overlaps
        [start, end] (caller's clock; None = unbounded). `limit` keeps
        the NEWEST n points when positive."""
        h = self._hist.get(series)
        if h is None:
            return []
        out: list[dict] = []
        if tier <= 0:
            for t, v in h.raw:
                if (start is None or t >= start) and (
                    end is None or t <= end
                ):
                    out.append({"t": t, "value": v})
        else:
            ring = h.tiers[min(tier, 2) - 1]
            for p in ring:
                if (start is None or p[1] >= start) and (
                    end is None or p[0] <= end
                ):
                    out.append(_agg_dict(p))
        if limit > 0 and len(out) > limit:
            out = out[-limit:]
        return out

    def window(
        self, center: float, before: float, after: float,
        limit_per_tier: int = 32,
    ) -> dict:
        """The incident bundle's history slice: every declared series,
        every tier, clipped around `center` on the caller's clock and
        bounded per tier so bundles stay small."""
        start, end = center - before, center + after
        return {
            "center": round(float(center), 6),
            "start": round(start, 6),
            "end": round(end, 6),
            "series": {
                name: {
                    str(tier): self.query(
                        name, start, end, tier, limit=limit_per_tier
                    )
                    for tier in (0, 1, 2)
                }
                for name in self.series
            },
        }

    def digest(self) -> str:
        """sha256 over the retained rings + counts — bit-identical
        across same-seed virtual-clock replays (rule inputs only: the
        caller's clock feeds every timestamp)."""
        payload = {
            "series": {
                name: {
                    "raw": list(h.raw),
                    "t1": list(h.tiers[0]),
                    "t2": list(h.tiers[1]),
                }
                for name, h in sorted(self._hist.items())
            },
            "samples_total": self.samples_total,
            "evictions_total": self.evictions_total,
        }
        return rule_digest(payload)

    # ── conservation witness ─────────────────────────────────────────

    def verify_conservation(self) -> dict:
        """Prove min/max/count/sum/last survive the tier folds: for
        every series, the whole-history running aggregate must equal
        the fold of (evicted tier-2 mass) + (tier-2 ring) + (tier-1
        points not yet folded down) + (raw points not yet folded) —
        each sample lives in exactly one of those strata."""
        per: dict[str, dict] = {}
        ok = True
        for name, h in self._hist.items():
            if h.totals is None:
                per[name] = {"ok": True, "count": 0}
                continue
            strata: list[tuple] = []
            if h.folded_out is not None:
                strata.append(h.folded_out)
            strata.extend(h.tiers[1])
            strata.extend(h.acc2)
            if h.acc1:
                strata.append(_fold_raw(h.acc1))
            got = _fold_aggs(strata) if strata else None
            match = (
                got is not None
                and got[2] == h.totals[2]
                and got[3] == h.totals[3]
                and got[4] == h.totals[4]
                and abs(got[5] - h.totals[5]) <= 1e-6 * max(
                    1.0, abs(h.totals[5])
                )
                and got[6] == h.totals[6]
            )
            ok = ok and match
            per[name] = {
                "ok": match,
                "count": h.totals[2],
                "expected": _agg_dict(h.totals),
                "got": None if got is None else _agg_dict(got),
            }
        # The incremental retained counter must agree with a recount —
        # the one place the clean-path bookkeeping gets audited.
        recount = sum(
            len(h.raw) + len(h.tiers[0]) + len(h.tiers[1])
            for h in self._hist.values()
        )
        retained_ok = recount == self._retained
        return {
            "ok": ok and retained_ok,
            "retained_ok": retained_ok,
            "series": per,
        }

    def summary(self) -> dict:
        """The `/history/query` no-args payload + hv_top fodder."""
        return {
            "enabled": True,
            "series": list(self.series),
            "samples": self.samples_total,
            "evictions": self.evictions_total,
            "points_retained": self.points_retained(),
            "last_now": self._last_now,
            "digest": self.digest(),
        }


__all__ = [
    "DEFAULT_SERIES",
    "HistoryConfig",
    "HistoryPlane",
]
