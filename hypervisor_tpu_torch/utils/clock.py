"""Injectable time source.

The reference reads `datetime.now` throughout; its tests fake expiry by
back-dating timestamps. The TPU design needs an explicit clock anyway —
device kernels take "now" as a host-supplied f32 scalar per tick — so every
engine here accepts a `clock` callable, and tests can inject a manual one.
"""

from __future__ import annotations

from datetime import datetime, timedelta, timezone
from typing import Callable

Clock = Callable[[], datetime]


def utc_now() -> datetime:
    return datetime.now(timezone.utc)


class ManualClock:
    """Deterministic clock for tests: starts at epoch `start`, advances on demand."""

    def __init__(self, start: datetime | None = None) -> None:
        self._now = start or datetime(2026, 1, 1, tzinfo=timezone.utc)

    def __call__(self) -> datetime:
        return self._now

    def advance(self, seconds: float) -> None:
        self._now += timedelta(seconds=seconds)


def to_unix(dt: datetime) -> float:
    return dt.timestamp()
