"""The join staging queue (`hypervisor_tpu.runtime.native.StagingQueue`):
structure-of-arrays columns that `enqueue_join` fills one join at a time
and `flush_joins` harvests as one admission wave.

Backed by numpy columns and a cursor. The queue takes no lock of its
own: its one caller, `HypervisorState`, pushes and harvests under its
staging lock, which also guards the host indices that each push updates.
This is the reference's Python fallback. Its native form binds one
global C buffer per process, lock-free for concurrent producers, and
carries a loss detector because a second queue could re-bind that buffer
mid-epoch; with no global buffer here there is nothing to detect.
"""

from __future__ import annotations

import numpy as np


class StagingQueue:
    """One epoch of staged joins: sigma, agent slot, session slot and the
    trustworthy flag per entry, up to `capacity` entries."""

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self.sigma = np.zeros(capacity, np.float32)
        self.agent = np.zeros(capacity, np.int32)
        self.session = np.zeros(capacity, np.int32)
        self.trustworthy = np.zeros(capacity, np.uint8)
        self._cursor = 0

    def push(self, sigma: float, agent: int, session: int, trustworthy: bool = True) -> int:
        """Claim the next entry; returns its index, or -1 when the epoch is
        full (then nothing is staged)."""
        if self._cursor >= self.capacity:
            return -1
        slot = self._cursor
        self._cursor += 1
        self.sigma[slot] = sigma
        self.agent[slot] = agent
        self.session[slot] = session
        self.trustworthy[slot] = trustworthy
        return slot

    def harvest(self) -> tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(n, sigma, agent, session, trustworthy): copies of the epoch's
        n entries in claim order; the next push starts a new epoch."""
        n, self._cursor = self._cursor, 0
        return (n, self.sigma[:n].copy(), self.agent[:n].copy(), self.session[:n].copy(),
                self.trustworthy[:n].copy())
