"""Paced background Merkle scrubber over the DeltaLog chain
(`hypervisor_tpu.integrity.scrubber.MerkleScrubber`).

A flipped bit inside a delta body or chain digest is semantically
silent: every column still looks legal, but the audit chain no longer
re-hashes to what was committed. The scrubber re-hashes the chain in
budgeted strips, a little per tick, so a full sweep completes on a
bounded cadence without stalling the wave path. Each tick:

  1. snapshots the audit index (session -> ordered DeltaLog rows, plus
     the committed chain head `_chain_seed`) when the previous sweep
     finished,
  2. takes the next `budget` links off the worklist — link i of a
     session verifies sha256(body[row_i] || digest[row_{i-1}]) against
     digest[row_i]; a chain's first surviving link verifies from the zero
     seed only when the session still holds its full history, and the
     last row must equal the committed chain head,
  3. re-validates the strip against the live index (a ring wrap between
     ticks recycles archived sessions' rows), then hashes it as ONE
     batch, lanes padded to the budget: through `ops.merkle.
     verify_chain_links` on the state's device (kernel B1 on CUDA), or
     through the native C++ hash unit (`ops.merkle.
     verify_chain_links_host`: one `sha256_batch` sweep) when the state
     is not on CUDA and the library built (the device alone decides:
     the reference's `HV_SCRUB_NATIVE` has no counterpart here),
  4. reports mismatching rows.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from hypervisor_tpu_torch import u32
from hypervisor_tpu_torch.ops import merkle as merkle_ops


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    try:
        return int(raw) if raw is not None else default
    except ValueError:
        return default


class MerkleScrubber:
    """One deployment's chain scrubber over a `state.HypervisorState`
    (owned by the IntegrityPlane). `budget` defaults to `HV_SCRUB_BUDGET`
    (64)."""

    def __init__(self, state, budget: Optional[int] = None) -> None:
        budget = budget if budget is not None else _env_int("HV_SCRUB_BUDGET", 64)
        if budget <= 0:
            raise ValueError("scrub budget must be positive")
        self.state = state
        self.budget = int(budget)
        # Sweep worklist: [(row, prev_row, use_seed, session)] links, then
        # [(row, session)] head checks, rebuilt per sweep and re-validated
        # against the live audit index at tick time.
        self._links: list[tuple[int, int, bool, int]] = []
        self._heads: list[tuple[int, int]] = []
        self._pos = 0
        self.sweeps_completed = 0
        self.links_verified = 0
        self.heads_verified = 0
        self.stale_skipped = 0
        self.mismatches = 0
        self.last_mismatch: Optional[dict] = None

    # -- worklist -------------------------------------------------------

    def _rebuild_worklist(self) -> None:
        st = self.state
        links: list[tuple[int, int, bool, int]] = []
        heads: list[tuple[int, int]] = []
        for sess in sorted(st._audit_rows):
            rows = st._audit_rows[sess]
            if not rows:
                continue
            if st._turns.get(sess, 0) == len(rows):
                links.append((rows[0], 0, True, sess))  # full history: from the zero seed
            links.extend((rows[i], rows[i - 1], False, sess) for i in range(1, len(rows)))
            if st._chain_seed.get(sess) is not None:
                heads.append((rows[-1], sess))
        self._links = links
        self._heads = heads
        self._pos = 0

    def _fresh_links(self, strip) -> list[tuple[int, int, bool, int]]:
        """Drop strip lanes the live audit index no longer backs: a lane
        is fresh iff its row is still owned by its session and its
        parent relationship still holds; anything else was recycled by a
        ring wrap (skipping it is correct, flagging it would not be)."""
        st = self.state
        pos_of: dict[int, dict[int, int]] = {}
        fresh = []
        for row, prow, use_seed, sess in strip:
            rows_now = st._audit_rows.get(sess)
            if not rows_now:
                self.stale_skipped += 1
                continue
            pos = pos_of.get(sess)
            if pos is None:
                pos = pos_of[sess] = {r: i for i, r in enumerate(rows_now)}
            i = pos.get(row)
            if i is None:
                self.stale_skipped += 1
                continue
            if use_seed:
                if i != 0 or st._turns.get(sess, 0) != len(rows_now):
                    self.stale_skipped += 1
                    continue
            elif i == 0 or rows_now[i - 1] != prow:
                self.stale_skipped += 1
                continue
            fresh.append((row, prow, use_seed, sess))
        return fresh

    @property
    def sweep_size(self) -> int:
        return len(self._links) + len(self._heads)

    @property
    def position(self) -> int:
        return self._pos

    # -- one paced tick -------------------------------------------------

    def tick(self) -> dict:
        """Verify the next budgeted strip; returns the tick report, whose
        `mismatches` carry (kind, row, parent_row or session)."""
        if self._pos >= self.sweep_size:
            self._rebuild_worklist()
        strip = []
        while self._pos < len(self._links) and len(strip) < self.budget:
            strip.append(self._links[self._pos])
            self._pos += 1
        head_strip = []
        while (
            self._pos >= len(self._links)
            and self._pos < self.sweep_size
            and len(strip) + len(head_strip) < self.budget
        ):
            head_strip.append(self._heads[self._pos - len(self._links)])
            self._pos += 1

        strip = self._fresh_links(strip)
        mismatches: list[dict] = []
        log = self.state.delta_log
        if strip:
            b = self.budget
            rows = np.zeros(b, np.int32)
            prev = np.zeros(b, np.int32)
            seed = np.zeros(b, bool)
            valid = np.zeros(b, bool)
            for i, (row, prow, use_seed, _sess) in enumerate(strip):
                rows[i], prev[i], seed[i], valid[i] = row, prow, use_seed, True
            ok = merkle_ops.verify_chain_links_host(log.body, log.digest, rows, prev, seed, valid)
            self.links_verified += len(strip)
            for i, (row, prow, use_seed, _sess) in enumerate(strip):
                if not ok[i]:
                    mismatches.append({
                        "kind": "link", "row": int(row),
                        "parent_row": None if use_seed else int(prow),
                    })
        if head_strip:
            # Heads re-derive from the LIVE index: appends since the
            # snapshot legitimately move a session's tail and head.
            st = self.state
            fresh_heads = []
            for _row, sess in head_strip:
                rows_now = st._audit_rows.get(sess)
                expected = st._chain_seed.get(sess)
                if not rows_now or expected is None:
                    self.stale_skipped += 1
                    continue
                fresh_heads.append((rows_now[-1], np.asarray(expected, np.uint32), sess))
            head_strip = fresh_heads
        if head_strip:
            idx = torch.tensor([r for r, _, _ in head_strip], dtype=torch.int64,
                               device=log.digest.device)
            recorded = u32.to_numpy_u32(log.digest[idx])
            self.heads_verified += len(head_strip)
            for i, (row, expected, sess) in enumerate(head_strip):
                if not np.array_equal(recorded[i], expected):
                    mismatches.append({"kind": "head", "row": int(row), "session": int(sess)})
        sweep_completed = self._pos >= self.sweep_size and self.sweep_size > 0
        if sweep_completed:
            self.sweeps_completed += 1
        if mismatches:
            self.mismatches += len(mismatches)
            self.last_mismatch = mismatches[-1]
        return {
            "links": len(strip),
            "heads": len(head_strip),
            "mismatches": mismatches,
            "sweep_completed": sweep_completed,
            "position": self._pos,
            "sweep_size": self.sweep_size,
        }

    def adopt_stats(self, other: "MerkleScrubber") -> None:
        """Carry another scrubber's cumulative counters (the plane's
        re-attach after a restore: sweep cursors reset, totals don't)."""
        self.sweeps_completed = other.sweeps_completed
        self.links_verified = other.links_verified
        self.heads_verified = other.heads_verified
        self.stale_skipped = other.stale_skipped
        self.mismatches = other.mismatches
        self.last_mismatch = other.last_mismatch

    def summary(self) -> dict:
        return {
            "budget": self.budget,
            "position": self._pos,
            "sweep_size": self.sweep_size,
            "sweeps_completed": self.sweeps_completed,
            "links_verified": self.links_verified,
            "heads_verified": self.heads_verified,
            "stale_skipped": self.stale_skipped,
            "mismatches": self.mismatches,
            "last_mismatch": self.last_mismatch,
        }
