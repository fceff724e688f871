"""Batched intent-lock ops (`hypervisor_tpu.ops.locks`): the conflict
gate, the wait-for closure, the deadlock sweep and contention counts.

The host manager checks one lock request at a time — a scan of the
resource's holders plus a DFS over the wait-for graph
(`session/intent_locks.py`). Here a whole wave of requests is vetted in
one pass on the device its tensors lie on:

  * conflicts — a dense [B, L] compare of the wave against the held-lock
    table through the 3x3 compatibility matrix (only READ+READ coexist),
    projected onto agent rows by one matrix product,
  * deadlock — the wait-for graph's transitive closure by ceil(log2 N)
    boolean matrix squarings, each one matrix product,
  * victim selection — the lowest-trust agent on a closure cycle, for the
    kill switch to break the deadlock.

Both matrix products run in f32 on 0/1 operands, so they are exact
whether or not TF32 is on: 0 and 1 survive TF32's 10-bit mantissa, the
accumulation stays f32, and a sum of at most N < 2^24 ones is an exact
integer. Inputs are fixed-capacity tensors with active masks; hosts
intern agent DIDs and resource paths to rows (`tables.intern.InternTable`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from hypervisor_tpu_torch.session.intent_locks import COMPAT_MATRIX

# compat[held, requested]: True only for READ+READ. The table is shared
# with the host manager, so the wave and the single-call API agree.
INTENT_READ, INTENT_WRITE, INTENT_EXCLUSIVE = 0, 1, 2
COMPAT = np.asarray(COMPAT_MATRIX)


class ConflictResult(NamedTuple):
    blocked: torch.Tensor        # bool[B] request conflicts with >= 1 held lock
    blockers: torch.Tensor       # bool[B, A] which agents block each request
    n_conflicts: torch.Tensor    # int32[B]


def conflict_gate(
    held_path: torch.Tensor,     # int32[L] resource row of each held lock
    held_agent: torch.Tensor,    # int32[L] holder agent row
    held_intent: torch.Tensor,   # int8[L]
    held_active: torch.Tensor,   # bool[L]
    req_path: torch.Tensor,      # int32[B]
    req_agent: torch.Tensor,     # int32[B]
    req_intent: torch.Tensor,    # int8[B]
    n_agents: int,
) -> ConflictResult:
    """Vet B lock requests against L held locks in one dense pass."""
    dev = held_path.device
    same_path = req_path[:, None] == held_path[None, :]          # [B, L]
    other_agent = req_agent[:, None] != held_agent[None, :]
    compat = torch.from_numpy(COMPAT).to(dev)
    incompatible = ~compat[held_intent.to(torch.int64)[None, :],
                           req_intent.to(torch.int64)[:, None]]
    hit = same_path & other_agent & incompatible & held_active[None, :]

    # blockers[b, a] iff some lock held by agent a blocks request b.
    holder_onehot = (held_agent[:, None]
                     == torch.arange(n_agents, dtype=held_agent.dtype, device=dev)[None, :])
    blockers = (hit.to(torch.float32) @ holder_onehot.to(torch.float32)) > 0
    return ConflictResult(
        blocked=hit.any(dim=1),
        blockers=blockers,
        n_conflicts=hit.sum(dim=1, dtype=torch.int32),
    )


def closure_squarings(n: int) -> int:
    """How many squarings `transitive_closure` makes for N agents."""
    return max(1, int(np.ceil(np.log2(max(n, 2)))))


def transitive_closure(wait_for: torch.Tensor) -> torch.Tensor:
    """bool[N, N] -> bool[N, N]: reachability over >= 1 wait-for edges, by
    ceil(log2 N) squarings of the f32 0/1 matrix, min(R + R @ R, 1) each
    (exact whatever the TF32 setting: see the module docstring)."""
    reach = wait_for.to(torch.float32)
    for _ in range(closure_squarings(wait_for.shape[0])):
        reach = torch.clamp(reach + reach @ reach, max=1.0)
    return reach > 0


class DeadlockSweep(NamedTuple):
    on_cycle: torch.Tensor       # bool[N] agent on a wait cycle
    would_deadlock: torch.Tensor # bool[B] granting the request closes a cycle
    victim: torch.Tensor         # int32 lowest-sigma agent on a cycle (-1: none)


def deadlock_sweep(
    wait_for: torch.Tensor,      # bool[N, N] edge a-waits-on-b
    req_agent: torch.Tensor,     # int32[B] requesting agent rows
    req_blockers: torch.Tensor,  # bool[B, N] blockers per request (conflict_gate)
    sigma: torch.Tensor,         # f32[N] trust, for victim ranking
) -> DeadlockSweep:
    """Cycle detection for the standing graph plus a request wave.

    `would_deadlock[b]` mirrors the single-call precheck: the request
    deadlocks iff some blocker already (transitively) waits on the
    requester, or is the requester. The victim is the first lowest-sigma
    row on a cycle (`torch.argmin` returns the first minimum, as
    `jnp.argmin` does)."""
    n = wait_for.shape[0]
    dev = wait_for.device
    reach = transitive_closure(wait_for)
    on_cycle = torch.diagonal(reach)
    req = req_agent.to(torch.int64)
    reaches_requester = reach[:, req].T                          # [B, N]
    self_block = torch.arange(n, dtype=torch.int64, device=dev)[None, :] == req[:, None]
    would = (req_blockers & (reaches_requester | self_block)).any(dim=1)
    sigma_masked = torch.where(on_cycle, sigma, torch.full_like(sigma, math.inf))
    victim = torch.where(on_cycle.any(), torch.argmin(sigma_masked).to(torch.int32),
                         torch.full((), -1, dtype=torch.int32, device=dev))
    return DeadlockSweep(on_cycle=on_cycle, would_deadlock=would, victim=victim)


def contention_counts(
    held_path: torch.Tensor,     # int32[L]
    held_agent: torch.Tensor,    # int32[L]
    held_active: torch.Tensor,   # bool[L]
    n_paths: int,
    n_agents: int,
) -> torch.Tensor:
    """int32[P]: distinct agents holding locks per resource (counts > 1
    are the host manager's `contention_points`)."""
    dev = held_path.device
    path_rows = torch.where(held_active, held_path.to(torch.int64),
                            torch.full_like(held_path, n_paths, dtype=torch.int64))
    # As the reference's scatter: negative rows count from the end, rows
    # past it are dropped.
    path_rows = torch.where(path_rows < 0, path_rows + n_paths + 1, path_rows)
    keep = (path_rows >= 0) & (path_rows <= n_paths)
    holder = torch.zeros((n_paths + 1, n_agents), dtype=torch.bool, device=dev)
    holder[path_rows[keep], held_agent.to(torch.int64).clamp(0, n_agents - 1)[keep]] = True
    return holder[:n_paths].sum(dim=1, dtype=torch.int32)
