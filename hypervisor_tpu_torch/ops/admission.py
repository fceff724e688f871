"""Batched admission: a wave of B joins onto the agent/session tables
(`hypervisor_tpu.ops.admission`).

`admit_batch` is the plain PyTorch version of the admission kernel
(`kernels.wave.admission_block`): the session-row gathers, sigma_eff =
min(sigma_raw + omega * contribution, 1), the ring, the status ladder
(first claim wins: BAD_STATE, DUPLICATE, SIGMA_LOW, then CAPACITY by
rank within the session among lanes passing every other check), the
packed agent-row writes and the participant-count scatter.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hypervisor_tpu_torch.config import DEFAULT_CONFIG, TrustConfig
from hypervisor_tpu_torch.observability import metrics as schema
from hypervisor_tpu_torch.ops import rings as ring_ops
from hypervisor_tpu_torch.ops import tally
from hypervisor_tpu_torch.tables import metrics as metrics_ops
from hypervisor_tpu_torch.tables.state import (
    AF32_JOINED_AT,
    AF32_RL_STAMP,
    AF32_RL_TOKENS,
    AF32_SIGMA_EFF,
    AF32_SIGMA_RAW,
    AF32_WIDTH,
    AI32_DID,
    AI32_FLAGS,
    AI32_SESSION,
    AI32_WIDTH,
    FLAG_ACTIVE,
    SF32_MIN_SIGMA,
    SI32_MAX_PARTICIPANTS,
    SI32_NPART,
    SI32_STATE,
    SI32_WIDTH,
    AgentTable,
    SessionTable,
)

# Admission status codes.
ADMIT_OK = 0
ADMIT_BAD_STATE = 1     # session not HANDSHAKING|ACTIVE
ADMIT_DUPLICATE = 2     # agent already in session
ADMIT_CAPACITY = 3      # session at max_participants
ADMIT_SIGMA_LOW = 4     # sigma_eff below session floor (non-sandbox)

_S_HANDSHAKING = 1
_S_ACTIVE = 2


def f32_scalar(x, device) -> torch.Tensor:
    """A float32 0-d tensor on `device` (no host sync for CUDA)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(np.float32(x)), dtype=torch.float32, device=device)


def sigma_effective(sigma_raw, contribution, omega) -> torch.Tensor:
    """min(sigma_raw + omega * contribution, 1) in float32; the multiply
    and the add round separately (no fused multiply-add)."""
    x = sigma_raw + f32_scalar(omega, sigma_raw.device) * contribution
    return torch.minimum(x, torch.ones_like(x))


def rank_within_session(keys: torch.Tensor) -> torch.Tensor:
    """int32[B]: how many earlier lanes share each lane's key (stable
    sort; rank = sorted index - group start)."""
    b = keys.shape[0]
    sorted_keys, order = torch.sort(keys, stable=True)
    idx = torch.arange(b, dtype=torch.int64, device=keys.device)
    is_new = torch.ones((b,), dtype=torch.bool, device=keys.device)
    is_new[1:] = sorted_keys[1:] != sorted_keys[:-1]
    group_start = torch.cummax(torch.where(is_new, idx, torch.zeros_like(idx)), dim=0).values
    rank = torch.zeros((b,), dtype=torch.int32, device=keys.device)
    rank[order] = (idx - group_start).to(torch.int32)
    return rank


def admit_row_blocks(did, session_slot, sigma_raw, sigma_eff, now, ring, bursts):
    """(f32[B, 8], i32[B, 21]) freshly admitted rows: every column not
    named here is zero, which also resets the breach window."""
    b = did.shape[0]
    dev = did.device
    f32_rows = torch.zeros((b, AF32_WIDTH), dtype=torch.float32, device=dev)
    f32_rows[:, AF32_SIGMA_RAW] = sigma_raw
    f32_rows[:, AF32_SIGMA_EFF] = sigma_eff
    f32_rows[:, AF32_JOINED_AT] = now
    f32_rows[:, AF32_RL_TOKENS] = bursts[ring.to(torch.int64).clamp(0, 3)]
    f32_rows[:, AF32_RL_STAMP] = now
    i32_rows = torch.zeros((b, AI32_WIDTH), dtype=torch.int32, device=dev)
    i32_rows[:, AI32_DID] = did
    i32_rows[:, AI32_SESSION] = session_slot
    i32_rows[:, AI32_FLAGS] = FLAG_ACTIVE
    return f32_rows, i32_rows


def tally_admission(
    metrics: metrics_ops.MetricsTable, ok: torch.Tensor, b: int, valid: torch.Tensor | None = None
) -> None:
    """Book admitted/refused counts and the wave-size histogram, IN PLACE.
    `valid` (bool[B]) marks a bucket-padded wave's real lanes: pad lanes
    are refused by construction but count neither as refusals nor in
    the observed wave size. A table stacked over tenants takes [T, B]
    lanes and books each tenant's row."""
    if valid is None:
        n_ok = tally.count_true(ok)[0]
        n_refused = b - n_ok
        lanes_observed = torch.full((1,), float(b), dtype=torch.float32, device=ok.device)
    else:
        n_ok, n_valid = tally.count_true(ok & valid, valid)
        n_refused = n_valid - n_ok
        lanes_observed = n_valid.to(torch.float32)[..., None]
    metrics_ops.counter_add_many(
        metrics, (schema.ADMITTED.index, schema.REFUSED.index), (n_ok, n_refused)
    )
    metrics_ops.observe(metrics, schema.WAVE_LANES.index, lanes_observed)


class AdmissionResult(NamedTuple):
    status: torch.Tensor     # i8[B]
    ring: torch.Tensor       # i8[B]
    sigma_eff: torch.Tensor  # f32[B]


def admit_batch(
    agents: AgentTable,
    sessions: SessionTable,
    slot: torch.Tensor,          # i32[B] preallocated agent rows
    did: torch.Tensor,           # i32[B] intern handles
    session_slot: torch.Tensor,  # i32[B]
    sigma_raw: torch.Tensor,     # f32[B]
    trustworthy: torch.Tensor,   # bool[B]
    duplicate: torch.Tensor,     # bool[B] host-known membership clash
    now,
    trust: TrustConfig = DEFAULT_CONFIG.trust,
    contribution: torch.Tensor | None = None,  # f32[B]
    omega=0.0,
    ring_bursts=None,            # f32[4] per-ring bucket bursts
    unique_sessions: bool = False,
) -> AdmissionResult:
    """Admit a wave of B agents, writing the agent rows, the ring column
    and the sessions' participant counts IN PLACE (the reference returns
    updated tables). Rejected lanes write nothing.

    `unique_sessions` is the caller's host-verified assertion that no
    two seat-consuming lanes target one session: every rank is then 0.
    """
    dev = slot.device
    rows = sessions.i32[session_slot.to(torch.int64)]
    sess_state = rows[:, SI32_STATE]
    sess_count = rows[:, SI32_NPART]
    sess_max = rows[:, SI32_MAX_PARTICIPANTS]
    sess_min_sigma = sessions.f32[session_slot.to(torch.int64)][:, SF32_MIN_SIGMA]

    sigma_eff = sigma_raw if contribution is None else sigma_effective(
        sigma_raw, contribution, omega
    )
    ring = ring_ops.compute_rings(sigma_eff, False, trust)
    ring = torch.where(trustworthy, ring, torch.full_like(ring, 3))
    bad_state = (sess_state != _S_HANDSHAKING) & (sess_state != _S_ACTIVE)
    sigma_low = (sigma_eff < sess_min_sigma) & (ring != 3)

    status = torch.zeros(slot.shape, dtype=torch.int8, device=dev)

    def claim(status, cond, code):
        return torch.where((status == ADMIT_OK) & cond, torch.full_like(status, code), status)

    status = claim(status, bad_state, ADMIT_BAD_STATE)
    status = claim(status, duplicate, ADMIT_DUPLICATE)
    status = claim(status, sigma_low, ADMIT_SIGMA_LOW)
    passed_other = status == ADMIT_OK
    b = slot.shape[0]
    if unique_sessions:
        rank = torch.zeros((b,), dtype=torch.int32, device=dev)
    else:
        lanes = torch.arange(b, dtype=torch.int64, device=dev)
        rank = rank_within_session(
            torch.where(passed_other, session_slot.to(torch.int64), -1 - lanes)
        )
    status = claim(status, passed_other & ((sess_count + rank) >= sess_max), ADMIT_CAPACITY)
    ok = status == ADMIT_OK

    bursts = torch.as_tensor(
        DEFAULT_CONFIG.rate_limit.ring_bursts if ring_bursts is None else ring_bursts,
        dtype=torch.float32, device=dev,
    )
    f32_rows, i32_rows = admit_row_blocks(
        did, session_slot, sigma_raw, sigma_eff, f32_scalar(now, dev), ring, bursts
    )
    ok_idx = ok.nonzero().squeeze(1)
    w = slot[ok_idx].to(torch.int64)
    agents.f32[w] = f32_rows[ok_idx]
    agents.i32[w] = i32_rows[ok_idx]
    agents.ring[w] = ring[ok_idx]
    npart = session_slot[ok_idx].to(torch.int64) * SI32_WIDTH + SI32_NPART
    sessions.i32.view(-1).index_add_(
        0, npart, torch.ones(npart.shape, dtype=torch.int32, device=dev)
    )
    return AdmissionResult(status=status, ring=ring, sigma_eff=sigma_eff)
