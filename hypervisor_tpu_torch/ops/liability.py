"""Joint-liability math the wave reads (`hypervisor_tpu.ops.liability`):
live edges and the bonded contribution toward each joining agent."""

from __future__ import annotations

import torch

from hypervisor_tpu_torch.tables.state import VouchTable


def edge_live(v: VouchTable, now: torch.Tensor | float) -> torch.Tensor:
    """bool[E]: active, unexpired edges."""
    return v.active & (now <= v.expiry)


def scoped_edges(
    v: VouchTable, target_session_of_slot: torch.Tensor, now: torch.Tensor | float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(vouchee clamped to 0 as int64[E], bool[E] live edges scoped to
    the session their vouchee is joining)."""
    vee = v.vouchee.clamp(min=0).to(torch.int64)
    scoped = edge_live(v, now) & (v.vouchee >= 0) & (v.session == target_session_of_slot[vee])
    return vee, scoped


def contribution_toward(
    v: VouchTable, target_session_of_slot: torch.Tensor, now: torch.Tensor | float
) -> torch.Tensor:
    """f32[N] bonded sigma toward each agent slot, scoped to the session
    that slot is joining.

    A scatter-add over the edges, the plain form. On the CPU `index_add_`
    sums in edge order, like the reference's scatter, so any number of
    vouchers per vouchee agrees bit for bit. On CUDA `index_add_` adds
    with atomics in no fixed order; the wave's kernel path
    (`kernels.wave.contribution_toward`) sums in edge order instead.
    """
    n = target_session_of_slot.shape[0]
    vee, scoped = scoped_edges(v, target_session_of_slot, now)
    out = torch.zeros((n,), dtype=torch.float32, device=v.bond.device)
    return out.index_add_(0, vee, torch.where(scoped, v.bond, torch.zeros_like(v.bond)))


def contribution_runs(
    v: VouchTable, target_session_of_slot: torch.Tensor, now: torch.Tensor | float
) -> tuple[torch.Tensor, torch.Tensor]:
    """The edges laid out for an in-order sum per vouchee: int32[E] keys,
    sorted stably, each the vouchee of a live scoped edge or N for any
    other edge, and the int64[E] edge index of each key. Each vouchee's
    edges form one run of equal keys in edge order."""
    n = target_session_of_slot.shape[0]
    _, scoped = scoped_edges(v, target_session_of_slot, now)
    keys = torch.where(scoped, v.vouchee, torch.full_like(v.vouchee, n))
    return torch.sort(keys, stable=True)
