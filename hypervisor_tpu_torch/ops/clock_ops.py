"""Vectorized vector-clock math over dense clock matrices
(`hypervisor_tpu.ops.clock_ops`): happens-before, the clock join, and the
batched write prepass that `runtime.write_wave` runs on its device.

The host engine compares clocks dict by dict (`session/vector_clock.py`);
here a batch of pending writes validates against the [paths x writers]
clock matrix in two vector comparisons. Every op runs on the device its
tensors lie on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def happens_before(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bool[...]: a < b component-wise over the trailing clock axis
    (a, b: int32[..., A] clock vectors)."""
    return (a <= b).all(dim=-1) & (a < b).any(dim=-1)


def is_concurrent(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ~happens_before(a, b) & ~happens_before(b, a)


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Component-wise max (the clock join)."""
    return torch.maximum(a, b)


class WritePrepass(NamedTuple):
    allowed: torch.Tensor       # bool[W] write admitted
    path_clocks: torch.Tensor   # int32[P, A] updated path clocks
    agent_clocks: torch.Tensor  # int32[N, A] updated agent clocks
    conflicts: torch.Tensor     # int32 scalar count of rejected writes


def batched_write_prepass(
    path_clocks: torch.Tensor,   # int32[P, A]
    agent_clocks: torch.Tensor,  # int32[N, A]
    write_path: torch.Tensor,    # int32[W] path row per pending write
    write_agent: torch.Tensor,   # int32[W] agent row per pending write
    strict: torch.Tensor | bool = True,
) -> WritePrepass:
    """Resolve a batch of independent writes in one pass.

    Per write, as `vector_clock.py:104-149`: under strict mode a writer
    whose clock happens-before the path's (non-empty) clock is rejected
    as stale; admitted writes tick the writer's own component and join
    into the path clock. A batch must name distinct paths and distinct
    writers (the write wave schedules repeats into later batches). The
    inputs are left as they were; the updated matrices are new tensors.
    """
    wp = write_path.to(torch.int64)
    wa = write_agent.to(torch.int64)
    pc = path_clocks[wp]           # int32[W, A]
    ac = agent_clocks[wa]          # int32[W, A]
    path_nonempty = (pc > 0).any(dim=-1)
    stale = happens_before(ac, pc)
    strict_t = torch.as_tensor(strict, dtype=torch.bool, device=stale.device).expand(stale.shape)
    rejected = strict_t & path_nonempty & stale
    allowed = ~rejected

    # Tick admitted writers' own component.
    onehot = (torch.arange(agent_clocks.shape[1], dtype=torch.int64, device=wa.device)[None, :]
              == wa[:, None])
    ac_new = ac + (allowed[:, None] & onehot).to(ac.dtype)
    pc_new = torch.where(allowed[:, None], merge(pc, ac_new), pc)

    path_out = path_clocks.clone()
    path_out[wp] = pc_new
    agent_out = agent_clocks.clone()
    agent_out[wa] = torch.where(allowed[:, None], ac_new, ac)
    return WritePrepass(
        allowed=allowed,
        path_clocks=path_out,
        agent_clocks=agent_out,
        conflicts=rejected.to(torch.int32).sum(dtype=torch.int32),
    )
