"""Lane counting for in-wave tallies (`hypervisor_tpu.ops.tally`).

The reference counts with an f32 matvec, exact below 2^24 rows; an
integer sum gives the same counts."""

from __future__ import annotations

import torch


def count_true(*cols: torch.Tensor) -> torch.Tensor:
    """int32[len(cols)]: per-column count of nonzero lanes (one length).
    Columns stacked over tenants ([T, n]) count per tenant: int32[len, T]."""
    return (torch.stack(cols) != 0).sum(dim=-1).to(torch.int32)


def count_true_1d(col: torch.Tensor) -> torch.Tensor:
    """int32[]: the count of nonzero lanes in one column (int32[T] for a
    column stacked over tenants)."""
    return count_true(col)[0]
