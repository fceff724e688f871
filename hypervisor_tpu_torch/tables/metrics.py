"""Device-resident metrics table: counters, gauges, histograms.

The torch counterpart of `hypervisor_tpu.tables.metrics`. Counters and
histogram buckets are u32 in the reference; here they are int32 tensors
holding the same bits (the package's u32 convention), and every add
wraps at 2^32 exactly like the u32 column. The wave updates the table
IN PLACE where the reference donates it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from hypervisor_tpu_torch import u32
from hypervisor_tpu_torch.observability import metrics as schema
from hypervisor_tpu_torch.tables.struct import footprint, table


@table
class MetricsTable:
    """[C]/[G]/[H, NB] telemetry columns; row index == metric handle."""

    counters: torch.Tensor  # u32[C] as int32 bits
    gauges: torch.Tensor    # f32[G]
    hist: torch.Tensor      # u32[H, NB] as int32 bits (last bucket = +Inf)
    hist_sum: torch.Tensor  # f32[H]
    bounds: torch.Tensor    # f32[NB-1] shared upper bounds, ascending

    @staticmethod
    def create(
        device: str | torch.device,
        n_counters: int = schema.N_COUNTERS,
        n_gauges: int = schema.N_GAUGES,
        n_hists: int = schema.N_HISTOGRAMS,
        bounds: Sequence[float] = schema.DEFAULT_BUCKET_BOUNDS_US,
    ) -> "MetricsTable":
        b = torch.tensor(bounds, dtype=torch.float32, device=device)
        nb = b.shape[0] + 1
        return MetricsTable(
            counters=torch.zeros((max(n_counters, 1),), dtype=torch.int32, device=device),
            gauges=torch.zeros((max(n_gauges, 1),), dtype=torch.float32, device=device),
            hist=torch.zeros((max(n_hists, 1), nb), dtype=torch.int32, device=device),
            hist_sum=torch.zeros((max(n_hists, 1),), dtype=torch.float32, device=device),
            bounds=b,
        )

    def footprint(self) -> dict:
        """Health-plane bytes and capacity (`tables.struct.footprint`):
        the rows are the registered metric rows of the three kinds. The
        layout is static, so it never saturates; the health plane
        reports its bytes but leaves it out of the occupancy warn set."""
        return footprint(
            self, self.counters.shape[0] + self.gauges.shape[0] + self.hist.shape[0]
        )


def bucket_of(bounds: torch.Tensor, values) -> torch.Tensor:
    """i32 bucket index per value under Prometheus `le` semantics: the
    first bucket whose upper bound covers the value (value <= bounds[b]);
    a value above every bound lands in the overflow bucket (index
    len(bounds))."""
    values = torch.as_tensor(values, dtype=torch.float32, device=bounds.device)
    return torch.searchsorted(bounds, values, right=False).to(torch.int32)


def counter_inc(m: MetricsTable, idx, n: torch.Tensor | int = 1) -> None:
    """Add `n` to counter row `idx`, IN PLACE (u32 wrap); `n` may be a
    Python int or an integer tensor on the table's device."""
    counters_add(m.counters, [idx], [n % (1 << 32) if isinstance(n, int) else n])


def gauge_set(m: MetricsTable, idx, value) -> None:
    """Set gauge row `idx` to `value` (as f32), IN PLACE; last write wins."""
    m.gauges[..., idx] = torch.as_tensor(value, dtype=torch.float32, device=m.gauges.device)


def counter_add_many(
    m: MetricsTable, indices: Sequence[int], values: Sequence
) -> None:
    """Add `values[i]` to counter row `indices[i]`, IN PLACE (u32 wrap).

    Values may be Python ints (added as kernel scalars) or integer
    tensors on the table's device, so no host transfer or host sync
    happens here. Duplicate indices accumulate, as in the reference.
    A table stacked over tenants ([T, C] counters) takes a [T] tensor
    per row, each tenant's add into its own row.
    """
    counters_add(m.counters, indices, values)


def counters_add(
    counters: torch.Tensor, indices: Sequence[int], values: Sequence
) -> None:
    """`counter_add_many` on a bare counter column (u32 bits in int32)."""
    lead = counters.shape[:-1]
    delta = torch.zeros(counters.shape, dtype=torch.int64, device=counters.device)
    for idx, v in zip(indices, values):
        if isinstance(v, torch.Tensor):
            delta[..., idx] += v.to(torch.int64).reshape(lead)
        else:
            delta[..., idx] += int(v)
    counters.copy_(u32.add_u32(counters, delta))


def gauge_set_many(m: MetricsTable, indices: Sequence[int], values: Sequence) -> None:
    """Set gauge row `indices[i]` to `values[i]` (as f32), IN PLACE; the
    rows are distinct. Values may be Python numbers or tensors on the
    table's device. Each run of consecutive rows is one copy, and no index
    or value crosses from the host, so nothing waits on the device. A
    table stacked over tenants takes a [T] tensor per row."""
    dev = m.gauges.device
    lead = m.gauges.shape[:-1]
    vals = torch.stack([
        v.to(torch.float32).reshape(lead) if isinstance(v, torch.Tensor)
        else torch.full(lead, float(np.float32(v)), dtype=torch.float32, device=dev)
        for v in values
    ], dim=-1)
    idx = list(indices)
    start = 0
    for i in range(1, len(idx) + 1):
        if i == len(idx) or idx[i] != idx[i - 1] + 1:
            m.gauges[..., idx[start]:idx[i - 1] + 1] = vals[..., start:i]
            start = i


def observe(m: MetricsTable, hist_idx: int, values: torch.Tensor) -> None:
    """Record samples into histogram row `hist_idx`, IN PLACE: bucket b
    counts values <= bounds[b] (Prometheus `le`), overflow last. A table
    stacked over tenants takes [T, n] samples, each tenant's into its own
    row."""
    values = values.to(torch.float32)
    bucket = torch.searchsorted(m.bounds, values, right=False)
    counts = torch.zeros(values.shape[:-1] + m.hist.shape[-1:], dtype=torch.int64,
                         device=values.device)
    counts.scatter_add_(-1, bucket, torch.ones_like(bucket))
    m.hist[..., hist_idx, :].copy_(u32.add_u32(m.hist[..., hist_idx, :], counts))
    m.hist_sum[..., hist_idx] += values.sum(-1)
