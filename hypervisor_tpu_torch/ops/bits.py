"""Bit-packed boolean transition matrices (`hypervisor_tpu.ops.bits`).

A static legality matrix packs into two u32 words; a test over a whole
state column is shift-and-mask arithmetic. Out-of-range codes test
ILLEGAL.
"""

from __future__ import annotations

import numpy as np
import torch

PackedBits = tuple[int, int, int, int]


def pack_matrix_bits(matrix: np.ndarray) -> PackedBits:
    """Row-major boolean matrix -> (lo, hi, n_rows, n_cols)."""
    if matrix.size > 64:
        raise ValueError("transition matrix too large for two u32 words")
    bits = sum(int(v) << i for i, v in enumerate(matrix.reshape(-1).astype(np.uint8)))
    return (bits & 0xFFFFFFFF, bits >> 32, int(matrix.shape[0]), int(matrix.shape[1]))


def matrix_bits_valid(
    packed: PackedBits, frm: torch.Tensor, to: torch.Tensor | int
) -> torch.Tensor:
    """bool[...]: packed[frm, to] (`to` a code or a tensor broadcast
    against `frm`); False for any out-of-range code."""
    lo, hi, n_rows, n_cols = packed
    f = frm.to(torch.int64)
    # A code is filled on the device: a host scalar copied to the card
    # would synchronise the stream.
    if isinstance(to, (int, np.integer)):
        t = torch.full((), int(to), dtype=torch.int64, device=f.device)
    else:
        t = torch.as_tensor(to, device=f.device).to(torch.int64)
    in_range = (f >= 0) & (f < n_rows) & (t >= 0) & (t < n_cols)
    idx = f.clamp(0, n_rows - 1) * n_cols + t.clamp(0, n_cols - 1)
    word = torch.where(idx < 32, lo, hi)
    return in_range & (((word >> (idx & 31)) & 1) == 1)
