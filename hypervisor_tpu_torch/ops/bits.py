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


def matrix_bits_valid(packed: PackedBits, frm: torch.Tensor, to: int) -> torch.Tensor:
    """bool[...]: packed[frm, to]; False for any out-of-range code."""
    lo, hi, n_rows, n_cols = packed
    f = frm.to(torch.int64)
    if not (0 <= to < n_cols):
        return torch.zeros_like(f, dtype=torch.bool)
    in_range = (f >= 0) & (f < n_rows)
    idx = f.clamp(0, n_rows - 1) * n_cols + to
    word = torch.where(idx < 32, lo, hi)
    return in_range & (((word >> (idx & 31)) & 1) == 1)
