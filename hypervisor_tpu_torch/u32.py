"""The port's u32 convention (see the package docstring): u32 words live
in `int32` tensors with the same bits."""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def from_numpy_u32(arr: np.ndarray, device: str | torch.device) -> torch.Tensor:
    """u32 numpy array -> int32 tensor with the same bits on `device`."""
    a = np.ascontiguousarray(np.asarray(arr, np.uint32)).view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor holding u32 bits -> u32 numpy array (a copy)."""
    return t.detach().cpu().numpy().astype(np.int32, copy=True).view(np.uint32)


def widen(t: torch.Tensor) -> torch.Tensor:
    """int32 bits -> int64 in [0, 2^32) (the plain SHA-256's working form)."""
    return t.to(torch.int64) & MASK32


def narrow(t: torch.Tensor) -> torch.Tensor:
    """int64 holding a u32 value (any high bits ignored) -> int32 bits."""
    v = t & MASK32
    return (v - ((v & 0x80000000) << 1)).to(torch.int32)


def add_u32(col: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """u32 add with wrap at 2^32 on int32 storage (a new tensor)."""
    return narrow(widen(col) + delta.to(torch.int64))
