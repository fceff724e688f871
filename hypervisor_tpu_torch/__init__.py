"""PyTorch/CUDA port of the hypervisor's governance wave (NVIDIA Hopper).

This package stands beside the JAX package `hypervisor_tpu`, which stays
the reference: the same tables, the same fused governance wave, the
same results bit for bit. It imports `torch` and numpy only — never
`jax` and never any module of `hypervisor_tpu` (its tests import both).

Idiom:

* tables are plain dataclasses of tensors (`tables.state`), with the
  reference's packed-per-dtype column layout kept bit for bit;
* ops are plain functions on tensors. Where the JAX package donates a
  table to a jitted wave, the port updates the tensor IN PLACE (each
  such function says so in its docstring);
* every entry point takes an explicit `device`, defaulting to "cuda".
  Without CUDA it raises (`resolve_device`); it never drops quietly to
  the CPU. Tests pass `device="cpu"`;
* the wave's hand-written Hopper kernels (`kernels.mtu`, `kernels.wave`,
  sources in `csrc/`) run for CUDA tensors; CPU tensors take each
  kernel's plain PyTorch version beside it.

**u32 convention.** torch's CPU `uint32` has no add, shift or
bitwise-not, so every u32 word (SHA-256 message and digest words, u32
metric counters and histogram buckets) is STORED as an `int32` tensor
holding the same 32 bits. At the numpy boundary that is
`arr.view(np.int32)` in and `arr.view(np.uint32)` out (`u32.py`). The
plain SHA-256 computes in `int64` masked with `& 0xFFFFFFFF`; the CUDA
kernels reinterpret the same storage as `uint32_t`.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for
    but absent (the port never falls back to the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hypervisor_tpu_torch: CUDA is not available on this machine; "
            "pass device='cpu' explicitly to run the plain PyTorch path"
        )
    return dev
