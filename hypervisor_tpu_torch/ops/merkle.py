"""Merkle-chain audit ops (`hypervisor_tpu.ops.merkle`): delta chains and
per-lane Merkle roots. CUDA tensors run the Hopper kernels B2 and B3
(`kernels.mtu`); CPU tensors run their plain versions.

Reference semantics: the interior combine is sha256(ascii_hex(left) +
ascii_hex(right)), the odd node is duplicated at each level, and each
delta's hash covers its parent's hash.
"""

from __future__ import annotations

import hashlib

import torch

from hypervisor_tpu_torch.kernels import mtu
from hypervisor_tpu_torch.kernels.mtu import BODY_WORDS

__all__ = ["BODY_WORDS", "chain_digests", "merkle_root_host", "merkle_root_lanes"]


def merkle_root_host(hashes: list[str]) -> str:
    """Host tree build over hex digests with `hashlib`: pairwise
    sha256(hexL + hexR), the odd node duplicated (the reference's
    `audit.delta.merkle_root_host`)."""
    level = list(hashes)
    while len(level) > 1:
        level = [
            hashlib.sha256(
                (level[i] + (level[i + 1] if i + 1 < len(level) else level[i])).encode()
            ).hexdigest()
            for i in range(0, len(level), 2)
        ]
    return level[0]


def chain_digests(bodies: torch.Tensor, seed: torch.Tensor | None = None) -> torch.Tensor:
    """int32[N, L, 16] bodies over N sequential turns of L lanes ->
    int32[N, L, 8] digests: digest_n = sha256(body_n || digest_{n-1}),
    digest_{-1} = seed (zeros by default)."""
    if seed is None:
        seed = torch.zeros((bodies.shape[1], 8), dtype=torch.int32, device=bodies.device)
    return mtu.chain_digests(bodies, seed)


def merkle_root_lanes(leaves: torch.Tensor, count) -> torch.Tensor:
    """int32[S, P, 8] leaves -> int32[S, 8] roots over the first `count`
    leaves of each lane (an int or int32[S]); count <= 1 gives leaf 0."""
    s = leaves.shape[0]
    if isinstance(count, torch.Tensor):
        counts = count.to(device=leaves.device, dtype=torch.int32).expand(s).contiguous()
    else:
        counts = torch.full((s,), int(count), dtype=torch.int32, device=leaves.device)
    return mtu.tree_roots(leaves, counts)
