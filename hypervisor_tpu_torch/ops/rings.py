"""Vectorized execution-ring math (`hypervisor_tpu.ops.rings`): the ring a
sigma earns, the ring an action requires, the privilege gate an action
passes through, and the demotion scan."""

from __future__ import annotations

import numpy as np
import torch

from hypervisor_tpu_torch.config import DEFAULT_CONFIG, TrustConfig

# Ring-check status codes, in the order the gate checks them.
CHECK_OK = 0
CHECK_NEEDS_SRE_WITNESS = 1
CHECK_SIGMA_BELOW_RING1 = 2
CHECK_NEEDS_CONSENSUS = 3
CHECK_SIGMA_BELOW_RING2 = 4
CHECK_RING_INSUFFICIENT = 5


def compute_rings(
    sigma_eff: torch.Tensor,
    has_consensus: torch.Tensor | bool = False,
    trust: TrustConfig = DEFAULT_CONFIG.trust,
) -> torch.Tensor:
    """int8 rings: 1 if sigma > ring1 and consensus, 2 if sigma > ring2,
    else 3. Thresholds compare in float32, as in the reference."""
    consensus = torch.as_tensor(has_consensus, device=sigma_eff.device)
    r1 = float(np.float32(trust.ring1_threshold))
    r2 = float(np.float32(trust.ring2_threshold))
    ring = torch.where(
        sigma_eff > r2,
        torch.tensor(2, dtype=torch.int8, device=sigma_eff.device),
        torch.tensor(3, dtype=torch.int8, device=sigma_eff.device),
    )
    return torch.where((sigma_eff > r1) & consensus, torch.ones_like(ring), ring)


def required_rings(
    is_admin: torch.Tensor,
    reversibility_code: torch.Tensor,
    is_read_only: torch.Tensor,
) -> torch.Tensor:
    """int8 ring each action requires (`ActionDescriptor.required_ring`):
    0 for admin, 1 for a non-reversible write, 3 for a read, else 2.
    reversibility_code: 0=FULL 1=PARTIAL 2=NONE."""
    nonrev = (reversibility_code == 2) & ~is_read_only
    ring = torch.where(is_read_only, 3, 2)
    ring = torch.where(nonrev, 1, ring)
    return torch.where(is_admin, 0, ring).to(torch.int8)


def ring_check(
    agent_ring: torch.Tensor,
    required_ring: torch.Tensor,
    sigma_eff: torch.Tensor,
    has_consensus: torch.Tensor | bool = False,
    has_sre_witness: torch.Tensor | bool = False,
    trust: TrustConfig = DEFAULT_CONFIG.trust,
) -> torch.Tensor:
    """int8 status per action (CHECK_OK == allowed): the first failing
    check in order — an SRE witness for ring 0, the ring-1 sigma bar,
    consensus for ring 1, the ring-2 sigma bar, then whether the agent's
    ring is privileged enough. Thresholds compare in float32."""
    dev = sigma_eff.device
    shape = torch.broadcast_shapes(agent_ring.shape, required_ring.shape, sigma_eff.shape)
    required = required_ring.broadcast_to(shape)
    consensus = torch.as_tensor(has_consensus, device=dev).broadcast_to(shape)
    witness = torch.as_tensor(has_sre_witness, device=dev).broadcast_to(shape)
    sigma = sigma_eff.broadcast_to(shape)
    r1 = float(np.float32(trust.ring1_threshold))
    r2 = float(np.float32(trust.ring2_threshold))
    status = torch.zeros(shape, dtype=torch.int8, device=dev)
    for cond, code in (
        ((required == 0) & ~witness, CHECK_NEEDS_SRE_WITNESS),
        ((required == 1) & (sigma < r1), CHECK_SIGMA_BELOW_RING1),
        ((required == 1) & ~consensus, CHECK_NEEDS_CONSENSUS),
        ((required == 2) & (sigma < r2), CHECK_SIGMA_BELOW_RING2),
        (agent_ring.broadcast_to(shape) > required, CHECK_RING_INSUFFICIENT),
    ):
        status = status.masked_fill((status == CHECK_OK) & cond, code)
    return status


def should_demote(
    current_ring: torch.Tensor,
    sigma_eff: torch.Tensor,
    trust: TrustConfig = DEFAULT_CONFIG.trust,
) -> torch.Tensor:
    """bool per agent: the ring its sigma earns (without consensus) is
    less privileged than the ring it holds."""
    return compute_rings(sigma_eff, False, trust) > current_ring.to(torch.int8)
