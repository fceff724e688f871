"""Vectorized execution-ring math (`hypervisor_tpu.ops.rings`)."""

from __future__ import annotations

import numpy as np
import torch

from hypervisor_tpu_torch.config import DEFAULT_CONFIG, TrustConfig


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
