"""The headline pipeline's answers, worked out plainly.

S independent lanes (`governance_pipeline` of the upstream): admission
(ring 2 above the ring-2 threshold else 3, sandboxed when untrustworthy;
SIGMA_LOW under the floor unless sandboxed; INACTIVE lanes refused), the
session walk CREATED -> HANDSHAKING -> ACTIVE -> TERMINATING -> ARCHIVED
on admitted lanes, one saga step (committed on admission, else failed),
the chain and root of each lane's bodies (`audit`), and four float32
consensus sums over the admitted lanes: the count, the sigma, the ring
mass and the roots' first words. The sums add in XLA:CPU's reduction
order, the upstream's: windows of 32 summed in order from zero, the
window sums again, until one window is left, each row padded with zeros
to a multiple of 32 (half the padding in front).
"""

from __future__ import annotations

import numpy as np

from hvbench.reference import FLOAT32, Precision
from hvbench.reference.audit import chains_and_roots

PIPE_OK, PIPE_SIGMA_BELOW_MIN, PIPE_INACTIVE = 0, 1, 2
S_CREATED, S_ARCHIVED = 0, 4
STEP_COMMITTED, STEP_FAILED = 2, 6
WINDOW = 32


def xla_order_sum(x: np.ndarray, prec: Precision = FLOAT32) -> np.ndarray:
    """float32 sums of the last axis in XLA:CPU's order."""
    x = prec.q(x)
    while x.shape[-1] > WINDOW:
        pad = -x.shape[-1] % WINDOW
        x = np.concatenate([np.zeros(x.shape[:-1] + (pad // 2,), np.float32), x,
                            np.zeros(x.shape[:-1] + (pad - pad // 2,), np.float32)], axis=-1)
        x = _in_order(x.reshape(x.shape[:-1] + (-1, WINDOW)), prec)
    return _in_order(x, prec)


def _in_order(x: np.ndarray, prec: Precision) -> np.ndarray:
    acc = np.zeros(x.shape[:-1], np.float32)
    for i in range(x.shape[-1]):
        acc = prec.q(acc + x[..., i])
    return acc


def answers(lane_inputs: dict, bodies: np.ndarray, trust: dict,
            prec: Precision = FLOAT32) -> dict:
    """Every field of one call's result, from its lanes and u32[T, S, 16]
    bodies."""
    sigma_eff = prec.q(lane_inputs["sigma_raw"])
    ring = np.where(sigma_eff > prec.scalar(trust["ring2_threshold"]), 2, 3).astype(np.int8)
    ring = np.where(lane_inputs["trustworthy"], ring, 3).astype(np.int8)
    bad = (sigma_eff < prec.q(lane_inputs["min_sigma_eff"])) & (ring != 3)
    status = np.where(~lane_inputs["active"], PIPE_INACTIVE,
                      np.where(bad, PIPE_SIGMA_BELOW_MIN, PIPE_OK)).astype(np.int8)
    ok = status == PIPE_OK
    _, roots = chains_and_roots(bodies)
    okf = ok.astype(np.float32)
    word0 = roots[:, 0].astype(np.float32)
    consensus = xla_order_sum(np.stack([okf, prec.q(sigma_eff * okf),
                                        prec.q(ring.astype(np.float32) * okf),
                                        prec.q(word0) * okf]), prec)
    return {"ring": ring, "sigma_eff": sigma_eff.astype(np.float32),
            "session_state": np.where(ok, S_ARCHIVED, S_CREATED).astype(np.int8),
            "saga_step_state": np.where(ok, STEP_COMMITTED, STEP_FAILED).astype(np.int8),
            "merkle_root": roots, "status": status, "consensus": consensus}
