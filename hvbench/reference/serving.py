"""The serving front door's answers, worked out plainly, wave by wave in
the order the program served them.

The front door batches an open stream into five classes of wave; each
class's answers follow from the wave's inputs and from what earlier
waves left:

  * a lifecycle wave admits each lane into a fresh session with no
    vouches (sigma_eff = sigma, ring 2 above the ring-2 threshold else
    3, a floor of 0), steps its one-step saga (committed on admission)
    and terminates it with the Merkle root of its delta chain
    (`facade.lanes`, `audit.chains_and_roots`);
  * a join flush admits each join into its standing session: refused
    BAD_STATE once the session has been terminated, CAPACITY at the
    session's participant cap, else admitted as a lifecycle lane is;
  * an admitted lifecycle lane or join resets the agent row the program
    admitted it into, for the gateway (ring and sigma_eff, tokens at its
    ring's burst, the stamp at the wave, an empty breach window, no
    breaker). Rows recycle once their session terminates (which touches
    no column the gateway reads), so an action served after its
    member's session ended acts on whatever was admitted there since;
  * an action wave runs the gateway over the members' rows
    (`facade.Gateway`'s gate order, token buckets and breach windows,
    over every row of the agent table, as the program refills them);
  * a terminate wave gives a standing session, which holds no audit
    leaves, the all-zero root;
  * a saga round commits a one-step saga's step on a good outcome and
    fails it otherwise (no retries).

Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

from hvbench.reference import FLOAT32, Precision
from hvbench.reference import facade
from hvbench.reference.audit import chains_and_roots

ADMIT_OK, ADMIT_BAD_STATE, ADMIT_CAPACITY = 0, 1, 3
STEP_COMMITTED, STEP_FAILED = 2, 6
NO_VOUCH = {"vouched": 0, "vouch_bond": 0.0, "omega": 0.0, "session_min_sigma": 0.0}


def lifecycle_bodies(body_seed: int, turns: int, words: int = 16) -> np.ndarray:
    """u32[T, 16]: a lifecycle's delta bodies from its trace seed."""
    rng = np.random.RandomState(int(body_seed))
    return rng.randint(0, 2**32, (turns, words), dtype=np.uint64).astype(np.uint32)


def admission(config: dict, sigma, prec: Precision = FLOAT32) -> dict:
    """Each lifecycle lane's admission: status, ring, sigma_eff, saga step."""
    return facade.lanes(config, NO_VOUCH, np.asarray(sigma, np.float32), prec)


def lifecycle_wave(config: dict, sigma: np.ndarray, body_seeds, turns: int,
                   prec: Precision = FLOAT32) -> dict:
    """Each lane's status, ring, sigma_eff, saga step and Merkle root."""
    out = admission(config, sigma, prec)
    bodies = np.stack([lifecycle_bodies(s, turns) for s in body_seeds], axis=1)
    _, out["merkle_root"] = chains_and_roots(bodies)
    return {k: out[k] for k in ("status", "ring", "sigma_eff", "saga_step_state",
                                "merkle_root")}


class RowGateway(facade.Gateway):
    """`facade.Gateway` over every row of the agent table, rows reset as
    lifecycle lanes and joins are admitted into them; no standing
    actors, no grants."""

    def __init__(self, config: dict, prec: Precision = FLOAT32) -> None:
        n = int(config["capacity"]["max_agents"])
        super().__init__({**config, "actors": n, "actor_ring": 3, "actor_sigma": 0.0,
                          "actor_tokens": 0.0, "actor_grants": []}, prec)

    def admit(self, rows: np.ndarray, ring: np.ndarray, sigma_eff: np.ndarray,
              now_s: float) -> None:
        rows = np.asarray(rows, np.int64)
        self.ring[rows] = ring
        self.sigma[rows] = sigma_eff
        self.flags[rows] = facade.FLAG_ACTIVE
        self.breaker_until[rows] = 0.0
        self.tokens[rows] = self.bursts[np.clip(ring, 0, 3)]
        self.stamp[rows] = self.prec.scalar(now_s)
        self.win[rows] = 0


class Sessions:
    """The standing sessions' liveness and member counts."""

    def __init__(self, cap: int) -> None:
        self.cap = cap
        self.members: dict[int, int] = {}
        self.terminated: set[int] = set()

    def join_status(self, slot: int) -> int:
        if slot in self.terminated:
            return ADMIT_BAD_STATE
        if self.members.get(slot, 0) >= self.cap:
            return ADMIT_CAPACITY
        return ADMIT_OK


def join_flush(config: dict, sessions: Sessions, slots, sigma, prec: Precision = FLOAT32
               ) -> dict:
    """Each join's status, ring and sigma_eff, in flush order; the admitted
    ones count toward their sessions."""
    lanes = facade.lanes(config, NO_VOUCH, np.asarray(sigma, np.float32), prec)
    status = np.empty(len(slots), np.int8)
    for i, s in enumerate(slots):
        status[i] = sessions.join_status(int(s))
        if status[i] == ADMIT_OK:
            sessions.members[int(s)] = sessions.members.get(int(s), 0) + 1
    return {"status": status, "ring": lanes["ring"], "sigma_eff": lanes["sigma_eff"]}


def terminate_roots(n: int) -> np.ndarray:
    return np.zeros((n, 8), np.uint32)


def saga_steps(ok) -> np.ndarray:
    return np.where(np.asarray(ok, bool), STEP_COMMITTED, STEP_FAILED).astype(np.int8)
