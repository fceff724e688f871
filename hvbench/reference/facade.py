"""The lifecycle wave's answers, worked out plainly.

For call c of a facade-wave cell (`gen.FacadeTraffic`): each lane's
admission (sigma_eff = min(sigma + omega * bond, 1), ring 2 above the
ring-2 threshold else 3, refused SIGMA_LOW under a non-sandbox floor),
its saga step (committed on admission, else failed: no retries), each
session's walk (HANDSHAKING -> ACTIVE -> TERMINATING -> ARCHIVED when a
lane was admitted into it, else untouched), its participant count and
termination stamp, the bonds released (every edge the call placed lies
in one of its sessions), and the audit chain and roots (`audit`).

The action gateway is stateful: an actor's token bucket, breach window
and breaker carry from call to call. `Gateway` follows every call from
the configuration's starting rows, in the gate order of the upstream's
scalar pipeline: breaker, quarantine, the ring check at the
elevation-effective ring, the token bucket settled in call order within
an actor, then the breach window's record.
"""

from __future__ import annotations

import numpy as np

from hvbench.reference import FLOAT32, Precision
from hvbench.reference.audit import chains_and_roots

# Codes of the program's public results (the upstream's enums).
ADMIT_OK, ADMIT_SIGMA_LOW = 0, 4
STEP_COMMITTED, STEP_FAILED = 2, 6
S_HANDSHAKING, S_ARCHIVED = 1, 4
GATE_ALLOWED, GATE_BREAKER, GATE_QUARANTINED, GATE_RING, GATE_RATE = 0, 1, 2, 3, 4
CHECK_OK, CHECK_NEEDS_SRE_WITNESS, CHECK_SIGMA_BELOW_RING1 = 0, 1, 2
CHECK_NEEDS_CONSENSUS, CHECK_SIGMA_BELOW_RING2, CHECK_RING_INSUFFICIENT = 3, 4, 5
FLAG_ACTIVE, FLAG_BREAKER = 1, 4
WINDOW_BUCKETS = 6


def lanes(config: dict, traffic: dict, sigma_raw: np.ndarray, prec: Precision = FLOAT32) -> dict:
    """Every lane's admission answer, and each session's end state."""
    k, vouched = len(sigma_raw), int(traffic["vouched"])
    trust = config["trust"]
    contribution = np.zeros(k, np.float32)
    contribution[:vouched] = np.float32(traffic["vouch_bond"])
    omega = prec.scalar(traffic["omega"])
    sigma = prec.q(sigma_raw)
    sigma_eff = np.minimum(prec.q(sigma + prec.q(omega * prec.q(contribution))), np.float32(1.0))
    ring = np.where(sigma_eff > prec.scalar(trust["ring2_threshold"]), 2, 3).astype(np.int8)
    floor = prec.scalar(traffic["session_min_sigma"])
    low = (sigma_eff < floor) & (ring != 3)
    status = np.where(low, ADMIT_SIGMA_LOW, ADMIT_OK).astype(np.int8)
    ok = status == ADMIT_OK
    return {"status": status, "ring": ring, "sigma_eff": sigma_eff.astype(np.float32),
            "saga_step_state": np.where(ok, STEP_COMMITTED, STEP_FAILED).astype(np.int8),
            "npart": ok.astype(np.int32),
            "session_state": np.where(ok, S_ARCHIVED, S_HANDSHAKING).astype(np.int32),
            "fsm_error": np.zeros(k, bool), "released": vouched}


def call_answers(config: dict, traffic: dict, gen, c: int, prec: Precision = FLOAT32) -> dict:
    """All per-call answers of call c but the gateway's."""
    out = lanes(config, traffic, gen.sigma, prec)
    now = prec.scalar(gen.now(c))
    out["terminated_at"] = np.where(out["npart"] > 0, now, np.float32(0.0)).astype(np.float32)
    out["chain"], out["merkle_root"] = chains_and_roots(gen.bodies_of(c))
    return out


def _segment_prefix(order: np.ndarray, start_pos: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Inclusive count of v within each actor, in call order (`order`
    sorts the calls by actor, stably; `start_pos` is each sorted call's
    group start)."""
    c = np.cumsum(v[order].astype(np.int64))
    before = np.concatenate([[0], c[:-1]])
    incl = np.empty_like(c)
    incl[order] = c - before[start_pos]
    return incl


class Gateway:
    """The standing actors' gateway state, call after call."""

    def __init__(self, config: dict, prec: Precision = FLOAT32) -> None:
        n = int(config["actors"])
        self.prec = prec
        self.cfg = config
        self.ring = np.full(n, int(config["actor_ring"]), np.int8)
        self.sigma = np.full(n, prec.scalar(config["actor_sigma"]), np.float32)
        self.flags = np.full(n, FLAG_ACTIVE, np.int32)
        self.breaker_until = np.zeros(n, np.float32)
        self.tokens = np.full(n, prec.scalar(config["actor_tokens"]), np.float32)
        self.stamp = np.zeros(n, np.float32)
        self.win = np.zeros((n, 3 * WINDOW_BUCKETS), np.int32)
        grants = config["actor_grants"]
        self.grant_ring = np.array([g[0] for g in grants], np.int8)
        self.grant_until = np.array([prec.scalar(g[1]) for g in grants], np.float32)
        self.bursts = prec.q(np.array(config["rate_limit"]["ring_bursts"], np.float32))
        self.rates = prec.q(np.array(config["rate_limit"]["ring_rates"], np.float32))

    def effective_rings(self, now: np.float32) -> np.ndarray:
        eff = self.ring.copy()
        live = now <= self.grant_until
        for i in np.nonzero(live)[0]:
            eff[i] = min(eff[i], self.grant_ring[i])
        return eff

    def call(self, actor: np.ndarray, required: np.ndarray, now_s: float) -> dict:
        """One call's actions (actor index, required ring); updates the
        state and returns each action's answers."""
        p, q = self.prec, self.prec.q
        br = self.cfg["breach"]
        trust = self.cfg["trust"]
        k = WINDOW_BUCKETS
        now = p.scalar(now_s)
        a = len(actor)
        eff_all = self.effective_rings(now)
        eff = eff_all[actor]
        sigma = self.sigma[actor]
        sub = p.scalar(br["window_seconds"] / k)
        cur = int(np.floor(q(now / sub)))
        stamps = self.win[:, 2 * k:]
        live_b = stamps > cur - k
        base_calls = np.where(live_b, self.win[:, :k], 0).sum(axis=1)
        base_priv = np.where(live_b, self.win[:, k:2 * k], 0).sum(axis=1)

        order = np.argsort(actor, kind="stable")
        s_sorted = actor[order]
        is_start = np.concatenate([[True], s_sorted[1:] != s_sorted[:-1]])
        start_pos = np.maximum.accumulate(np.where(is_start, np.arange(a), 0))
        ones = np.ones(a, np.int64)
        privileged = required < eff
        total = base_calls[actor] + _segment_prefix(order, start_pos, ones)
        priv = base_priv[actor] + _segment_prefix(order, start_pos, privileged)
        analyzable = total >= int(br["min_calls_for_analysis"])
        rate = np.where(analyzable, q(q(priv.astype(np.float32))
                                      / q(np.maximum(total, 1).astype(np.float32))),
                        np.float32(0.0)).astype(np.float32)
        cond = analyzable & (rate >= p.scalar(br["high_threshold"]))
        cond_before = _segment_prefix(order, start_pos, cond) - cond
        pre_live = ((self.flags[actor] & FLAG_BREAKER) != 0) & (now < self.breaker_until[actor])
        live = pre_live | (cond_before > 0)
        trip = cond & ~live
        severity = sum((rate >= p.scalar(br[t])).astype(np.int8) for t in
                       ("low_threshold", "medium_threshold", "high_threshold",
                        "critical_threshold"))
        severity = np.where(analyzable & ~live, severity, 0).astype(np.int8)
        anomaly = np.where(severity > 0, rate, np.float32(0.0)).astype(np.float32)

        r1, r2 = p.scalar(trust["ring1_threshold"]), p.scalar(trust["ring2_threshold"])
        ring_status = np.zeros(a, np.int8)
        for cond_r, code in (((required == 0), CHECK_NEEDS_SRE_WITNESS),
                             ((required == 1) & (sigma < r1), CHECK_SIGMA_BELOW_RING1),
                             ((required == 1), CHECK_NEEDS_CONSENSUS),
                             ((required == 2) & (sigma < r2), CHECK_SIGMA_BELOW_RING2),
                             (eff > required, CHECK_RING_INSUFFICIENT)):
            ring_status = np.where((ring_status == CHECK_OK) & cond_r, code, ring_status)
        refused_ring = ~live & (ring_status != CHECK_OK)
        reaching = ~(live | refused_ring)

        ring_for_rate = self.ring.copy()
        ring_for_rate[actor] = eff
        rr = np.clip(ring_for_rate, 0, 3)
        elapsed = np.maximum(q(now - self.stamp), np.float32(0.0))
        refilled = np.minimum(self.bursts[rr], q(self.tokens + q(elapsed * self.rates[rr])))
        r_incl = _segment_prefix(order, start_pos, reaching)
        allowed = reaching & (r_incl.astype(np.float32) <= refilled[actor])

        verdict = np.full(a, GATE_RATE, np.int8)
        for cond_v, code in ((allowed, GATE_ALLOWED), (refused_ring, GATE_RING),
                             (live, GATE_BREAKER)):
            verdict = np.where(cond_v, code, verdict).astype(np.int8)

        n = len(self.ring)
        calls_add = np.bincount(actor, minlength=n)
        priv_add = np.bincount(actor, weights=privileged, minlength=n).astype(np.int64)
        tripped_rows = np.bincount(actor, weights=trip, minlength=n) > 0
        grants = np.bincount(actor, weights=allowed, minlength=n).astype(np.float32)
        breaker = (self.flags & FLAG_BREAKER) != 0
        expired = breaker & (now >= self.breaker_until) & ~tripped_rows
        self.flags = np.where(expired, self.flags & ~FLAG_BREAKER, self.flags)
        self.flags = np.where(tripped_rows, self.flags | FLAG_BREAKER, self.flags).astype(np.int32)
        cooldown = p.scalar(br["circuit_breaker_cooldown_seconds"])
        self.breaker_until = np.where(tripped_rows, q(now + cooldown),
                                      self.breaker_until).astype(np.float32)
        j0 = cur % k
        calls, privs, stamp = (self.win[:, j0].copy(), self.win[:, j0 + k].copy(),
                               self.win[:, j0 + 2 * k].copy())
        touched = calls_add > 0
        stale = stamp > cur
        keep = (stamp == cur) | stale
        self.win[:, j0] = np.where(touched, np.where(keep, calls, 0) + calls_add, calls)
        self.win[:, j0 + k] = np.where(touched, np.where(keep, privs, 0) + priv_add, privs)
        self.win[:, j0 + 2 * k] = np.where(touched, np.where(stale, stamp, cur), stamp)
        self.tokens = q(refilled - grants).astype(np.float32)
        self.stamp = np.full(n, now, np.float32)
        return {"verdict": verdict, "ring_status": ring_status, "eff_ring": eff.astype(np.int8),
                "sigma_eff": sigma, "severity": severity, "anomaly_rate": anomaly,
                "window_calls": total.astype(np.int32), "tripped": trip}

    def rows(self) -> dict:
        """The actors' gateway columns as the program's table holds them."""
        return {"flags": self.flags, "rl_tokens": self.tokens, "rl_stamp": self.stamp,
                "bd_breaker_until": self.breaker_until, "bd_window": self.win}
