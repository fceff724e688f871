"""The facade's lifecycle wave, `HypervisorState.run_governance_wave`.

Set-up builds one state of the configuration's tables with its standing
actors (`place_actors`, a copy of `chip_smoke.py`'s `place_actors`,
lines 666-697 at commit c365212, sized from the configuration). A call
is one client cycle on that state, back to back:

  * the client creates the call's sessions (`create_sessions_batch`),
    vouches from standing actors toward the agent rows the wave's first
    lanes will claim (`add_vouch`, bond from the traffic, no bond
    percentage), and builds the joins;
  * one `run_governance_wave` with the joins, the delta bodies and the
    actors' gateway actions, padded to the traffic's bucket, then
    `torch.cuda.synchronize()`: the call's latency;
  * the client recycles the edge rows the wave released
    (`free_edge_rows`).

A kept call (`keep`) also holds what its audit booking left on the host,
read at once, outside the call's clock, since a later wrap of the
DeltaLog evicts it: each session's Merkle frontier and the DeltaLog
digests at the rows of its audit index.

With spans on, the harness wraps the state's lane staging and audit
booking, the fused wave's dispatch (`state._WAVE`), the gateway's and
the epilogue's enqueue, as `chip_smoke.py`'s `facade_timing` does
(lines 7194-7245 at commit c365212).
"""

from __future__ import annotations

import itertools
import time
from collections import Counter

import numpy as np

from hvbench import gen
from hvbench import work
from hvbench.reference import FLOAT32, Precision, differ
from hvbench.reference import facade as ref
from hvbench.reference.audit import words_hex
from hvbench.trace import maybe_span

LANE_FIELDS = ("status", "ring", "sigma_eff", "saga_step_state")
SESSION_FIELDS = ("fsm_error", "session_state", "npart", "terminated_at")
GATEWAY_FIELDS = ("verdict", "ring_status", "eff_ring", "sigma_eff", "severity", "anomaly_rate",
                  "window_calls", "tripped")
ACTOR_FIELDS = ("flags", "rl_tokens", "rl_stamp", "bd_breaker_until", "bd_window")


def hypervisor_config(config: dict):
    """The program's `HypervisorConfig` of a configuration file."""
    from hypervisor_tpu_torch.config import (
        BreachConfig, HypervisorConfig, RateLimitConfig, TableCapacity, TrustConfig)

    rl = {k: tuple(v) for k, v in config["rate_limit"].items()}
    return HypervisorConfig(trust=TrustConfig(**config["trust"]),
                            breach=BreachConfig(**config["breach"]),
                            rate_limit=RateLimitConfig(**rl),
                            capacity=TableCapacity(**config["capacity"]))


def place_actors(state, config: dict) -> np.ndarray:
    """The configuration's standing members of one session, on rows
    claimed through the state's row allocator (no wave takes them), with
    the actor ring, sigma and tokens, and the sudo grants on the first of
    them. Returns their rows."""
    import torch

    from hypervisor_tpu_torch.models import SessionConfig
    from hypervisor_tpu_torch.tables.state import (
        AF32_RL_TOKENS, AF32_SIGMA_EFF, AF32_SIGMA_RAW, AI32_DID, AI32_FLAGS, AI32_SESSION,
        FLAG_ACTIVE, SI32_NPART)

    n = int(config["actors"])
    grants = config["actor_grants"]
    dev = state.device
    session = state.create_session("facade:actors", SessionConfig(max_participants=n), now=0.0)
    rows = torch.from_numpy(state._claim_wave_rows(n).astype(np.int64)).to(dev)
    handles = np.array([state.agent_ids.intern(f"did:actor:{i}") for i in range(n)], np.int32)
    a = state.agents
    a.i32[rows, AI32_DID] = torch.from_numpy(handles).to(dev)
    a.i32[rows, AI32_SESSION] = session
    a.i32[rows, AI32_FLAGS] = FLAG_ACTIVE
    a.ring[rows] = int(config["actor_ring"])
    for col in (AF32_SIGMA_RAW, AF32_SIGMA_EFF):
        a.f32[rows, col] = float(config["actor_sigma"])
    a.f32[rows, AF32_RL_TOKENS] = float(config["actor_tokens"])
    state.sessions.i32[session, SI32_NPART] = n
    e, g = state.elevations, len(grants)
    e.agent[:g] = rows[:g].to(torch.int32)
    e.granted_ring[:g] = torch.tensor([r for r, _ in grants], dtype=torch.int8).to(dev)
    e.expires_at[:g] = torch.tensor([t for _, t in grants], dtype=torch.float32).to(dev)
    e.active[:g] = True
    return rows.cpu().numpy()


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, spans=None) -> None:
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.spans = device, spans
        self.gen = gen.FacadeTraffic(config, traffic, seed)
        self.sessions_per_call = self.gen.k
        self.pad = tuple(traffic["pad_to"]) if traffic.get("pad_to") else None
        self.b_wave = self.pad[0] if self.pad else self.gen.k
        self.calls = 0
        self.last = None
        self.setup_stages: dict = {}

    def sync(self) -> None:
        import torch

        if self.state.device.type == "cuda":
            torch.cuda.synchronize(self.state.device)

    def setup(self) -> None:
        from hypervisor_tpu_torch.models import SessionConfig
        from hypervisor_tpu_torch.state import HypervisorState

        t = time.perf_counter()
        self.state = HypervisorState(hypervisor_config(self.config), device=self.device)
        self.sync()
        self.setup_stages["state"] = time.perf_counter() - t
        t = time.perf_counter()
        self.actor_rows = place_actors(self.state, self.config)
        self.setup_stages["actors"] = time.perf_counter() - t
        self.session_config = SessionConfig(
            min_sigma_eff=float(self.traffic["session_min_sigma"]),
            max_participants=int(self.traffic["session_max_participants"]))
        if self.spans is not None:
            self._wrap_layers()
        t = time.perf_counter()
        for _ in range(int(self.traffic["warmup_calls"])):
            self.call()
        self.sync()
        self.setup_stages["warmup_calls"] = time.perf_counter() - t

    def _wrap_layers(self) -> None:
        from hypervisor_tpu_torch import state as state_mod
        from hypervisor_tpu_torch.ops import pipeline

        sp, st = self.spans, self.state
        st._stage_wave_lanes = sp.wrap("staging", st._stage_wave_lanes)
        st._book_wave_audit = sp.wrap("audit_booking", st._book_wave_audit)
        # The gateway and the epilogue run inside the dispatch: their
        # enqueue is split out of it when read.
        self._saved = (state_mod._WAVE, pipeline.gateway_ops.check_actions,
                       pipeline.schema.update_gauges)
        state_mod._WAVE = sp.wrap("dispatch", self._saved[0])
        pipeline.gateway_ops.check_actions = sp.wrap("gateway", self._saved[1])
        pipeline.schema.update_gauges = sp.wrap("epilogue", self._saved[2])

    def _unwrap_layers(self) -> None:
        from hypervisor_tpu_torch import state as state_mod
        from hypervisor_tpu_torch.ops import pipeline

        if getattr(self, "_saved", None):
            (state_mod._WAVE, pipeline.gateway_ops.check_actions,
             pipeline.schema.update_gauges) = self._saved
            self._saved = None

    def call(self) -> float:
        """One client cycle; returns the wave call's ms (host clock,
        synchronised). Its answers are left in `self.last`."""
        c, g, st = self.calls, self.gen, self.state
        with maybe_span(self.spans, "client"):
            slots = st.create_sessions_batch(g.session_ids(c), self.session_config)
            rows = gen.claimed_rows(st._next_agent_slot, st._free_agent_slots,
                                    st.agents.i32.shape[0], self.b_wave)
            bond, n_act = float(self.traffic["vouch_bond"]), len(self.actor_rows)
            edges = [st.add_vouch(int(self.actor_rows[i % n_act]), int(rows[i]), int(slots[i]),
                                  bond, bond_pct=0.0) for i in range(g.vouched)]
            dids, bodies = g.dids(c), g.bodies_of(c)
            actor, required = g.actions_of(c)
            actions = {"slots": self.actor_rows[actor], "required_rings": required}
        t = time.perf_counter_ns()
        result, gw = st.run_governance_wave(slots, dids, slots, g.sigma, bodies, now=g.now(c),
                                            omega=float(self.traffic["omega"]), actions=actions,
                                            pad_to=self.pad)
        self.sync()
        ms = (time.perf_counter_ns() - t) / 1e6
        with maybe_span(self.spans, "client"):
            st.free_edge_rows(edges)
        self.last = {"slots": slots, "released": result.released, "chain": result.chain,
                     "merkle_root": result.merkle_root, "fsm_error": result.fsm_error,
                     **{f: getattr(result, f) for f in LANE_FIELDS},
                     **{f"gw_{f}": getattr(gw, f) for f in GATEWAY_FIELDS}}
        self.calls += 1
        return ms

    def keep(self) -> dict:
        """The last call's answers, with its sessions' Merkle frontiers
        and the DeltaLog digests at their audit rows, gathered on the
        device now."""
        import torch

        st = self.state
        slots = [int(s) for s in self.last["slots"]]
        rows = [st._audit_rows.get(s, ()) for s in slots]
        counts = np.array([len(r) for r in rows], np.int64)
        flat = np.fromiter(itertools.chain.from_iterable(rows), np.int64, int(counts.sum()))
        digests = st.delta_log.digest[torch.from_numpy(flat).to(st.device)]
        return {**self.last, "frontiers": [st._frontier.get(s) for s in slots],
                "audit_counts": counts, "audit_digests": digests}

    def roofline_work(self) -> list:
        """The chain (B2's ring form, with its append) and root work one
        call's real sessions need, as (kernel, shapes)."""
        k, t = self.gen.k, self.gen.turns
        pairs, dup = work.tree_pairs([t] * k, 1 << max(0, (t - 1).bit_length()))
        return [("chain_digests_ring", dict(turns=t, lanes=k, rows=k * t)),
                ("tree_roots", dict(lanes=k, leaves=k * t, pairs=pairs, dup_pairs=dup))]

    def collect(self, kept: dict) -> dict:
        """The kept calls' answers, their sessions' host frontier roots and
        the actors' final gateway rows, on the host; then frees the state."""
        import torch

        from hypervisor_tpu_torch.tables.state import (
            AF32_BD_BREAKER_UNTIL, AF32_RL_STAMP, AF32_RL_TOKENS, AI32_BD_WIN_START,
            AI32_BD_WIN_STOP, AI32_FLAGS, SF32_TERMINATED_AT, SI32_NPART, SI32_STATE)

        self._unwrap_layers()
        st = self.state

        def host(v):
            if isinstance(v, torch.Tensor):
                v = v.cpu().numpy()
                return v.view(np.uint32) if v.dtype == np.int32 and v.ndim >= 2 else v
            return np.asarray(v)

        out = {}
        for c, ans in kept.items():
            frontiers = ans.pop("frontiers")
            h = {k: host(v) for k, v in ans.items()}
            h["frontier"] = [f.root_hex() if f is not None else None for f in frontiers]
            idx = torch.as_tensor(h["slots"].astype(np.int64), device=st.device)
            h["session_state"] = st.sessions.i32[idx, SI32_STATE].cpu().numpy()
            h["npart"] = st.sessions.i32[idx, SI32_NPART].cpu().numpy()
            h["terminated_at"] = st.sessions.f32[idx, SF32_TERMINATED_AT].cpu().numpy()
            out[c] = h
        rows = torch.as_tensor(self.actor_rows, device=st.device)
        i32, f32 = st.agents.i32[rows].cpu().numpy(), st.agents.f32[rows].cpu().numpy()
        actors = {"flags": i32[:, AI32_FLAGS], "rl_tokens": f32[:, AF32_RL_TOKENS],
                  "rl_stamp": f32[:, AF32_RL_STAMP],
                  "bd_breaker_until": f32[:, AF32_BD_BREAKER_UNTIL],
                  "bd_window": i32[:, AI32_BD_WIN_START:AI32_BD_WIN_STOP]}
        self.state = self.last = None
        return {"calls": self.calls, "kept": out, "actors": actors}


def reference_record(config: dict, traffic: dict, seed: int, calls: int, kept_calls,
                     prec: Precision) -> dict:
    """What a sound program's `collect` would return, from the reference
    at precision `prec`: the control puts this in the program's place."""
    g = gen.FacadeTraffic(config, traffic, seed)
    gw = ref.Gateway(config, prec)
    kept = {}
    for c in range(calls):
        actor, required = g.actions_of(c)
        lanes = gw.call(actor, required, g.now(c))
        if c in kept_calls:
            a = ref.call_answers(config, traffic, g, c, prec)
            kept[c] = {**{f: a[f] for f in LANE_FIELDS + SESSION_FIELDS},
                       "chain": a["chain"], "merkle_root": a["merkle_root"],
                       "released": a["released"],
                       **{f"gw_{f}": lanes[f] for f in GATEWAY_FIELDS},
                       "frontier": [words_hex(r) for r in a["merkle_root"]],
                       "audit_counts": np.full(g.k, g.turns, np.int64),
                       "audit_digests": np.transpose(a["chain"], (1, 0, 2)).reshape(-1, 8)}
    return {"calls": calls, "kept": kept, "actors": gw.rows()}


def audit_index_differs(counts: np.ndarray, digests: np.ndarray, chain: np.ndarray) -> np.ndarray:
    """bool[K]: the sessions whose audit index does not hold their T
    chain digests, in turn order (`digests` u32[sum(counts), 8], the
    DeltaLog's rows the index lists, session by session; `chain` the
    reference's u32[T, K, 8])."""
    t, k = chain.shape[:2]
    if len(digests) != t * k:
        return np.ones(k, bool)
    return (np.asarray(counts) != t) | differ(np.asarray(digests).reshape(k, t, 8),
                                              np.transpose(chain, (1, 0, 2)))


def judge(config: dict, traffic: dict, seed: int, rec: dict, window_calls: int):
    """(checks, failed calls): each number compared with its limit."""
    g = gen.FacadeTraffic(config, traffic, seed)
    gw = ref.Gateway(config, FLOAT32)
    kept = rec["kept"]
    bad = Counter()
    failed = set()
    for c in range(rec["calls"]):
        actor, required = g.actions_of(c)
        lanes = gw.call(actor, required, g.now(c))
        if c in kept:
            d = np.zeros(len(actor), bool)
            for f in GATEWAY_FIELDS:
                d |= differ(kept[c][f"gw_{f}"], lanes[f])
            bad["gateway_actions"] += int(d.sum())
            failed |= {c} if d.any() else set()
    for c, got in kept.items():
        want = ref.call_answers(config, traffic, g, c, FLOAT32)
        d = np.zeros(g.k, bool)
        for f in LANE_FIELDS:
            d |= differ(got[f], want[f])
        bad["lanes"] += int(d.sum())
        s = differ(np.transpose(got["chain"], (1, 0, 2)), np.transpose(want["chain"], (1, 0, 2)))
        s |= differ(got["merkle_root"], want["merkle_root"])
        for f in SESSION_FIELDS:
            s |= differ(got[f], want[f])
        bad["sessions"] += int(s.sum())
        bad["released"] += int(int(got["released"]) != int(want["released"]))
        f = np.array([h != words_hex(r) for h, r in zip(got["frontier"], want["merkle_root"])])
        bad["frontier_roots"] += int(f.sum())
        x = audit_index_differs(got["audit_counts"], got["audit_digests"], want["chain"])
        bad["audit_index"] += int(x.sum())
        if (d.any() or s.any() or f.any() or x.any()
                or int(got["released"]) != int(want["released"])):
            failed.add(c)
    want_rows = gw.rows()
    a = np.zeros(len(want_rows["flags"]), bool)
    for f in ACTOR_FIELDS:
        a |= differ(rec["actors"][f], want_rows[f])
    bad["actor_rows"] = int(a.sum())
    bad["missing_calls"] = max(0, min(int(traffic["check_calls"]), window_calls) - len(kept))
    names = ("lanes", "sessions", "released", "gateway_actions", "frontier_roots", "audit_index",
             "actor_rows", "missing_calls")
    return {n: {"value": int(bad[n]), "limit": 0} for n in names}, failed
