"""The tenant arena's batched wave, `TenantArena.governance_wave_batch`.

Set-up builds one `TenantArena` of the configuration's `tenants` tenants,
each on the configuration's tables, with its standing actors
(`facade_wave.place_actors` on each tenant). A call is one client cycle
over the arena, back to back:

  * one `create_sessions_batch` for every tenant's sessions, padded to
    the traffic's bucket;
  * each tenant's vouch edges from its actors toward the agent rows its
    wave's first lanes will claim (`add_vouch`, bond from the traffic,
    no bond percentage; `gen.claimed_rows` on the tenant's allocator);
  * one `governance_wave_batch` of every tenant's wave, padded to the
    bucket, then `torch.cuda.synchronize()`: the call's latency;
  * each tenant's `free_edge_rows`.

The arena hands back each lane's status and each session's root and FSM
error; the driver also keeps the batched dispatch's own result (each
lane's ring, sigma_eff and saga step, each session's chain, each
tenant's released count) by wrapping `tenancy.arena._TENANT_WAVE_DONATED`
where the arena looks it up.

A kept call (`keep`) also holds, read at once (a later wrap of a
tenant's DeltaLog evicts it), each tenant's sessions' Merkle frontiers,
the DeltaLog digests at the rows of its audit index (gathered from the
stacked log) and its device DeltaLog cursor beside the host mirror.

With spans on, the harness wraps `arena.sync` (`tenant_sync`), the
batched dispatch (`tenant_dispatch`), each tenant's lane staging
(`staging`) and audit booking (`audit_booking`), and the client's calls
(`client`).
"""

from __future__ import annotations

import itertools
import time
from collections import Counter

import numpy as np

from hvbench import gen
from hvbench import work
from hvbench.drivers.facade_wave import (
    LANE_FIELDS, SESSION_FIELDS, audit_index_differs, hypervisor_config, place_actors)
from hvbench.reference import FLOAT32, Precision, differ
from hvbench.reference import facade as facade_ref
from hvbench.reference import tenants as ref
from hvbench.reference.audit import words_hex
from hvbench.trace import maybe_span


class TenantTraffic:
    """The inputs of every call of an arena cell, tenant by tenant.

    Call c creates `tenant_sessions[t]` sessions on tenant t, vouches for
    its first `tenant_vouched[t]` lanes' rows, and runs its wave of one
    join a session (sigma `sigma_vouched` on the vouched lanes and
    `sigma` on the rest) and `turns` delta bodies a session, at the
    virtual time `now(c)`. Each tenant's bodies come from its own seeded
    stream, a pool of `input_pool` draws with the call index folded into
    each body."""

    def __init__(self, config: dict, traffic: dict, seed: int) -> None:
        self.k = [int(x) for x in traffic["tenant_sessions"]]
        self.vouched = [int(x) for x in traffic["tenant_vouched"]]
        self.n = len(self.k)
        self.bucket = int(traffic["bucket"])
        if self.n != int(config["tenants"]) or len(self.vouched) != self.n:
            raise ValueError(f"the traffic names {self.n} tenants' sessions and "
                             f"{len(self.vouched)} tenants' vouches; the configuration has "
                             f"{config['tenants']} tenants")
        if any(v > k for v, k in zip(self.vouched, self.k)) or max(self.k) > self.bucket:
            raise ValueError(f"tenant sessions {self.k} and vouches {self.vouched} do not fit "
                             f"a bucket of {self.bucket}")
        self.turns = int(traffic["turns"])
        self.pool = int(traffic["input_pool"])
        self.now_step = float(traffic["now_step_s"])
        self.bodies = [gen.rng(seed, 16 + t).integers(0, 2**32, (self.pool, self.turns, k, 16),
                                                      dtype=np.uint32)
                       for t, k in enumerate(self.k)]
        self.sigma = []
        for k, v in zip(self.k, self.vouched):
            s = np.full(k, float(traffic["sigma"]), np.float32)
            s[:v] = float(traffic["sigma_vouched"])
            self.sigma.append(s)

    def now(self, c: int) -> float:
        return self.now_step * (c + 1)

    def session_ids(self, t: int, c: int) -> list:
        return [f"t{t}:c{c}:s{i}" for i in range(self.k[t])]

    def dids(self, t: int, c: int) -> list:
        return [f"did:t{t}:c{c}:{i}" for i in range(self.k[t])]

    def bodies_of(self, t: int, c: int) -> np.ndarray:
        """u32[T, K_t, 16]: tenant t's pool draw c mod P with c folded
        into word 0."""
        out = self.bodies[t][c % self.pool].copy()
        out[:, :, 0] ^= np.uint32(c & 0xFFFFFFFF)
        return out


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, spans=None) -> None:
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.spans = device, spans
        self.gen = TenantTraffic(config, traffic, seed)
        self.sessions_per_call = sum(self.gen.k)
        self.n_agents = int(config["capacity"]["max_agents"])
        self.calls = 0
        self.last = None
        self.result = None
        self._saved = None
        self.setup_stages: dict = {}

    def sync(self) -> None:
        import torch

        if self.arena.device.type == "cuda":
            torch.cuda.synchronize(self.arena.device)

    def setup(self) -> None:
        from hypervisor_tpu_torch.models import SessionConfig
        from hypervisor_tpu_torch.tenancy import TenantArena

        t = time.perf_counter()
        self.arena = TenantArena(self.gen.n, hypervisor_config(self.config), device=self.device)
        self.sync()
        self.setup_stages["arena"] = time.perf_counter() - t
        t = time.perf_counter()
        self.actor_rows = [place_actors(st, self.config) for st in self.arena.tenants]
        self.arena.sync()
        self.sync()
        self.setup_stages["actors"] = time.perf_counter() - t
        self.session_config = SessionConfig(
            min_sigma_eff=float(self.traffic["session_min_sigma"]),
            max_participants=int(self.traffic["session_max_participants"]))
        self._wrap_layers()
        t = time.perf_counter()
        for _ in range(int(self.traffic["warmup_calls"])):
            self.call()
        self.sync()
        self.setup_stages["warmup_calls"] = time.perf_counter() - t

    def _wrap_layers(self) -> None:
        """Keep the batched dispatch's result (always) and, with spans on,
        wrap the arena's layers in the harness's spans."""
        from hypervisor_tpu_torch.tenancy import arena as arena_mod

        dispatch = arena_mod._TENANT_WAVE_DONATED

        def kept(*args, **kwargs):
            self.result = dispatch(*args, **kwargs)
            return self.result

        self._saved = dispatch
        sp = self.spans
        if sp is None:
            arena_mod._TENANT_WAVE_DONATED = kept
            return
        arena_mod._TENANT_WAVE_DONATED = sp.wrap("tenant_dispatch", kept)
        self.arena.sync = sp.wrap("tenant_sync", self.arena.sync)
        for st in self.arena.tenants:
            st._stage_wave_lanes = sp.wrap("staging", st._stage_wave_lanes)
            st._book_wave_audit = sp.wrap("audit_booking", st._book_wave_audit)

    def _unwrap_layers(self) -> None:
        from hypervisor_tpu_torch.tenancy import arena as arena_mod

        if self._saved is None:
            return
        arena_mod._TENANT_WAVE_DONATED, self._saved = self._saved, None
        self.arena.__dict__.pop("sync", None)
        for st in self.arena.tenants:
            st.__dict__.pop("_stage_wave_lanes", None)
            st.__dict__.pop("_book_wave_audit", None)

    def call(self) -> float:
        """One client cycle; returns the batched wave call's ms (host
        clock, synchronised). Its answers are left in `self.last`."""
        c, g, arena = self.calls, self.gen, self.arena
        with maybe_span(self.spans, "client"):
            slots = arena.create_sessions_batch({t: g.session_ids(t, c) for t in range(g.n)},
                                                self.session_config, pad_to=g.bucket)
            bond = float(self.traffic["vouch_bond"])
            edges = {}
            for t, st in enumerate(arena.tenants):
                rows = gen.claimed_rows(st._next_agent_slot, st._free_agent_slots,
                                        self.n_agents, g.bucket)
                actors = self.actor_rows[t]
                edges[t] = [st.add_vouch(int(actors[i % len(actors)]), int(rows[i]),
                                         int(slots[t][i]), bond, bond_pct=0.0)
                            for i in range(g.vouched[t])]
            lanes = {t: {"session_slots": slots[t], "dids": g.dids(t, c),
                         "agent_sessions": slots[t], "sigma_raw": g.sigma[t],
                         "delta_bodies": g.bodies_of(t, c)} for t in range(g.n)}
        t0 = time.perf_counter_ns()
        out = arena.governance_wave_batch(lanes, g.bucket, now=g.now(c),
                                          omega=float(self.traffic["omega"]))
        self.sync()
        ms = (time.perf_counter_ns() - t0) / 1e6
        with maybe_span(self.spans, "client"):
            for t, st in enumerate(arena.tenants):
                st.free_edge_rows(edges[t])
        self.last = {"slots": slots, "out": out, "result": self.result}
        self.calls += 1
        return ms

    def keep(self) -> dict:
        """The last call's answers, with each tenant's sessions' Merkle
        frontiers, the DeltaLog digests at their audit rows and the
        DeltaLog cursors, gathered on the device now."""
        import torch

        arena, res = self.arena, self.last["result"]
        dev = arena.device
        t_idx, row_idx, counts, frontiers = [], [], [], []
        for t, st in enumerate(arena.tenants):
            rows = [st._audit_rows.get(int(s), ()) for s in self.last["slots"][t]]
            n = np.array([len(r) for r in rows], np.int64)
            row_idx.append(np.fromiter(itertools.chain.from_iterable(rows), np.int64,
                                       int(n.sum())))
            t_idx.append(np.full(int(n.sum()), t, np.int64))
            counts.append(n)
            frontiers.append([st._frontier.get(int(s)) for s in self.last["slots"][t]])
        log = arena._stacked["delta_log"]
        digests = log.digest[torch.from_numpy(np.concatenate(t_idx)).to(dev),
                             torch.from_numpy(np.concatenate(row_idx)).to(dev)]
        return {"slots": self.last["slots"], "out": self.last["out"],
                **{f: getattr(res, f).clone() for f in LANE_FIELDS + ("chain", "released")},
                "frontiers": frontiers, "audit_counts": counts, "audit_digests": digests,
                "delta_cursor": log.cursor.clone(),
                "cursor_mirror": [st._delta_cursor for st in arena.tenants]}

    def roofline_work(self) -> list:
        """The tenant wave's kernel work at one call's real sessions and
        lanes (totals over the tenants, not the padded bucket), as
        (kernel, shapes): the four tenant forms and B3 over the real
        lanes' trees."""
        g = self.gen
        k, v, t = sum(g.k), sum(g.vouched), g.turns
        admitted = sum(int((facade_ref.lanes(self.config, {**self.traffic, "vouched": vt},
                                             s)["status"] == facade_ref.ADMIT_OK).sum())
                       for vt, s in zip(g.vouched, g.sigma))
        pairs, dup = work.tree_pairs([t] * k, 1 << max(0, (t - 1).bit_length()))
        return [("contribution_toward_tenants", dict(edges=v, agents=k)),
                ("admission_block_tenants", dict(lanes=k, admitted=admitted)),
                ("fsm_saga_block_tenants", dict(sessions=k, lanes=k, edges=v, vouched=v,
                                                agents=k, agent_hits=admitted)),
                ("chain_digests_ring_tenants", dict(turns=t, lanes=k, rows=k * t)),
                ("tree_roots", dict(lanes=k, leaves=k * t, pairs=pairs, dup_pairs=dup))]

    def collect(self, kept: dict) -> dict:
        """The kept calls' answers on the host, tenant by tenant, with the
        sessions' rows and host frontier roots; then frees the arena."""
        import torch

        from hypervisor_tpu_torch.tables.state import (
            SF32_TERMINATED_AT, SI32_NPART, SI32_STATE)

        self._unwrap_layers()
        g, sessions = self.gen, self.arena._stacked["sessions"]

        def host(v):
            v = v.cpu().numpy()
            return v.view(np.uint32) if v.dtype == np.int32 and v.ndim >= 2 else v

        out = {}
        for c, ans in kept.items():
            lanes = {f: host(ans[f]) for f in LANE_FIELDS}
            chain, released = host(ans["chain"]), host(ans["released"])
            digests, cursors = host(ans["audit_digests"]), host(ans["delta_cursor"])
            d_off = np.cumsum([0] + [int(n.sum()) for n in ans["audit_counts"]])
            tenants = []
            for t in range(g.n):
                b, k = g.k[t], len(ans["slots"][t])
                idx = torch.as_tensor(np.asarray(ans["slots"][t], np.int64),
                                      device=sessions.i32.device)
                wave = ans["out"][t]
                tenants.append({
                    **{f: lanes[f][t, :b] for f in LANE_FIELDS},
                    "status": np.asarray(wave.status), "merkle_root": np.asarray(wave.merkle_root),
                    "fsm_error": np.asarray(wave.fsm_error),
                    "lane_status": lanes["status"][t, :b],
                    "chain": chain[t][:, :k], "released": int(released[t]),
                    "session_state": sessions.i32[t, idx, SI32_STATE].cpu().numpy(),
                    "npart": sessions.i32[t, idx, SI32_NPART].cpu().numpy(),
                    "terminated_at": sessions.f32[t, idx, SF32_TERMINATED_AT].cpu().numpy(),
                    "frontier": [f.root_hex() if f is not None else None
                                 for f in ans["frontiers"][t]],
                    "audit_counts": ans["audit_counts"][t],
                    "audit_digests": digests[d_off[t]:d_off[t + 1]],
                    "delta_cursor": int(cursors[t]),
                    "cursor_mirror": int(ans["cursor_mirror"][t])})
            out[c] = tenants
        self.arena = self.last = self.result = None
        return {"calls": self.calls, "kept": out}


def reference_record(config: dict, traffic: dict, seed: int, calls: int, kept_calls,
                     prec: Precision) -> dict:
    """What a sound program's `collect` would return, from the reference
    at precision `prec`: the control puts this in the program's place."""
    g = TenantTraffic(config, traffic, seed)
    kept = {c: [{**a, "lane_status": a["status"], "cursor_mirror": a["delta_cursor"]}
                for a in ref.call_answers(config, traffic, g, c, prec)]
            for c in kept_calls}
    return {"calls": calls, "kept": kept}


def tenant_checks(got: dict, want: dict) -> Counter:
    """One tenant's differences from its reference, by check."""
    bad = Counter()
    d = differ(got["lane_status"], want["status"])
    for f in LANE_FIELDS:
        d |= differ(got[f], want[f])
    bad["lanes"] = int(d.sum())
    k = len(want["merkle_root"])
    s = differ(np.transpose(got["chain"], (1, 0, 2)), np.transpose(want["chain"], (1, 0, 2)))
    s |= differ(got["merkle_root"], want["merkle_root"])
    for f in SESSION_FIELDS:
        s |= differ(got[f], want[f])
    bad["sessions"] = int(s.sum())
    bad["released"] = int(int(got["released"]) != int(want["released"]))
    if len(got["frontier"]) != k:
        f = np.ones(k, bool)
    else:
        f = np.array([h != words_hex(r) for h, r in zip(got["frontier"], want["merkle_root"])],
                     bool)
    bad["frontier_roots"] = int(f.sum())
    bad["audit_index"] = int(audit_index_differs(got["audit_counts"], got["audit_digests"],
                                                 want["chain"]).sum())
    bad["cursors"] = int(got["delta_cursor"] != want["delta_cursor"]
                         or got["cursor_mirror"] != want["delta_cursor"])
    return bad


NAMES = ("lanes", "sessions", "released", "frontier_roots", "audit_index", "cursors",
         "missing_calls")


def judge(config: dict, traffic: dict, seed: int, rec: dict, window_calls: int):
    """(checks, failed calls): every kept call's every tenant against its
    own reference; every limit 0."""
    g = TenantTraffic(config, traffic, seed)
    bad, failed = Counter(), set()
    for c, got in rec["kept"].items():
        want = ref.call_answers(config, traffic, g, c, FLOAT32)
        if len(got) != len(want):
            bad["lanes"] += sum(g.k)
            failed.add(c)
            continue
        for got_t, want_t in zip(got, want):
            b = tenant_checks(got_t, want_t)
            bad.update(b)
            if any(b.values()):
                failed.add(c)
    bad["missing_calls"] = max(0, min(int(traffic["check_calls"]), window_calls)
                               - len(rec["kept"]))
    return {n: {"value": int(bad[n]), "limit": 0} for n in NAMES}, failed
