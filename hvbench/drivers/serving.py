"""The serving front door: an open loop through `serving.FrontDoor` and
`serving.WaveScheduler` on the virtual clock of `serving.loadgen.run_soak`.

Set-up builds one state of the configuration's tables, a front door at
the traffic's lifecycle turns, and its scheduler, warmed at every bucket
(`WaveScheduler.warm`). The arrivals are `serving.loadgen.generate_trace`
at the traffic's `workload` (the port's `WorkloadSpec` defaults) and
`rate_hz`, made in chunks of `chunk_sessions` sessions, each from its own
seed, offset in virtual time and merged in (time, session, kind) order.
A call advances the virtual clock a tick (`tick_s`) at a time, submitting
every event due as `run_soak` does and running `WaveScheduler.tick`, until
`sessions_per_call` sessions have arrived; the call's latency ends with
`torch.cuda.synchronize()`.

Every wave the scheduler serves is recorded, in order: its class,
its clock, its inputs and its answers (the lifecycle wave's lanes, each
join's status, the gateway's verdicts and ring checks, terminate roots,
saga steps). `judge` replays them all with the plain reference
(`hvbench/reference/serving.py`) and compares the kept calls' answers;
the gateway's state runs through every action wave of the run. It also
holds the front door to serving every arrival: no request shed, and no
accepted ticket left unresolved once the queues are drained after the
run (`collect`).

With spans on, the harness wraps the submits (`client`) and each class's
dispatch (`lifecycle`, `join`, `action`, `terminate`, `saga`), and the
layers under them as `facade_wave` does: the state's lane staging
(`staging`) and audit booking (`audit_booking`), the fused lifecycle
wave (`state._WAVE`, `dispatch`) with its epilogue's enqueue
(`epilogue`), and the gateway (`gateway`). The gateway runs in waves of
its own here (`state._GATEWAY`), each wrapped in `dispatch` too, so that
`dispatch_ms` (dispatch less gateway and epilogue) stays the fused
wave's own enqueue.
"""

from __future__ import annotations

import heapq
import json
import sys
import time
from collections import Counter

import numpy as np

from hvbench.drivers.facade_wave import hypervisor_config
from hvbench import work
from hvbench.reference import FLOAT32, Precision, differ
from hvbench.reference import serving as ref
from hvbench.trace import maybe_span

CLASSES = ("lifecycle", "join", "action", "terminate", "saga")
ARRIVALS = ("create", "lifecycle")
#: What the judge's replay of the whole run needs of each wave: the
#: agent rows a join or a lifecycle lane was admitted into are the front
#: door's choice (rows recycle), and an action acts on its row's state.
HISTORY = {"lifecycle": ("now", "sigma", "row"),
           "join": ("now", "session", "did", "sigma", "status", "row"),
           "action": ("now", "row", "did", "required"),
           "terminate": ("session",)}


class Arrivals:
    """The trace, chunk by chunk: chunk k covers virtual seconds
    [k D, (k + 1) D), D = `chunk_sessions` / `rate_hz`, and its events
    (terminations up to `max_lifetime_s` later) join one heap."""

    def __init__(self, traffic: dict, seed: int) -> None:
        from hypervisor_tpu_torch.serving.loadgen import WorkloadSpec

        self.spec = dict(traffic["workload"], rate_hz=float(traffic["rate_hz"]),
                         turns=int(traffic["turns"]))
        self.span = int(traffic["chunk_sessions"]) / float(traffic["rate_hz"])
        self.seed = int(seed)
        self.spec_type = WorkloadSpec
        self.heap: list = []
        self.next_chunk = 0
        self.seq = 0

    def chunk_seed(self, k: int) -> int:
        return int(np.random.SeedSequence([self.seed, 5, k]).generate_state(1)[0])

    def _add_chunk(self) -> None:
        from hypervisor_tpu_torch.serving.loadgen import generate_trace

        k = self.next_chunk
        self.next_chunk += 1
        spec = self.spec_type(seed=self.chunk_seed(k), duration_s=self.span, **self.spec)
        t0 = k * self.span
        for e in generate_trace(spec):
            e = dict(e, t=round(t0 + e["t"], 6), sid=f"k{k}:{e['sid']}")
            if "did" in e:
                e["did"] = f"did:{e['sid']}:{e['did'].rsplit(':', 1)[1]}"
            heapq.heappush(self.heap, (e["t"], e["sid"], e["kind"], self.seq, e))
            self.seq += 1

    def due(self, now: float):
        """Pop the next event due at `now`, or None."""
        while self.next_chunk * self.span <= now:
            self._add_chunk()
        if self.heap and self.heap[0][0] <= now:
            return heapq.heappop(self.heap)[-1]
        return None


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, spans=None) -> None:
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.spans = device, spans
        self.sessions_per_call = int(traffic["sessions_per_call"])
        self.tick_s = float(traffic["tick_s"])
        self.calls = 0
        self.setup_stages: dict = {}
        self.history: list = []   # every served wave: (call, class, record)
        self.current: list = []   # this call's served waves, answers still on the device
        self.last = None
        self.shed = Counter()
        self.open: list = []      # accepted tickets not yet resolved
        self.orphaned = 0
        self.arrived = 0
        self.now = 0.0

    def sync(self) -> None:
        import torch

        if self.state.device.type == "cuda":
            torch.cuda.synchronize(self.state.device)

    def setup(self) -> None:
        from hypervisor_tpu_torch.serving.front_door import FrontDoor, ServingConfig
        from hypervisor_tpu_torch.serving.scheduler import WaveScheduler
        from hypervisor_tpu_torch.state import HypervisorState

        t = time.perf_counter()
        self.state = HypervisorState(hypervisor_config(self.config), device=self.device)
        self.front = FrontDoor(self.state,
                               ServingConfig(lifecycle_turns=int(self.traffic["turns"])))
        self.sched = WaveScheduler(self.front)
        self.sched.warm(now=0.0)
        self.sync()
        self.setup_stages["state_and_warm"] = time.perf_counter() - t
        self.arrivals = Arrivals(self.traffic, self.seed)
        self.slot_of_sid: dict[str, int] = {}
        self.live_sids: set[str] = set()
        self.saga_count = 0
        self.did_of: dict[int, str] = {}   # id(action ticket) -> its member's did
        self.body_seed: dict[str, int] = {}  # queued lifecycle -> its bodies' seed
        self._wrap()
        if self.spans is not None:
            self._wrap_layers()
        t = time.perf_counter()
        for _ in range(int(self.traffic["warmup_calls"])):
            self.call()
        self.sync()
        self.setup_stages["warmup_calls"] = time.perf_counter() - t

    # ── recording the served waves ───────────────────────────────────

    def _wrap(self) -> None:
        st, sc, fd = self.state, self.sched, self.front
        wave, gate, claim = st.run_governance_wave, st.check_actions_wave, st._claim_wave_rows
        out: dict = {}

        def run_wave(*args, **kwargs):
            out["wave"] = r = wave(*args, **kwargs)
            return r

        def check(*args, **kwargs):
            out["gate"] = r = gate(*args, **kwargs)
            return r

        def claim_rows(*args, **kwargs):
            out["rows"] = r = claim(*args, **kwargs)
            return r

        st.run_governance_wave, st.check_actions_wave = run_wave, check
        st._claim_wave_rows = claim_rows

        def member_row(session: int, did: str) -> int:
            """The agent row a join was admitted into, -1 if refused."""
            return st._slot_of_member.get((st.agent_ids.lookup(did), session), -1)

        def dispatch(name, fn, before, after):
            def call(*args):
                pre = before(*args)
                with maybe_span(self.spans, name):
                    fn(*args)
                rec = after(pre)
                if rec is not None:
                    self.current.append((name, rec))
            return call

        def lifecycles_after(tickets):
            if not tickets:
                return None
            r = out.pop("wave")
            k = len(tickets)
            return {"now": self.tick_now, "sigma": [t.payload["sigma_raw"] for t in tickets],
                    "row": out.pop("rows")[:k].tolist(),
                    "body_seed": [self.body_seed.pop(t.payload["session_id"]) for t in tickets],
                    "status": [t.status for t in tickets],
                    "root": [t.result["merkle_root"] for t in tickets],
                    "lanes": (r.ring[:k], r.sigma_eff[:k], r.saga_step_state[:k])}

        def joins_after(tickets):
            return {"now": self.tick_now,
                    "session": [t.payload["session_slot"] for t in tickets],
                    "did": [t.payload["agent_did"] for t in tickets],
                    "sigma": [t.payload["sigma_raw"] for t in tickets],
                    "status": [t.status for t in tickets],
                    "row": [member_row(t.payload["session_slot"], t.payload["agent_did"])
                            for t in tickets]}

        def actions_after(tickets):
            if not tickets:
                return None
            g = out.pop("gate")
            n = len(tickets)
            return {"now": self.tick_now, "row": [t.payload["slot"] for t in tickets],
                    "did": [self.did_of.pop(id(t)) for t in tickets],
                    "required": [t.payload["required_ring"] for t in tickets],
                    "verdict": g.verdict[:n], "ring_status": g.ring_status[:n]}

        def terminations_after(tickets):
            if not tickets:
                return None
            return {"session": [t.payload["session_slot"] for t in tickets],
                    "root": [t.result["merkle_root"] for t in tickets]}

        def sagas_after(queued):
            taken = [t for t in queued if t.done]
            if not taken:
                return None
            return {"saga": [t.payload["saga_slot"] for t in taken],
                    "ok": [t.payload["ok"] for t in taken]}

        sc._dispatch_lifecycles = dispatch("lifecycle", sc._dispatch_lifecycles,
                                           lambda tickets, now: list(tickets), lifecycles_after)
        sc._dispatch_joins = dispatch("join", sc._dispatch_joins,
                                      lambda now: list(fd.joins), joins_after)
        sc._dispatch_actions = dispatch("action", sc._dispatch_actions,
                                        lambda tickets, now: list(tickets), actions_after)
        sc._dispatch_terminations = dispatch("terminate", sc._dispatch_terminations,
                                             lambda tickets, now: list(tickets),
                                             terminations_after)
        sc._dispatch_sagas = dispatch("saga", sc._dispatch_sagas,
                                      lambda now: list(fd.saga_steps), sagas_after)

    def _wrap_layers(self) -> None:
        from hypervisor_tpu_torch import state as state_mod
        from hypervisor_tpu_torch.ops import pipeline

        sp, st = self.spans, self.state
        st._stage_wave_lanes = sp.wrap("staging", st._stage_wave_lanes)
        st._book_wave_audit = sp.wrap("audit_booking", st._book_wave_audit)
        self._saved = (state_mod._WAVE, state_mod._GATEWAY, pipeline.gateway_ops.check_actions,
                       pipeline.schema.update_gauges)
        state_mod._WAVE = sp.wrap("dispatch", self._saved[0])
        state_mod._GATEWAY = sp.wrap("dispatch", sp.wrap("gateway", self._saved[1]))
        pipeline.gateway_ops.check_actions = sp.wrap("gateway", self._saved[2])
        pipeline.schema.update_gauges = sp.wrap("epilogue", self._saved[3])

    def _unwrap_layers(self) -> None:
        from hypervisor_tpu_torch import state as state_mod
        from hypervisor_tpu_torch.ops import pipeline

        if getattr(self, "_saved", None):
            (state_mod._WAVE, state_mod._GATEWAY, pipeline.gateway_ops.check_actions,
             pipeline.schema.update_gauges) = self._saved
            self._saved = None

    # ── the open loop ────────────────────────────────────────────────

    def _submit(self, e: dict) -> None:
        """One trace event into the front door, as `run_soak` submits it."""
        st, fd, kind, now = self.state, self.front, e["kind"], e["t"]
        sid = e["sid"]
        if kind == "create":
            self.slot_of_sid[sid] = st.create_session(sid, self.sched._lifecycle_config(),
                                                      now=now)
            self.live_sids.add(sid)
            return
        if kind == "lifecycle":
            self.body_seed[sid] = e["body_seed"]
            out = fd.submit_lifecycle(sid, e["did"], e["sigma"],
                                      delta_bodies=ref.lifecycle_bodies(e["body_seed"],
                                                                        int(self.traffic["turns"])),
                                      now=now)
        else:
            slot = self.slot_of_sid.get(sid)
            if slot is None or sid not in self.live_sids:
                self.orphaned += 1
                return
            if kind == "join":
                out = fd.submit_join(slot, e["did"], e["sigma"], now=now)
            elif kind == "action":
                row = st.agent_row(e["did"], slot)
                if row is None:
                    self.orphaned += 1
                    return
                out = fd.submit_action(row["slot"], required_ring=e["required_ring"],
                                       is_read_only=e["read_only"], now=now)
                if not out.refused:
                    self.did_of[id(out)] = e["did"]
            elif kind == "saga":
                saga = st.create_saga(f"{sid}:saga{self.saga_count}", slot, [{"has_undo": False}])
                self.saga_count += 1
                out = fd.submit_saga_step(saga, e["ok"], now=now)
            else:  # terminate
                self.live_sids.discard(sid)
                out = fd.submit_terminate(slot, now=now)
        if out.refused:
            self.shed[out.kind] += 1
        else:
            self.open.append(out)

    def call(self) -> float:
        """Ticks until `sessions_per_call` more sessions have arrived;
        returns the call's ms (host clock, synchronised)."""
        target = self.arrived + self.sessions_per_call
        self.current = []
        t = time.perf_counter_ns()
        while True:
            with maybe_span(self.spans, "client"):
                while self.arrived < target:
                    e = self.arrivals.due(self.now)
                    if e is None:
                        break
                    self._submit(e)
                    self.arrived += e["kind"] in ARRIVALS
            self.tick_now = self.now
            self.sched.tick(now=self.now)
            self.now += self.tick_s
            if self.arrived >= target:
                break
        self.sync()
        ms = (time.perf_counter_ns() - t) / 1e6
        self.history.extend((self.calls, name, {k: rec[k] for k in HISTORY[name]})
                            for name, rec in self.current if name in HISTORY)
        self.last = self.current
        self.open = [t for t in self.open if not t.done]
        self.calls += 1
        return ms

    def keep(self) -> dict:
        """The last call's served waves, their answers on the host now;
        its sagas' step states read now (settled: no later round moves a
        one-step saga's step)."""
        kept: dict = {name: [] for name in CLASSES}
        for name, rec in self.last:
            rec = dict(rec)
            if name == "lifecycle":
                ring, sigma_eff, step = rec.pop("lanes")
                rec.update(ring=ring.cpu().numpy(), sigma_eff=sigma_eff.cpu().numpy(),
                           saga_step_state=step.cpu().numpy())
            elif name == "action":
                rec.update(verdict=rec["verdict"].cpu().numpy(),
                           ring_status=rec["ring_status"].cpu().numpy())
            elif name == "saga":
                import torch

                idx = torch.as_tensor(rec["saga"], dtype=torch.int64, device=self.state.device)
                rec["step"] = self.state.sagas.step_state[idx, 0].cpu().numpy()
            kept[name].append(rec)
        return kept

    def roofline_work(self) -> list:
        """The chain (B2's ring form, with its append) and root work of the
        lifecycles a call is expected to carry (`sessions_per_call` times
        the trace's lifecycle share), and B7's at the one-step sagas it is
        expected to submit, as (kernel, shapes). The lifecycle waves run
        padded to their bucket and B7 ticks the whole table: the share
        counts the real sessions and sagas alone."""
        w = self.traffic["workload"]
        k = round(self.sessions_per_call * float(w["lifecycle_fraction"]))
        sagas = round(self.sessions_per_call * (1 - float(w["lifecycle_fraction"]))
                      * float(w["saga_fraction"]))
        t = int(self.traffic["turns"])
        pairs, dup = work.tree_pairs([t] * k, 1 << max(0, (t - 1).bit_length()))
        return [("chain_digests_ring", dict(turns=t, lanes=k, rows=k * t)),
                ("tree_roots", dict(lanes=k, leaves=k * t, pairs=pairs, dup_pairs=dup)),
                ("saga_tick_block", dict(sagas=sagas,
                                         steps=int(self.config["capacity"]["max_steps_per_saga"])))]

    def collect(self, kept: dict) -> dict:
        """The run's record; first serves what the queues still hold (no
        arrival is added), so that an accepted ticket left unresolved is
        one the front door lost."""
        self.sched.drain(now=self.now)
        self.sync()
        self._unwrap_layers()
        unresolved = sum(not t.done for t in self.open)
        stats = {"serving_stats": {"calls": self.calls, "virtual_s": self.now,
                                   "shed": dict(self.shed), "unresolved": unresolved,
                                   "orphaned": self.orphaned,
                                   "sagas_created": self.state._next_saga_slot,
                                   "max_sagas": int(self.state.sagas.saga_state.shape[0]),
                                   "waves": dict(self.front.waves)}}
        print(json.dumps(stats), file=sys.stderr)
        self.state = self.front = self.sched = self.last = self.current = None
        self.open = []
        return {"calls": self.calls, "kept": kept, "history": self.history,
                "shed": dict(self.shed), "unresolved": unresolved}


#: Each class's check and the fields of its answer that are compared.
COMPARED = {"join": ("joins", ("status",)),
            "action": ("actions", ("verdict", "ring_status")),
            "lifecycle": ("lifecycles", ("status", "ring", "sigma_eff", "saga_step_state", "root")),
            "terminate": ("terminations", ("root",)),
            "saga": ("saga_steps", ("step",))}
CHECKS = ("lifecycles", "joins", "actions", "terminations", "saga_steps", "unjudged_actions",
          "missing_calls", "shed", "unresolved")


def answers(config: dict, traffic: dict, rec: dict, prec: Precision):
    """(call, class, got, want) for every kept answer of a run: `got` is
    the record's dict that holds the program's answer (a join's history
    entry, else the kept wave), `want` the reference's at `prec`, under
    the fields `COMPARED` names. Every lifecycle lane and join the
    reference admits resets the agent row the program admitted it into,
    and the gateway's state runs through every action wave of the run,
    kept or not."""
    turns = int(traffic["turns"])
    sessions = ref.Sessions(int(traffic["member_cap"]))
    gateway = ref.RowGateway(config, prec)
    kept = rec["kept"]
    actions_seen = Counter()

    def admit(lanes: dict, rows, now: float) -> None:
        rows = np.asarray(rows, np.int64)
        ok = (lanes["status"] == ref.ADMIT_OK) & (rows >= 0)
        gateway.admit(rows[ok], lanes["ring"][ok], lanes["sigma_eff"][ok], now)

    for c, name, r in rec["history"]:
        if name == "lifecycle":
            admit(ref.admission(config, r["sigma"], prec), r["row"], r["now"])
        elif name == "join":
            want = ref.join_flush(config, sessions, r["session"], r["sigma"], prec)
            admit(want, r["row"], r["now"])
            if c in kept:
                yield c, "join", r, {"status": want["status"]}
        elif name == "action":
            want = gateway.call(np.array(r["row"], np.int64), np.array(r["required"], np.int8),
                                r["now"])
            if c in kept and actions_seen[c] < len(kept[c]["action"]):
                got = kept[c]["action"][actions_seen[c]]
                actions_seen[c] += 1
                yield c, "action", got, {f: want[f] for f in ("verdict", "ring_status")}
        else:  # terminate
            sessions.terminated.update(int(s) for s in r["session"])
    for c, waves in kept.items():
        for got in waves["lifecycle"]:
            want = ref.lifecycle_wave(config, np.array(got["sigma"], np.float32),
                                      got["body_seed"], turns, prec)
            yield c, "lifecycle", got, {**{f: want[f] for f in COMPARED["lifecycle"][1][:-1]},
                                        "root": want["merkle_root"]}
        for got in waves["terminate"]:
            yield c, "terminate", got, {"root": ref.terminate_roots(len(got["root"]))}
        for got in waves["saga"]:
            yield c, "saga", got, {"step": ref.saga_steps(got["ok"])}


def judge(config: dict, traffic: dict, seed: int, rec: dict, window_calls: int,
          prec: Precision = FLOAT32):
    """(checks, failed calls): the kept calls' served waves against the
    reference, every kept action wave judged, every arrival served."""
    bad, failed = Counter(), set()
    judged_actions = Counter()
    for c, name, got, want in answers(config, traffic, rec, prec):
        check, fields = COMPARED[name]
        d = np.zeros(len(want[fields[0]]), bool)
        for f in fields:
            d |= differ(got[f], want[f])
        bad[check] += int(d.sum())
        judged_actions[c] += name == "action"
        failed |= {c} if d.any() else set()
    for c, waves in rec["kept"].items():
        bad["unjudged_actions"] += len(waves["action"]) - judged_actions[c]
    bad["missing_calls"] = max(0, min(int(traffic["check_calls"]), window_calls)
                               - len(rec["kept"]))
    bad["shed"] = sum(rec["shed"].values())
    bad["unresolved"] = int(rec["unresolved"])
    return {n: {"value": int(bad[n]), "limit": 0} for n in CHECKS}, failed


def reference_record(config: dict, traffic: dict, seed: int, calls: int, kept_calls,
                     prec: Precision) -> dict:
    """What a program whose answers were the reference's at `prec` would
    leave after `calls` calls, keeping `kept_calls`: the control puts this
    in the program's place. Which requests share a wave, and when each is
    served, is the front door's: this runs the program at the cell's own
    size (on the card where there is one) for the record's served waves,
    then puts the reference's answers at `prec` in the place of the
    program's."""
    import torch

    drv = Driver(config, traffic, seed, "cuda" if torch.cuda.is_available() else "cpu")
    drv.setup()
    kept = {}
    while drv.calls < calls:
        c = drv.calls
        drv.call()
        if c in kept_calls:
            kept[c] = drv.keep()
    rec = drv.collect(kept)
    for *_, got, want in list(answers(config, traffic, rec, prec)):
        got.update(want)
    return rec
