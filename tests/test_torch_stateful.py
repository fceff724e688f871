"""Stateful property test over the port's facade, mirrored onto the
reference's: the counterpart of `tests/integration/test_stateful_coherence.py`.

The reference's hypothesis `RuleBasedStateMachine` (the same rules, the
same invariants and settings: 20 examples of 30 steps, no deadline)
drives the port's `Hypervisor` on the CPU with arbitrary interleavings of
create / join / activate / vouch / leave / terminate / ring updates /
quarantines / drift slashes and demotions / kills / elevations / gateway
calls and waves / sweeps / captures, plus one rule the reference lacks, a
`ManagedSession.write_wave`. Each step runs on the port's facade and then
on the reference's (unarmed), with ids drawn from one counter per package
and one manual clock, and the two returns (or exceptions, by type and
message) must be equal. After every step the reference's invariants hold
on the port (host engines and device plane describe the same world), and
the port's device tables, metrics, trace ring and facade host indices
equal the reference's byte for byte (tolerance 0).

`TestCrossSessionQuarantineRegression` and `TestDriftDemotionLadder` run
the reference's example tests on both packages, asserting the reference's
expectations on each and holding every recorded value equal.
"""

from __future__ import annotations

import asyncio
import importlib
import itertools
import os
import secrets
import uuid

import numpy as np
import pytest
# torch imports its compiler on the first call of some ops (`torch.full`
# among them), and that import draws two `uuid.uuid4()`s
# (`torch.distributed._composable.contract`). Imported here, those draws
# stay off the mirrored per-package id counters whatever ran before in
# the process.
import torch._dynamo  # noqa: F401
from hypothesis import settings
from hypothesis import strategies as st
from hypothesis.stateful import RuleBasedStateMachine, invariant, precondition, rule

import hypervisor_tpu as REF
import hypervisor_tpu_torch as PORT
from hypervisor_tpu import config as jax_config
from hypervisor_tpu.state import HypervisorState as JaxState
from hypervisor_tpu_torch import config as port_config
from hypervisor_tpu_torch.ops import security_ops
from hypervisor_tpu_torch.session import SessionLifecycleError, SessionParticipantError
from hypervisor_tpu_torch.state import HypervisorState as PortState
from hypervisor_tpu_torch.tables.state import FLAG_BLACKLISTED
from tests.test_torch_facade_api import (
    CAP,
    ManualTime,
    assert_same,
    facade_host,
    install_determinism,
    norm,
    tables,
)

AGENTS = [f"did:st{i}" for i in range(8)]
#: Room for the machine's churn: up to 4 live sessions of 5, rows recycled.
STATE_CAP = dict(CAP, max_agents=64, max_sessions=40)


class _InjectableDrift:
    """CMVK verifier stub: the claimed embedding IS the drift score."""

    def verify_embeddings(self, embedding_a, embedding_b, **_):
        class V:
            drift_score = float(embedding_a)
            explanation = None

        return V()


class Mirror:
    """Ids, time and environment for one run over both packages: uuid4 and
    token_hex count from 1 per package (`use` switches the active one),
    `time.time` and every module's `datetime.now` read one manual clock,
    and the reference runs unarmed."""

    def __init__(self) -> None:
        self.mp = pytest.MonkeyPatch()
        self.mp.setenv("HV_WAVE_PALLAS", "0")
        self.mp.setenv("HV_SHA256_PALLAS", "0")
        self.mp.delenv("HV_TRACE", raising=False)
        self.mp.delenv("HV_TRACE_SAMPLE", raising=False)
        self.clock = ManualTime()
        install_determinism(self.mp, self.clock)
        self.ids = {pkg: (itertools.count(1), itertools.count(1)) for pkg in (REF, PORT)}
        self.active = PORT
        # The count sits in the top and the bottom bits: ids built from a
        # uuid's first 8 hex digits (elevations) stay distinct too.
        self.mp.setattr(uuid, "uuid4", lambda: uuid.UUID(
            int=(lambda n: n << 96 | n)(next(self.ids[self.active][0]))))
        self.mp.setattr(secrets, "token_hex", lambda nbytes=None: (
            f"{next(self.ids[self.active][1]):0{2 * (nbytes or 32)}x}"))
        self.loop = asyncio.new_event_loop()

    def close(self) -> None:
        self.loop.close()
        self.mp.undo()

    def use(self, pkg) -> None:
        self.active = pkg

    def facade(self, pkg, cmvk: bool = True):
        self.use(pkg)
        if pkg is REF:
            state = JaxState(jax_config.HypervisorConfig(
                capacity=jax_config.TableCapacity(**STATE_CAP)))
        else:
            state = PortState(port_config.HypervisorConfig(
                capacity=port_config.TableCapacity(**STATE_CAP)), device="cpu")
        kw = {}
        if cmvk:
            adapter = mod(pkg, "integrations.cmvk_adapter").CMVKAdapter
            kw["cmvk"] = adapter(verifier=_InjectableDrift())
        return pkg.Hypervisor(state=state, **kw)

    def run(self, value):
        return self.loop.run_until_complete(value) if asyncio.iscoroutine(value) else value


def comparable(value):
    """A step's return in `norm`-able form: a ManagedSession by its id,
    slot and state."""
    if hasattr(value, "sso") and hasattr(value, "slot"):
        return ("ManagedSession", value.sso.session_id, value.slot, value.sso.state)
    if isinstance(value, tuple):
        return tuple(comparable(v) for v in value)
    return value


def mod(pkg, name: str):
    return importlib.import_module(f"{pkg.__name__}.{name}")


class PlaneCoherence(RuleBasedStateMachine):
    def __init__(self):
        super().__init__()
        self.mirror = Mirror()
        self.hv = self.mirror.facade(PORT)
        self.ref = self.mirror.facade(REF)
        self.sessions: list[str] = []          # live (not terminated)
        self.joined: dict[str, set[str]] = {}  # sid -> dids
        self.steps = 0

    def teardown(self):
        self.mirror.close()

    def both(self, label: str, fn):
        """fn(hv, pkg) on the port's facade, then on the reference's; the
        two returns (or exceptions) must be equal. Returns the port's, or
        raises the port's exception."""
        out = {}
        for pkg, hv in ((PORT, self.hv), (REF, self.ref)):
            self.mirror.use(pkg)
            try:
                out[pkg] = (True, self.mirror.run(fn(hv, pkg)))
            except Exception as exc:  # noqa: BLE001 — compared by type and message
                out[pkg] = (False, exc)
        self.mirror.use(PORT)
        self.steps += 1
        assert_same(f"step {self.steps} {label}", norm(comparable(out[PORT][1])),
                    norm(comparable(out[REF][1])))
        ok, value = out[PORT]
        if not ok:
            raise value
        return value

    def _first_member(self, pick):
        sids = [s for s in self.sessions if self.joined[s]]
        if not sids:
            return None, None
        sid = sids[pick % len(sids)]
        return sid, sorted(self.joined[sid])[0]

    # ── rules (the reference's, each mirrored) ────────────────────────

    @rule()
    def create_session(self):
        if len(self.sessions) >= 4:
            return
        ms = self.both("create", lambda hv, pkg: hv.create_session(
            pkg.SessionConfig(max_participants=5, min_sigma_eff=0.0), creator_did="did:creator"))
        self.sessions.append(ms.sso.session_id)
        self.joined[ms.sso.session_id] = set()

    @precondition(lambda self: self.sessions)
    @rule(agent=st.sampled_from(AGENTS), sigma=st.floats(0.25, 1.0), pick=st.integers(0, 3))
    def join(self, agent, sigma, pick):
        sid = self.sessions[pick % len(self.sessions)]
        try:
            self.both("join", lambda hv, pkg: hv.join_session(sid, agent, sigma_raw=float(sigma)))
            self.joined[sid].add(agent)
        except (SessionParticipantError, SessionLifecycleError):
            pass  # duplicate / capacity / wrong state — legal refusals

    @precondition(lambda self: self.sessions)
    @rule(pick=st.integers(0, 3))
    def activate(self, pick):
        sid = self.sessions[pick % len(self.sessions)]
        try:
            self.both("activate", lambda hv, pkg: hv.activate_session(sid))
        except SessionLifecycleError:
            pass

    @precondition(lambda self: any(self.joined.values()))
    @rule(pick=st.integers(0, 3), voucher=st.sampled_from(AGENTS))
    def vouch(self, pick, voucher):
        sid, vouchee = self._first_member(pick)
        if sid is None or voucher == vouchee:
            return
        try:
            self.both("vouch", lambda hv, pkg: hv.vouching.vouch(voucher, vouchee, sid,
                                                                 voucher_sigma=0.9))
        except Exception:  # noqa: BLE001 — cycle/exposure refusals are fine
            pass

    @precondition(lambda self: any(self.joined.values()))
    @rule(pick=st.integers(0, 3))
    def leave(self, pick):
        sid, agent = self._first_member(pick)
        if sid is None:
            return
        self.both("leave", lambda hv, pkg: hv.leave_session(sid, agent))
        self.joined[sid].discard(agent)

    @precondition(lambda self: self.sessions)
    @rule(pick=st.integers(0, 3))
    def terminate(self, pick):
        sid = self.sessions[pick % len(self.sessions)]
        try:
            root = self.both("terminate", lambda hv, pkg: hv.terminate_session(sid))
        except SessionLifecycleError:
            return
        if self.hv.get_session(sid).delta_engine.turn_count:
            assert root and len(root) == 64
        self.sessions.remove(sid)
        self.joined.pop(sid)

    @precondition(lambda self: any(self.joined.values()))
    @rule(pick=st.integers(0, 3), new_ring=st.integers(1, 3))
    def update_ring(self, pick, new_ring):
        sid, agent = self._first_member(pick)
        if sid is None:
            return
        self.both("ring", lambda hv, pkg: hv.update_agent_ring(
            sid, agent, pkg.ExecutionRing(new_ring), reason="prop"))

    @precondition(lambda self: any(self.joined.values()))
    @rule(pick=st.integers(0, 3))
    def quarantine_agent(self, pick):
        sid, agent = self._first_member(pick)
        if sid is None:
            return
        if self.hv.state.agent_row(agent, self.hv.get_session(sid).slot) is None:
            return

        def quarantine(hv, pkg):
            row = hv.state.agent_row(agent, hv.get_session(sid).slot)
            hv.quarantine.quarantine(agent, sid, mod(pkg, "liability.quarantine").
                                     QuarantineReason.MANUAL, details="prop")
            hv.state.quarantine_rows([row["slot"]], now=hv.state.now())
            return row

        self.both("quarantine", quarantine)

    @precondition(lambda self: any(self.joined.values()))
    @rule(pick=st.integers(0, 3))
    def drift_slash(self, pick):
        """HIGH drift: agent-global slash, session-scoped quarantine."""
        sid, agent = self._first_member(pick)
        if sid is None:
            return
        mask_before = self.hv.state.quarantined_mask().copy()
        self.both("drift_slash", lambda hv, pkg: hv.verify_behavior(
            sid, agent, claimed_embedding=0.6, observed_embedding=0.0))
        flags = np.asarray(self.hv.state.agents.flags)
        mask = self.hv.state.quarantined_mask()
        slot_here = self.hv.get_session(sid).slot
        for row in self.hv.state.agent_rows(agent):
            assert flags[row["slot"]] & FLAG_BLACKLISTED
            assert row["sigma_eff"] == 0.0
            if row["session"] != slot_here:
                assert mask[row["slot"]] == mask_before[row["slot"]], (
                    "quarantine leaked into another session's row")

    @precondition(lambda self: any(self.joined.values()))
    @rule(pick=st.integers(0, 3))
    def kill(self, pick):
        sid, agent = self._first_member(pick)
        if sid is None:
            return
        self.both("kill", lambda hv, pkg: hv.kill_agent(
            sid, agent, in_flight_steps=[{"step_id": "s", "saga_id": "g"}]))
        self.joined[sid].discard(agent)

    @precondition(lambda self: any(self.joined.values()))
    @rule(pick=st.integers(0, 3))
    def drift_demote(self, pick):
        """MEDIUM drift: one-ring demotion on both planes, no slash."""
        sid, agent = self._first_member(pick)
        if sid is None:
            return
        self.both("drift_demote", lambda hv, pkg: hv.verify_behavior(
            sid, agent, claimed_embedding=0.35, observed_embedding=0.0))

    @precondition(lambda self: any(self.joined.values()))
    @rule(pick=st.integers(0, 3))
    def elevate(self, pick):
        from hypervisor_tpu_torch.rings.elevation import RingElevationError

        sid, agent = self._first_member(pick)
        if sid is None:
            return
        ring = self.hv.get_session(sid).sso.get_participant(agent).ring
        if ring.value <= 1:
            return
        try:
            self.both("elevate", lambda hv, pkg: hv.grant_elevation(
                sid, agent, pkg.ExecutionRing(ring.value - 1), ttl_seconds=120))
        except RingElevationError:
            pass  # one live grant per (agent, session) — legal refusal

    @staticmethod
    def _probe(pkg, kind: int, action_id: str):
        return pkg.ActionDescriptor(
            action_id=action_id, name="probe", execute_api="/x",
            undo_api="/u" if kind == 0 else None,
            reversibility=[pkg.ReversibilityLevel.FULL, pkg.ReversibilityLevel.NONE,
                           pkg.ReversibilityLevel.FULL][kind],
            is_read_only=(kind == 2))

    @precondition(lambda self: any(self.joined.values()))
    @rule(pick=st.integers(0, 3), kind=st.integers(0, 2))
    def gateway(self, pick, kind):
        sid, agent = self._first_member(pick)
        if sid is None:
            return
        result = self.both("gateway", lambda hv, pkg: hv.check_action(
            sid, agent, self._probe(pkg, kind, f"act{kind}")))
        row = self.hv.state.agent_row(agent, self.hv.get_session(sid).slot)
        if row is not None and self.hv.state.quarantined_mask()[row["slot"]] and kind != 2:
            assert not result.allowed and (result.quarantined or result.breaker_tripped)
        if self.hv.breach_detector.is_breaker_tripped(agent, sid):
            again = self.both("gateway_again", lambda hv, pkg: hv.check_action(
                sid, agent, self._probe(pkg, kind, f"act{kind}")))
            assert not again.allowed and again.breaker_tripped

    @precondition(lambda self: any(self.joined.values()))
    @rule(pick=st.integers(0, 3), kinds=st.lists(st.integers(0, 2), min_size=1, max_size=6))
    def gateway_wave(self, pick, kinds):
        sids = [s for s in self.sessions if self.joined[s]]
        if not sids:
            return
        sid = sids[pick % len(sids)]
        agents = sorted(self.joined[sid])
        results = self.both("gateway_wave", lambda hv, pkg: hv.check_actions(sid, [
            (agents[i % len(agents)], self._probe(pkg, kind, f"wv{kind}"))
            for i, kind in enumerate(kinds)]))
        assert len(results) == len(kinds)
        for i, (kind, result) in enumerate(zip(kinds, results)):
            row = self.hv.state.agent_row(agents[i % len(agents)], self.hv.get_session(sid).slot)
            if row is not None and self.hv.state.quarantined_mask()[row["slot"]] and kind != 2:
                assert not result.allowed and (result.quarantined or result.breaker_tripped)

    @rule()
    def sweeps(self):
        def sweep(hv, pkg):
            now = hv.state.now()
            return (hv.state.breach_sweep_tick(now), hv.sweep_elevations(),
                    hv.state.quarantine_tick(now))

        self.both("sweeps", sweep)

    @precondition(lambda self: any(self.joined.values()))
    @rule(pick=st.integers(0, 3))
    def capture_delta(self, pick):
        sid, agent = self._first_member(pick)
        if sid is None:
            return
        self.both("capture", lambda hv, pkg: hv.get_session(sid).delta_engine.capture(agent, []))

    # ── one rule beyond the reference's: the session's write wave ─────

    @precondition(lambda self: any(self.joined.values()))
    @rule(pick=st.integers(0, 3), writes=st.lists(st.tuples(st.integers(0, 7), st.integers(0, 2),
                                                            st.integers(0, 3), st.booleans()),
                                                  min_size=1, max_size=8))
    def write_wave(self, pick, writes):
        """Quarantined members are refused before any token burns; every
        outcome equal on both facades."""
        sid, _ = self._first_member(pick)
        if sid is None:
            return

        def wave(hv, pkg):
            ms = hv.get_session(sid)
            w = ms.write_wave()
            for who, path, ring, observe in writes:
                if observe:
                    w.observe(AGENTS[who], f"/doc{path}")
                w.submit(AGENTS[who], f"/doc{path}", f"{who}.{path}", ring=ring)
            return (w.flush(now=hv.state.now()),
                    {p: ms.sso.vfs.read(p) for p in ms.sso.vfs.list_files()})

        report, _ = self.both("write_wave", wave)
        slot = self.hv.get_session(sid).slot
        mask = self.hv.state.quarantined_mask()
        for (who, *_), code in zip(writes, report.status.tolist()):
            row = self.hv.state.agent_row(AGENTS[who], slot)
            held = row is not None and bool(mask[row["slot"]])
            assert (code == PORT.runtime.write_wave.WRITE_QUARANTINED) == held

    # ── invariants: the reference's, on the port, and both packages equal ─

    @invariant()
    def planes_equal_the_reference(self):
        want, got = tables(self.ref.state), tables(self.hv.state)
        assert_same(f"step {self.steps} tables", got, want)
        assert_same(f"step {self.steps} host", norm(facade_host(self.hv)),
                    norm(facade_host(self.ref)))

    @invariant()
    def breach_windows_agree_across_planes(self):
        st_ = self.hv.state
        calls, _ = security_ops.window_totals(st_.agents.bd_window, st_.now(), st_.config.breach)
        calls = np.asarray(calls)
        for sid in self.sessions:
            managed = self.hv.get_session(sid)
            for did in sorted(self.joined[sid]):
                row = st_.agent_row(did, managed.slot)
                if row is None:
                    continue
                hs = self.hv.breach_detector.get_agent_stats(did, sid)
                assert hs["window_calls"] == int(calls[row["slot"]])

    @invariant()
    def participants_match_device_rows(self):
        for sid in self.sessions:
            managed = self.hv.get_session(sid)
            for p in managed.sso.participants:
                row = self.hv.state.agent_row(p.agent_did, managed.slot)
                assert row is not None, f"{p.agent_did} missing from device in {sid}"
                assert row["slot"] >= 0 and row["session"] == managed.slot
                assert int(np.asarray(self.hv.state.agents.ring)[row["slot"]]) == p.ring.value

    @invariant()
    def participant_counts_match(self):
        for sid in self.sessions:
            managed = self.hv.get_session(sid)
            if managed.slot < 0:
                continue
            dev_count = int(np.asarray(self.hv.state.sessions.n_participants)[managed.slot])
            assert dev_count == managed.sso.participant_count

    @invariant()
    def vouch_edges_mirror_host_graph(self):
        host_mirrorable = sum(
            1 for r in self.hv.vouching.all_records()
            if r.is_active and r.session_id in self.sessions
            and self.hv.state.agent_row(r.voucher_did) is not None
            and self.hv.state.agent_row(r.vouchee_did) is not None)
        assert int(np.asarray(self.hv.state.vouches.active).sum()) == host_mirrorable

    @invariant()
    def effective_rings_agree(self):
        eff = self.hv.state.effective_rings(self.hv.state.now())
        for sid in self.sessions:
            managed = self.hv.get_session(sid)
            for p in managed.sso.participants:
                row = self.hv.state.agent_row(p.agent_did, managed.slot)
                if row is None:
                    continue
                host_eff = self.hv.elevation.get_effective_ring(p.agent_did, sid, p.ring)
                assert eff[row["slot"]] == host_eff.value

    @invariant()
    def mirrored_edges_point_at_best_rows(self):
        voucher_col = np.asarray(self.hv.state.vouches.voucher)
        vouchee_col = np.asarray(self.hv.state.vouches.vouchee)
        for vouch_id, edge in self.hv._edge_of_vouch.items():
            record = self.hv.vouching.record(vouch_id)
            if record is None or not record.is_active:
                continue
            managed = self.hv.get_session(record.session_id)
            if managed is None or record.session_id not in self.sessions:
                continue
            for did, col in ((record.voucher_did, voucher_col), (record.vouchee_did, vouchee_col)):
                best = (self.hv.state.agent_row(did, managed.slot)
                        or self.hv.state.agent_row(did))
                assert best is not None, f"mirrored edge for absent {did}"
                assert col[edge] == best["slot"]

    @invariant()
    def quarantine_planes_agree(self):
        mask = self.hv.state.quarantined_mask()
        for sid in self.sessions:
            managed = self.hv.get_session(sid)
            for p in managed.sso.participants:
                row = self.hv.state.agent_row(p.agent_did, managed.slot)
                if row is not None and mask[row["slot"]]:
                    assert self.hv.quarantine.get_active_quarantine(p.agent_did, sid) is not None

    @invariant()
    def delta_log_covers_every_capture(self):
        total = sum(self.hv.get_session(s).delta_engine.turn_count for s in self.sessions)
        dev = int(np.asarray(self.hv.state.delta_log.cursor))
        assert dev + len(self.hv.state._pending_deltas) >= total


_DEEP = os.environ.get("HV_DEEP_STATEFUL", "") == "1"
PlaneCoherence.TestCase.settings = settings(
    max_examples=60 if _DEEP else 20,
    stateful_step_count=60 if _DEEP else 30,
    deadline=None,
)
TestPlaneCoherence = PlaneCoherence.TestCase


# ── the reference's example tests, on both packages ──────────────────


def run_mirrored(body, cmvk: bool = False) -> dict:
    """body(hv, pkg, record) on a fresh facade of each package; returns
    the port's record after holding the two equal."""
    mirror = Mirror()
    logs = {}
    try:
        for pkg in (PORT, REF):
            log: list = []
            hv = mirror.facade(pkg, cmvk=cmvk)
            mirror.run(body(hv, pkg, lambda label, value: log.append((label, norm(value)))))
            logs[pkg] = log
    finally:
        mirror.close()
    assert [k for k, _ in logs[PORT]] == [k for k, _ in logs[REF]]
    for (label, want), (_, got) in zip(logs[REF], logs[PORT]):
        assert_same(label, got, want)
    return dict(logs[PORT])


class TestCrossSessionQuarantineRegression:
    """An agent joins sessions A and B and is quarantined in A: only A's
    membership row is flagged, so B's write waves still serve the agent."""

    def test_quarantine_in_a_does_not_poison_b(self):
        async def body(hv, pkg, record):
            a = await hv.create_session(pkg.SessionConfig(min_sigma_eff=0.0), "did:creator")
            b = await hv.create_session(pkg.SessionConfig(min_sigma_eff=0.0), "did:creator")
            sid_a, sid_b = a.sso.session_id, b.sso.session_id
            await hv.join_session(sid_a, "did:x", sigma_raw=0.8)
            await hv.join_session(sid_b, "did:x", sigma_raw=0.8)
            row_a = hv.state.agent_row("did:x", a.slot)
            row_b = hv.state.agent_row("did:x", b.slot)
            assert row_a is not None and row_b is not None
            assert row_a["slot"] != row_b["slot"]
            assert (row_a["session"], row_b["session"]) == (a.slot, b.slot)
            hv.quarantine.quarantine("did:x", sid_a,
                                     mod(pkg, "liability.quarantine").QuarantineReason.MANUAL,
                                     details="repro")
            hv.state.quarantine_rows([row_a["slot"]], now=hv.state.now())
            mask = hv.state.quarantined_mask()
            assert mask[row_a["slot"]] and not mask[row_b["slot"]]
            assert hv.quarantine.get_active_quarantine("did:x", sid_b) is None
            # B's write path still serves the agent; A's refuses it.
            reports = []
            for ms in (a, b):
                wave = ms.write_wave()
                wave.submit("did:x", "/doc.md", ms.sso.session_id, ring=2)
                reports.append(wave.flush(now=hv.state.now()).status.tolist())
            assert reports == [[3], [0]]  # WRITE_QUARANTINED in A, WRITE_OK in B
            record("rows", (row_a, row_b, reports))
            await hv.leave_session(sid_a, "did:x")
            assert hv.state.agent_row("did:x", a.slot) is None
            assert hv.state.agent_row("did:x", b.slot) is not None
            record("after_leave", hv.state.agent_rows("did:x"))

        run_mirrored(body)

    def test_slash_history_records_pre_slash_sigma(self):
        async def body(hv, pkg, record):
            ms = await hv.create_session(pkg.SessionConfig(min_sigma_eff=0.0), "did:lead")
            sid = ms.sso.session_id
            await hv.join_session(sid, "did:r", sigma_raw=0.8)
            await hv.verify_behavior(sid, "did:r", claimed_embedding=0.6, observed_embedding=0.0)
            slash = hv.slashing.history[-1]
            assert slash.vouchee_sigma_before == pytest.approx(0.8)
            assert ms.sso.get_participant("did:r").sigma_eff == 0.0
            record("history", hv.slashing.history)

        run_mirrored(body, cmvk=True)

    def test_join_repoints_fallback_edge_to_session_row(self):
        async def body(hv, pkg, record):
            x = await hv.create_session(pkg.SessionConfig(min_sigma_eff=0.0), "did:lead")
            z = await hv.create_session(pkg.SessionConfig(min_sigma_eff=0.0), "did:lead")
            sx, sz = x.sso.session_id, z.sso.session_id
            await hv.join_session(sx, "did:A", sigma_raw=0.8)
            await hv.join_session(sz, "did:A", sigma_raw=0.8)
            await hv.join_session(sx, "did:B", sigma_raw=0.9)
            rec = hv.vouching.vouch("did:B", "did:A", sx, voucher_sigma=0.9)
            vouchee = lambda e: int(np.asarray(hv.state.vouches.vouchee)[e])  # noqa: E731
            edge = hv._edge_of_vouch[rec.vouch_id]
            assert vouchee(edge) == hv.state.agent_row("did:A", x.slot)["slot"]
            await hv.leave_session(sx, "did:A")
            edge2 = hv._edge_of_vouch[rec.vouch_id]
            a_z = hv.state.agent_row("did:A", z.slot)["slot"]
            assert vouchee(edge2) == a_z
            y = await hv.create_session(pkg.SessionConfig(min_sigma_eff=0.0), "did:lead")
            sy = y.sso.session_id
            rec2 = hv.vouching.vouch("did:B", "did:A", sy, voucher_sigma=0.9)
            assert vouchee(hv._edge_of_vouch[rec2.vouch_id]) == a_z
            await hv.join_session(sy, "did:A", sigma_raw=0.8)
            edge4 = hv._edge_of_vouch[rec2.vouch_id]
            assert vouchee(edge4) == hv.state.agent_row("did:A", y.slot)["slot"]
            assert bool(np.asarray(hv.state.vouches.active)[edge2])
            record("edges", sorted(hv._edge_of_vouch.items()))

        run_mirrored(body)


class TestDriftDemotionLadder:
    """MEDIUM drift demotes one ring on both planes."""

    def test_medium_drift_demotes_both_planes(self):
        async def body(hv, pkg, record):
            ms = await hv.create_session(pkg.SessionConfig(min_sigma_eff=0.0), "did:lead")
            sid = ms.sso.session_id
            await hv.join_session(sid, "did:m", sigma_raw=0.8)  # Ring 2
            result = await hv.verify_behavior(sid, "did:m", claimed_embedding=0.35,
                                              observed_embedding=0.0)
            assert result.should_demote and not result.should_slash
            assert ms.sso.get_participant("did:m").ring.value == 3
            row = hv.state.agent_row("did:m", ms.slot)
            assert row["ring"] == 3 and row["sigma_eff"] == pytest.approx(0.8)
            assert not np.asarray(hv.state.agents.flags)[row["slot"]] & FLAG_BLACKLISTED
            assert not hv.state.quarantined_mask()[row["slot"]]
            again = await hv.verify_behavior(sid, "did:m", claimed_embedding=0.35,
                                             observed_embedding=0.0)
            assert again.should_demote and ms.sso.get_participant("did:m").ring.value == 3
            record("results", (result, again, row))

        run_mirrored(body, cmvk=True)

    def test_medium_drift_retires_live_elevation(self):
        async def body(hv, pkg, record):
            ms = await hv.create_session(pkg.SessionConfig(min_sigma_eff=0.0), "did:lead")
            sid = ms.sso.session_id
            await hv.join_session(sid, "did:m", sigma_raw=0.8)
            await hv.grant_elevation(sid, "did:m", pkg.ExecutionRing.RING_1_PRIVILEGED)
            await hv.verify_behavior(sid, "did:m", claimed_embedding=0.35,
                                     observed_embedding=0.0)
            assert hv.elevation.get_active_elevation("did:m", sid) is None
            row = hv.state.agent_row("did:m", ms.slot)
            eff = hv.state.effective_rings(hv.state.now())
            assert eff[row["slot"]] == 3
            record("eff", (row, eff))

        run_mirrored(body, cmvk=True)
