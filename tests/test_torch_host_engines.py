"""The port's host engines against the reference's, on the CPU.

The facade's engines (sessions, rings, liability, sagas, audit,
verification, security, integrations, the event bus) are pure host
code. Most are copies of the reference's modules with their imports
pointed at the port; `test_copied_modules_equal_the_reference` holds
each copy to its reference counterpart as text, so a copy cannot drift
unseen, and lists every module that differs with its reason.

The other cases run seeded sequences through the engines of both
packages, covering the curated host-plane files of `tests/conftest.py`
(`test_models.py`, `test_rings.py`, `test_liability.py`, `test_saga.py`,
`test_vfs.py`, `test_vfs_extended.py`, `test_session_security.py`,
`test_verification_and_adapters.py`, `test_observability.py`,
`test_audit.py`), and hold every recorded value equal (tolerance 0),
with ids and time patched the same way for both packages
(`test_torch_facade_api.install_determinism`). Where an engine meets the
device plane (the event bus rows into `EventLog.append_batch`, the
vouch graph into `VouchTable`, a `DeltaEngine` root of 64 deltas or
more through `ops.merkle`), the port runs on the CPU and the tables are
compared byte for byte.
"""

from __future__ import annotations

import ast
import asyncio
import datetime as _dt
import importlib
import re
import types
from pathlib import Path

import numpy as np
import pytest

import hypervisor_tpu as REF
import hypervisor_tpu_torch as PORT
from tests.test_torch_facade_api import (
    Drift,
    ManualTime,
    assert_logs_equal,
    call,
    install_determinism,
    norm,
)

REF_ROOT = Path(REF.__file__).resolve().parent
PORT_ROOT = Path(PORT.__file__).resolve().parent

#: Modules the port copies from the reference, imports rewritten.
COPIES = (
    "audit/__init__.py", "audit/commitment.py", "audit/gc.py",
    "integrations/__init__.py", "integrations/cmvk_adapter.py",
    "integrations/iatp_adapter.py", "integrations/nexus_adapter.py",
    "liability/__init__.py", "liability/attribution.py", "liability/collusion.py",
    "liability/ledger.py", "liability/matrix.py", "liability/quarantine.py",
    "liability/slashing.py",
    "api/__init__.py", "api/models.py", "api/server.py",
    "models/__init__.py",
    "observability/attribution.py", "observability/causal_trace.py",
    "observability/event_bus.py", "observability/history.py",
    "observability/incidents.py", "observability/slo.py",
    "resilience/policy.py", "resilience/wal.py",
    "reversibility/__init__.py",
    "rings/__init__.py", "rings/breach_detector.py", "rings/classifier.py",
    "rings/elevation.py",
    "saga/__init__.py", "saga/checkpoint.py", "saga/fan_out.py", "saga/orchestrator.py",
    "security/__init__.py", "security/action_gateway.py", "security/kill_switch.py",
    "security/rate_limiter.py",
    "serving/__init__.py", "serving/front_door.py", "serving/loadgen.py",
    "autopilot/ledger.py", "autopilot/plane.py", "autopilot/rules.py",
    "autopilot/signals.py",
    "session/__init__.py", "session/intent_locks.py", "session/isolation.py",
    "session/vector_clock.py", "session/vfs.py",
    "tables/intern.py",
    "utils/clock.py", "utils/status.py",
    "verification/__init__.py",
    "adversarial/__init__.py", "adversarial/scoring.py",
    "fleet/registry.py", "fleet/trace.py", "fleet/rebalance.py",
    "parallel/__init__.py",
)

#: Modules of the facade's slice that differ from their counterpart, and why.
EXCEPTIONS = {
    "core.py": "tables on a torch device (`device=`); device columns read back "
               "through `_host`; the write "
               "wave on the state's device; the serving front door attached on the "
               "state's device",
    "parallel/mesh.py": "a single-controller mesh over torch devices (a virtual mesh "
                        "repeats a device); no fallback to the host: too few CUDA "
                        "devices raise",
    "parallel/sharding.py": "a sharded column is D row parts (views on the column's "
                            "own device), placed by `split_rows`/`shard_table`",
    "parallel/collectives.py": "each shard_map body is per-shard phases joined by "
                               "explicit collectives (psum in rank order from zero, "
                               "all_gather, ppermute); the sharded admission's "
                               "sigma is one fused multiply-add; the cascade runs "
                               "`slash_cascade(allreduce=)` over edge-shard tables",
    "runtime/consistency.py": "lanes and partials cross to the state's torch device "
                              "(`_put`, `.cpu()`); the tick and reconcile are "
                              "closures, not jitted programs",
    "resilience/supervisor.py": "the restore rung recovers onto the state's own "
                                "device; a periodic checkpoint never swallows a "
                                "CUDA error",
    "audit/delta.py": "the device root runs `ops.merkle.merkle_root_lanes` on the "
                      "engine's torch device; the native root binds the port's own "
                      "C++ library (`runtime.native`)",
    "liability/vouching.py": "`to_device` builds the port's `VouchTable` of torch "
                             "tensors on a given device",
    "serving/scheduler.py": "each wave's lanes are read back from torch tensors inside "
                            "the wall bracket, and the saga round waits for the device, "
                            "so the wave wall covers the device time",
    "api/service.py": "`device_stats.backend` is the state's torch device type; "
                      "`/debug/profile` opens a torch.profiler window",
    "autopilot/soak.py": "`run_autopilot_soak(device=)` builds each run's state on "
                         "that torch device; the docstrings name no bench gate",
    "adversarial/adversaries.py": "each adversary takes `device=` (the card by "
                                  "default) and builds every state, facade and "
                                  "service on it; device columns are read back "
                                  "through `core._host`",
    "adversarial/noisy_neighbor.py": "`device=` for the arena, the shared state and "
                                     "the solo oracles; the corruption writes a "
                                     "copy of the lent agents' f32 column and "
                                     "rebinds it (no `.at[].set`)",
    "testing/scenarios.py": "`run_scenario`/`run_all` take `device=`; the docstring "
                            "names the port's card check, not the bench gates",
    "fleet/worker.py": "`WorkerSpec.device` (the card by default); the service and "
                       "arena are built on it, and a durable worker's arena too (its "
                       "SIGTERM drain syncs the arena before the checkpoint's host "
                       "copy); no JAX platform or compile-cache environment; "
                       "`log_dir=` keeps each worker's stderr; SIGUSR1 prints the "
                       "worker's kernel launch counts (`FleetSupervisor.launch_counts`)",
}

#: Copies with a few named edits: the reference's text with each `old`
#: replaced by `new` (and each `old` present in the reference) equals the
#: port's, byte for byte.
EDITED_COPIES = {
    "fleet/drain.py": ("the docstring and one section comment leave out the "
                       "reference's change-request number", [
                           ("The PR 16 tenant-label merge is the template",
                            "The tenant-label merge is the template"),
                           ("# ── exposition merge (the PR 16 template, worker axis) ───────────────",
                            "# ── exposition merge (the tenant template, worker axis) ─────────────"),
                       ]),
    "fleet/failover.py": ("`_absorb` recovers the tenant onto the target arena's own "
                          "torch device; the docstrings leave out the reference's "
                          "change-request number", [
                              ("recover_tenant` — PR 4's restore sequence per tenant), "
                              "splice it into",
                              "recover_tenant` — the restore sequence per tenant), "
                              "splice it into"),
                              ("as tiebreak, per-tenant recovery is PR 4's deterministic "
                               "restore",
                               "as tiebreak, per-tenant recovery is the deterministic "
                               "restore"),
                              ("        # match the donor's checkpoint — restore validates).\n",
                               "        # match the donor's checkpoint — restore validates). The state\n"
                               "        # is recovered onto the target arena's own torch device.\n"),
                              ("            source_epoch_dir, tenant, config=cfg\n        )",
                               "            source_epoch_dir, tenant, config=cfg,\n"
                               "            device=target.arena.device,\n        )"),
                          ]),
}

#: Modules the port copies with a module docstring of its own, and why:
#: everything after the docstring equals the reference's as text.
DOCSTRING_EDITS = {
    "observability/snapshot.py": "the docstring leaves out the reference's "
                                 "change-request numbers",
    "autopilot/__init__.py": "the docstring leaves out the reference's "
                             "change-request number",
    "tenancy/front_door.py": "the docstring leaves out the reference's "
                             "change-request numbers",
    "tenancy/__init__.py": "the docstring describes the port's tenant forms, "
                           "not the reference's TPU footprint",
    "fleet/__init__.py": "the docstring names the torch device a worker is pinned "
                         "to and leaves out the reference's round and change-request "
                         "numbers",
}

#: Modules of the same packages ported by earlier slices (not copies).
EARLIER = ("audit/frontier.py", "saga/state_machine.py", "saga/dsl.py")


def _rewritten(path: Path) -> str:
    return re.sub(r"\bhypervisor_tpu\b", "hypervisor_tpu_torch", path.read_text())


def _split_docstring(text: str) -> tuple[str, str]:
    """(module docstring, the rest of the text, line for line)."""
    lines = text.splitlines(keepends=True)
    end = ast.parse(text).body[0].end_lineno
    return "".join(lines[:end]), "".join(lines[end:])


def test_copied_modules_equal_the_reference():
    for rel in COPIES:
        assert (PORT_ROOT / rel).read_text() == _rewritten(REF_ROOT / rel), (
            f"{rel} drifted from its reference counterpart")
    for rel, reason in EXCEPTIONS.items():
        assert reason and (PORT_ROOT / rel).read_text() != _rewritten(REF_ROOT / rel), rel
    for rel, reason in DOCSTRING_EDITS.items():
        port_doc, port_rest = _split_docstring((PORT_ROOT / rel).read_text())
        ref_doc, ref_rest = _split_docstring(_rewritten(REF_ROOT / rel))
        assert reason and port_doc != ref_doc, rel
        assert port_rest == ref_rest, f"{rel} drifted from its reference counterpart"
    for rel, (reason, edits) in EDITED_COPIES.items():
        text = _rewritten(REF_ROOT / rel)
        for old, new in edits:
            assert reason and text.count(old) == 1, (rel, old)
            text = text.replace(old, new)
        assert (PORT_ROOT / rel).read_text() == text, f"{rel} drifted from its reference counterpart"
    packages = ("audit", "integrations", "liability", "reversibility", "rings", "saga",
                "security", "session", "verification", "adversarial", "fleet")
    present = {str(p.relative_to(PORT_ROOT)) for pkg in packages
               for p in (PORT_ROOT / pkg).glob("*.py")}
    assert present == ({c for c in COPIES if c.split("/")[0] in packages}
                       | {e for e in EXCEPTIONS if e.split("/")[0] in packages}
                       | {e for e in EDITED_COPIES if e.split("/")[0] in packages}
                       | {e for e in DOCSTRING_EDITS if e.split("/")[0] in packages}
                       | set(EARLIER))


# ── seeded sequences on both packages ────────────────────────────────


def run_both(sequence) -> tuple[list, list]:
    logs = []
    for pkg in (REF, PORT):
        clock = ManualTime()
        with pytest.MonkeyPatch.context() as mp:
            install_determinism(mp, clock)
            mp.setenv("HV_ROOFLINE", "0")
            log: list = []
            api = types.SimpleNamespace(
                pkg=pkg, clock=clock, rng=np.random.RandomState(7),
                mod=lambda name, pkg=pkg: importlib.import_module(f"{pkg.__name__}.{name}"),
                rec=lambda label, value, log=log: log.append((label, norm(value))),
            )
            result = sequence(api)
            if asyncio.iscoroutine(result):
                asyncio.run(result)
        logs.append(log)
    return logs[0], logs[1]


def models_case(a):
    m = a.pkg
    sigmas = np.concatenate([a.rng.uniform(0, 1, 64), [0.6, 0.95, 0.6000001, 0.95000001, 0.0, 1.0]])
    a.rec("rings", [(m.ExecutionRing.from_sigma_eff(float(s)),
                     m.ExecutionRing.from_sigma_eff(float(s), has_consensus=True)) for s in sigmas])
    actions = [m.ActionDescriptor(action_id=f"a{i}", name="n", execute_api="/x",
                                  reversibility=rev, is_read_only=ro, is_admin=adm)
               for i, (rev, ro, adm) in enumerate(
                   (rev, ro, adm) for rev in ("full", "partial", "none")
                   for ro in (False, True) for adm in (False, True))]
    a.rec("actions", [(x, x.required_ring, x.risk_weight) for x in actions])
    a.rec("levels", [(lv.code, lv.risk_weight_range, lv.default_risk_weight)
                     for lv in m.ReversibilityLevel])
    a.rec("states", [(st.code, m.SessionState.from_code(st.code)) for st in m.SessionState])
    a.rec("modes", [(md.code, m.ConsistencyMode.from_code(md.code)) for md in m.ConsistencyMode])
    a.rec("config", (m.SessionConfig(), m.SessionParticipant("did:x"),
                     a.mod("models").new_id("session"), a.mod("models").RISK_WEIGHT_DEFAULTS))


def rings_case(a):
    m = a.pkg
    enforcer = m.RingEnforcer()
    out = []
    for ring in m.ExecutionRing:
        for req in ("admin", "none", "full", "read"):
            act = m.ActionDescriptor(action_id=req, name=req, execute_api="/x",
                                     is_admin=req == "admin", is_read_only=req == "read",
                                     reversibility="none" if req in ("admin", "none") else "full")
            for sigma in (0.3, 0.61, 0.96):
                for cons in (False, True):
                    for wit in (False, True):
                        out.append(enforcer.check(ring, act, sigma, cons, wit))
    a.rec("checks", out)
    a.rec("demote", [enforcer.should_demote(r, s) for r in m.ExecutionRing for s in (0.3, 0.7)])
    clf = m.ActionClassifier()
    acts = [m.ActionDescriptor(action_id=f"c{i}", name="n", execute_api="/x",
                               reversibility=("full", "partial", "none")[i % 3],
                               is_read_only=i % 4 == 0) for i in range(9)]
    a.rec("classify", [clf.classify(x) for x in acts])
    a.rec("batch", (clf.classify_batch(acts), clf.columns()))
    det = m.RingBreachDetector()
    events = []
    for i in range(14):
        events.append(det.record_call("did:p", "s1", m.ExecutionRing.RING_2_STANDARD,
                                      m.ExecutionRing.RING_0_ROOT if i % 3 else
                                      m.ExecutionRing.RING_2_STANDARD))
        a.clock.advance(0.25)
    a.rec("breach", (events, det.is_breaker_tripped("did:p", "s1"),
                     det.get_agent_stats("did:p", "s1"), det.breach_history, det.breach_count))
    a.clock.advance(64.0)
    a.rec("cooled", det.is_breaker_tripped("did:p", "s1"))
    mgr = m.RingElevationManager()
    g = mgr.request_elevation("did:e", "s1", m.ExecutionRing.RING_2_STANDARD,
                              m.ExecutionRing.RING_1_PRIVILEGED, ttl_seconds=30)
    a.rec("grant", (g, mgr.get_effective_ring("did:e", "s1", m.ExecutionRing.RING_2_STANDARD),
                    call(mgr.request_elevation, "did:e", "s1", m.ExecutionRing.RING_2_STANDARD,
                            m.ExecutionRing.RING_0_ROOT)))
    a.rec("child", (mgr.register_child("did:e", "did:kid", m.ExecutionRing.RING_1_PRIVILEGED),
                    mgr.get_children("did:e"), mgr.get_parent("did:kid")))
    a.clock.advance(32.0)
    a.rec("expired", (mgr.tick(), mgr.active_elevations, mgr.elevation_count))


def liability_case(a):
    m = a.pkg
    eng = m.VouchingEngine()
    recs = [call(eng.vouch, f"did:v{i % 3}", f"did:e{i % 5}", "s1",
                    voucher_sigma=float(a.rng.uniform(0.4, 1.0)),
                    bond_pct=float(a.rng.uniform(0.05, 0.4)))
            for i in range(12)]
    a.rec("vouches", recs)
    a.rec("cycle", call(eng.vouch, "did:e0", "did:v0", "s1", voucher_sigma=0.9))
    a.rec("sigma", [eng.compute_sigma_eff(f"did:e{i}", "s1", 0.5, 0.95) for i in range(5)])
    a.rec("exposure", [eng.get_total_exposure(f"did:v{i}", "s1") for i in range(3)])
    table = eng.to_device(capacity=16, device="cpu") if a.pkg is PORT else eng.to_device(16)
    a.rec("table", {f: np.asarray(getattr(table, f)) for f in
                    ("voucher", "vouchee", "session", "bond_pct", "bond", "active", "expiry")})
    slasher = m.SlashingEngine(eng)
    scores = {f"did:v{i}": 0.9 for i in range(3)}
    a.rec("slash", slasher.slash(vouchee_did="did:e1", session_id="s1", vouchee_sigma=0.7,
                                 risk_weight=0.95, reason="drift", agent_scores=scores))
    a.rec("after", (scores, eng.vouch_count, eng.all_records(), slasher.history))
    eng.release_session_bonds("s1")
    ledger = m.LiabilityLedger()
    kinds = list(m.LedgerEntryType)
    for i in range(16):
        ledger.record(f"did:a{i % 4}", kinds[i % len(kinds)], session_id="s1",
                      severity=float(a.rng.uniform(0, 1)))
    a.rec("ledger", [(ledger.compute_risk_profile(f"did:a{i}"), ledger.should_admit(f"did:a{i}"))
                     for i in range(4)])
    q = m.QuarantineManager()
    rec = q.quarantine("did:q", "s1", m.QuarantineReason.BEHAVIORAL_DRIFT, details="d",
                       duration_seconds=16)
    a.clock.advance(32.0)
    a.rec("quarantine", (rec, q.tick(), q.is_quarantined("did:q", "s1"), q.get_history("did:q")))
    attr = m.CausalAttributor()
    a.rec("attribution", attr.attribute(
        saga_id="g", session_id="s1",
        agent_actions={"did:a": [{"action_id": "x", "step_id": "s2", "success": False,
                                  "dependencies": ["s1"]}],
                       "did:b": [{"action_id": "y", "step_id": "s1", "success": True}]},
        failure_step_id="s2", failure_agent_did="did:a"))
    mat = m.LiabilityMatrix("s1")
    for i, (x, y) in enumerate((("a", "b"), ("b", "c"), ("c", "d"), ("d", "b"))):
        mat.add_edge(f"did:{x}", f"did:{y}", 0.1 * (i + 1), f"v{i}")
    a.rec("matrix", (mat.who_vouches_for("did:b"), mat.total_exposure("did:b"),
                     mat.cascade_path("did:a"), mat.has_cycle(), mat.edges))
    clique = m.VouchingEngine()
    for x, y in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)):
        clique.vouch(f"did:c{x}", f"did:c{y}", "s2", voucher_sigma=0.55)
    a.rec("collusion", a.mod("liability.collusion").CollusionDetector().scan(clique))


async def saga_case(a):
    m = a.pkg
    orch = m.SagaOrchestrator()
    orch.DEFAULT_RETRY_DELAY_SECONDS = 0.0
    saga = orch.create_saga("s1")
    steps = [orch.add_step(saga.saga_id, f"a{i}", "did:a", f"/x{i}", undo_api=f"/u{i}",
                           max_retries=1) for i in range(3)]
    tries = {"n": 0}

    async def ok():
        return "ok"

    async def flaky():
        tries["n"] += 1
        if tries["n"] < 2:
            raise RuntimeError("once")
        return "second"

    async def boom():
        raise RuntimeError("boom")

    a.rec("run", [await orch.execute_step(saga.saga_id, steps[0].step_id, ok),
                  await orch.execute_step(saga.saga_id, steps[1].step_id, flaky)])
    try:
        await orch.execute_step(saga.saga_id, steps[2].step_id, boom)
    except RuntimeError as exc:
        a.rec("failed", exc)

    async def undo(step):
        return f"undo {step.action_id}"

    a.rec("compensated", (await orch.compensate(saga.saga_id, undo), saga.to_dict()))
    restored = m.Saga.from_dict(saga.to_dict())
    a.rec("restored", restored.to_dict())
    fan = m.FanOutOrchestrator()
    for policy in m.FanOutPolicy:
        group = fan.create_group("g", policy)
        for i in range(3):
            fan.add_branch(group.group_id, m.SagaStep(step_id=f"b{i}", action_id=f"b{i}",
                                                      agent_did="did:a", execute_api="/x"))
        execs = {f"b{i}": (ok if i != 1 else boom) for i in range(3)}
        a.rec(f"fanout {policy.value}", (await fan.execute(group.group_id, execs), group))
    fo = a.mod("saga.fan_out")
    a.rec("mask", fo.resolve_policy_mask(np.array([0, 1, 2, 1], np.int8),
                                         a.rng.rand(4, 5) > 0.5, a.rng.rand(4, 5) > 0.2))
    ck = m.CheckpointManager()
    ck.save("g", "s1", "goal one", state_snapshot={"k": 1})
    ck.save("g", "s2", "goal two")
    a.rec("checkpoints", (ck.is_achieved("g", "goal one", "s1"), ck.invalidate("g", "s1", "redo"),
                          ck.get_replay_plan("g", ["s1", "s2", "s3"]), ck.get_saga_checkpoints("g"),
                          ck.total_checkpoints, ck.valid_checkpoints))
    parser = m.SagaDSLParser()
    definition = parser.parse({"name": "deploy", "session_id": "s1", "steps": [
        {"id": "a", "action_id": "a", "agent": "did:a", "execute_api": "/a", "undo_api": "/ua"},
        {"id": "b", "action_id": "b", "agent": "did:b", "execute_api": "/b"}]})
    a.rec("dsl", (definition, parser.to_saga_steps(definition),
                  parser.validate({"name": "x", "steps": []})))


def vfs_case(a):
    m = a.pkg
    vfs = m.SessionVFS("s1")
    edits = [vfs.write(f"/f{i % 4}.md", f"content {i}", f"did:a{i % 2}") for i in range(10)]
    a.rec("edits", (edits, vfs.list_files(), vfs.file_count, vfs.file_hash("/f1.md")))
    snap = vfs.create_snapshot()
    vfs.set_permissions("/f0.md", {"did:a0"}, "did:a0")
    a.rec("denied", call(vfs.write, "/f0.md", "x", "did:a1"))
    a.rec("delete", (vfs.delete("/f2.md", "did:a0"), call(vfs.delete, "/nope", "did:a0")))
    vfs.restore_snapshot(snap, "did:a0")
    a.rec("restored", (vfs.list_files(), vfs.read("/f2.md"), vfs.get_permissions("/f0.md"),
                       vfs.edits_by_agent("did:a1"), vfs.list_snapshots(), vfs.snapshot_count))
    vfs.clear_permissions("/f0.md")
    vfs.delete_snapshot(snap)
    a.rec("log", (vfs.edit_log, vfs.snapshot_count, a.mod("session.vfs").content_hash("abc")))


def session_security_case(a):
    m = a.pkg
    sso = m.SharedSessionObject(config=m.SessionConfig(max_participants=3), creator_did="did:lead")
    a.rec("early", call(sso.activate))
    sso.begin_handshake()
    a.rec("joins", [call(sso.join, f"did:a{i}", sigma_raw=0.5 + 0.1 * i,
                            sigma_eff=0.5 + 0.1 * i, ring=m.ExecutionRing(3 - i % 2))
                    for i in range(5)])
    sso.activate()
    sso.update_ring("did:a0", m.ExecutionRing.RING_3_SANDBOX)
    sso.leave("did:a1")
    sso.force_consistency_mode(m.ConsistencyMode.STRONG)
    sso.vfs.write("/x", "1", "did:a0")
    snap = sso.create_vfs_snapshot()
    sso.vfs.write("/x", "2", "did:a0")
    sso.restore_vfs_snapshot(snap, "did:a0")
    a.rec("sso", (sso.participants, sso.participant_count, sso.state, sso.consistency_mode,
                  sso.vfs.read("/x"), call(sso.get_participant, "did:ghost")))
    sso.terminate()
    sso.archive()
    a.rec("archived", (sso.state, call(sso.join, "did:late", sigma_raw=0.9)))
    clocks = m.VectorClockManager()
    steps = [clocks.write("/p", "did:a"), clocks.read("/p", "did:b"),
             clocks.write("/p", "did:b"), call(clocks.write, "/p", "did:a"),
             clocks.write("/q", "did:a", strict=False)]
    a.rec("clocks", [getattr(c, "clocks", c) for c in steps])
    a.rec("matrix", (clocks.path_matrix(), clocks.conflict_count, clocks.tracked_paths))
    v1, v2 = m.VectorClock(), m.VectorClock()
    v1.tick("a")
    v2.tick("b")
    a.rec("vc", (v1.happens_before(v2), v1.is_concurrent(v2), v1.merge(v2).clocks))
    locks = m.IntentLockManager()
    l1 = locks.acquire("did:a", "s1", "/r", m.LockIntent.WRITE)
    a.rec("locks", (l1, call(locks.acquire, "did:b", "s1", "/r", m.LockIntent.WRITE),
                    locks.acquire("did:b", "s1", "/r2", m.LockIntent.READ)))
    locks.declare_wait("did:a", {"did:b"})
    a.rec("deadlock", call(locks.declare_wait, "did:b", {"did:a"}))
    a.rec("release", (locks.release_agent_locks("did:a", "s1"), locks.contention_points,
                      locks.release_session_locks("s1"), locks.active_lock_count))
    a.rec("isolation", [(lv.code, lv.requires_vector_clocks, lv.requires_intent_locks,
                         lv.allows_concurrent_writes, lv.coordination_cost)
                        for lv in m.IsolationLevel])


class _Scorer:
    def calculate_trust_score(self, verification_level="standard", history=None,
                              capabilities=None):
        total = 400 + 50 * len(history or [])
        return types.SimpleNamespace(total_score=total, successful_tasks=len(history or []),
                                     failed_tasks=0)

    def slash_reputation(self, agent_did, reason, severity, **_):
        return None

    def record_task_outcome(self, agent_did, outcome):
        return None


def verification_and_adapters_case(a):
    m = a.pkg
    v = m.TransactionHistoryVerifier()
    a.rec("unknown", v.verify("did:new"))
    records = [m.TransactionRecord(session_id=f"s{i}", summary_hash=f"{i + 1:032x}",
                                   timestamp=_dt.datetime.fromtimestamp(1_767_225_600 + i,
                                                                        _dt.timezone.utc),
                                   participant_count=2)
               for i in range(6)]
    a.rec("history", (v.verify("did:old", declared_history=records), v.verify("did:old")))
    bad = records[:3] + [records[1]]
    v.clear_cache()
    a.rec("bad", v.verify("did:dup", declared_history=bad))
    cm = a.mod("integrations.cmvk_adapter")
    cmvk = cm.CMVKAdapter(verifier=Drift())
    a.rec("drift", [cmvk.check_behavioral_drift("did:a", "s1", 0.0, d)
                    for d in (0.1, 0.2, 0.4, 0.6, 0.8)])
    a.rec("drift_rate", (cmvk.get_drift_rate("did:a"), cmvk.get_agent_drift_history("did:a", "s1")))
    iatp = a.mod("integrations.iatp_adapter").IATPAdapter()
    a.rec("manifest", iatp.analyze_manifest_dict({
        "agent_id": "did:m", "trust_level": "trusted", "trust_score": 8, "scopes": ["r"],
        "actions": [{"action_id": "w", "name": "w", "execute_api": "/w",
                     "reversibility": "partial"},
                    {"action_id": "d", "name": "d", "execute_api": "/d", "is_admin": True}]}))
    nexus = a.mod("integrations.nexus_adapter").NexusAdapter(scorer=_Scorer())
    a.rec("nexus", (nexus.resolve_sigma("did:n", history=[1, 2, 3]),
                    nexus.resolve_sigma("did:n"), nexus.get_cached_result("did:n")))
    a.clock.advance(512.0)
    a.rec("nexus_stale", (nexus.resolve_sigma("did:n"), nexus.resolve_sigma_batch(["did:x"])))
    rl = m.AgentRateLimiter()
    a.rec("rate", ([rl.try_check("did:r", "s1", m.ExecutionRing.RING_3_SANDBOX)
                    for _ in range(12)],
                   rl.check_many(["did:r", "did:r", "did:w"], ["s1"] * 3,
                                 [m.ExecutionRing.RING_3_SANDBOX] * 3),
                   rl.get_stats("did:r", "s1"),
                   call(rl.check, "did:r", "s1", m.ExecutionRing.RING_3_SANDBOX)))
    ks = m.KillSwitch()
    ks.register_substitute("s1", "did:sub")
    a.rec("kill", (ks.kill("did:v", "s1", m.KillReason.MANUAL, in_flight_steps=[{"step_id": "x", "saga_id": "g"}]),
                   ks.total_kills, ks.total_handoffs))
    gw = a.mod("security.action_gateway")
    a.rec("gateway", gw.ActionCheckResult(allowed=True, reason="allowed",
                                          effective_ring=m.ExecutionRing.RING_2_STANDARD,
                                          required_ring=m.ExecutionRing.RING_3_SANDBOX))


def observability_case(a):
    m = a.pkg
    bus = m.HypervisorEventBus()
    seen = []
    bus.subscribe(m.EventType.SESSION_JOINED, lambda e: seen.append(e.event_id))
    bus.subscribe(None, lambda e: seen.append(e.event_type.value))
    types_ = list(m.EventType)
    root = m.CausalTraceId()
    child = root.child()
    for i in range(24):
        bus.emit(m.HypervisorEvent(
            event_type=types_[i % 7], session_id=f"s{i % 3}" if i % 5 else None,
            agent_did=f"did:a{i % 4}",
            causal_trace_id=(str(child) if i % 2 else f"opaque-{i}") if i % 3 else None,
            payload={"i": i}))
        a.clock.advance(1.0)
    a.rec("queries", (bus.query_by_type(types_[1]), bus.query_by_session("s1"),
                      bus.query_by_agent("did:a2"), bus.query(event_type=types_[2],
                                                              session_id="s2", limit=2),
                      bus.type_counts(), bus.event_count, seen))
    a.rec("trace", (root.full_id, child.full_id, child.depth, root.is_ancestor_of(child),
                    child.sibling().parent_span_id, root.device_key(),
                    a.mod("observability.causal_trace").device_key_of(str(child)),
                    m.CausalTraceId.from_string(str(child)).full_id))
    rows = bus.device_rows(4)
    a.rec("rows", rows)
    log = a.mod("tables.logs").EventLog
    if a.pkg is PORT:
        table = log.create(16, "cpu")
        table.append_batch(*rows)
        out = {f: np.array(getattr(table, f)) for f in ("event_type", "session", "agent",
                                                        "trace", "span", "timestamp", "cursor")}
        out["trace"] = out["trace"].view(np.uint32)
        out["span"] = out["span"].view(np.uint32)
    else:
        import jax.numpy as jnp

        table = log.create(16).append_batch(*(jnp.asarray(r) for r in rows))
        out = {f: np.array(getattr(table, f)) for f in ("event_type", "session", "agent",
                                                        "trace", "span", "timestamp", "cursor")}
    a.rec("event_log", out)
    bus.clear()
    a.rec("cleared", (bus.event_count, bus.all_events))


def audit_case(a):
    m = a.pkg
    engines = [m.DeltaEngine(f"s{k}") if a.pkg is REF
               else m.DeltaEngine(f"s{k}", tensor_device="cpu") for k in range(3)]
    for k, eng in enumerate(engines):
        for t in range((5, 9, 70)[k]):
            eng.capture(f"did:a{t % 3}", [m.VFSChange(path=f"/p{t}", operation="modify",
                                                      content_hash=f"{t:064x}",
                                                      previous_hash=f"{t + 1:064x}")])
            a.clock.advance(0.5)
    delta = a.mod("audit.delta")
    a.rec("roots", [(e.compute_merkle_root(), e.compute_merkle_root(device=False),
                     e.compute_merkle_root(device=True), e.verify_chain(), e.turn_count,
                     e.deltas[-1]) for e in engines])
    hashes = [d.delta_hash for d in engines[2].deltas]
    a.rec("builders", (delta.merkle_root_host(hashes[:33]), delta.merkle_root_native(hashes[:33])))
    commit = m.CommitmentEngine()
    root = engines[0].compute_merkle_root()
    a.rec("commit", (commit.commit("s0", root, ["did:a0"], 5), commit.verify("s0", root),
                     commit.verify("s0", "0" * 64)))
    cm = a.mod("audit.commitment")
    words = np.array([int(root[i * 8:(i + 1) * 8], 16) for i in range(8)], np.uint32)
    a.rec("device_root", (cm.words_to_hex(words),
                          commit.commit_device_root("s1", words, ["did:a"], 3)))
    gc = m.EphemeralGC()
    vfs = m.SessionVFS("s0")
    vfs.write("/x", "data", "did:a0")
    a.rec("gc", (gc.collect(session_id="s0", vfs=vfs, delta_engine=engines[0], delta_count=5),
                 gc.is_purged("s0"), gc.purged_session_count))
    a.clock.advance(91 * 86400.0)
    a.rec("prune", (engines[1].prune_expired(90), engines[1].deltas))


CASES = {f.__name__: f for f in (
    models_case, rings_case, liability_case, saga_case, vfs_case, session_security_case,
    verification_and_adapters_case, observability_case, audit_case)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_engine_sequence_matches_reference(name, monkeypatch):
    monkeypatch.setenv("HV_SHA256_PALLAS", "0")
    ref_log, port_log = run_both(CASES[name])
    assert len(ref_log) > 1
    assert_logs_equal(ref_log, port_log)
