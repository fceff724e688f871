"""The port's adversarial plane and scenario harness against the reference.

`hypervisor_tpu_torch.testing.scenarios` runs the six adversary classes
(`adversarial.ADVERSARIES`) against fresh port deployments on
`device="cpu"` here. Each scenario at seed 11, hardened and bare (and
`slash_cascade` at seed 12), runs on both packages under the same
deterministic ids and clocks (`test_torch_serving.both`), and the whole
`ScenarioResult.to_dict()` (score, components, attack events, trace
digest and details) must be equal, tolerance 0. `byzantine_fuzz` records
HTTP statuses, which depend on whether pydantic is importable (the
stand-in models refuse stray fields, pydantic ignores them), so it runs
once more on both packages with pydantic hidden, each in a fresh process.

Then the counterparts of the reference's `tests/unit/test_adversarial.py`
on the port alone: seed determinism, containment, the hardening deltas,
and the mechanism tests (admission damper, collusion detector, cascade
dedupe, compensation backpressure, the transport's refusals, the
scenario plumbing, the satellite nits), all on the CPU. One module-level
cache holds every scenario run, as the reference's `_CACHE` does.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import logging
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hypervisor_tpu_torch.testing import scenarios
from tests.test_torch_serving import both

SEED = 11
ROOT = Path(__file__).resolve().parents[1]

#: (package name, scenario, seed, hardened) -> ScenarioResult.to_dict()
_CACHE: dict = {}


def pair(name: str, seed: int = SEED, hardened: bool = True) -> tuple[dict, dict]:
    """(reference, port) results of one scenario, run under `both`."""
    if ("ref", name, seed, hardened) not in _CACHE:
        def drive(P):
            kw = {} if P.is_ref else {"device": "cpu"}
            return P.mod("testing.scenarios").run_scenario(
                name, seed, hardened=hardened, **kw).to_dict()

        ref, port = both(drive)
        _CACHE["ref", name, seed, hardened] = ref
        _CACHE["port", name, seed, hardened] = port
    return _CACHE["ref", name, seed, hardened], _CACHE["port", name, seed, hardened]


def run(name: str, seed: int = SEED, hardened: bool = True) -> dict:
    """The port's result (from the parity run when there is one)."""
    return pair(name, seed, hardened)[1]


# ── parity with the reference ────────────────────────────────────────


@pytest.mark.parametrize("hardened", [True, False], ids=["hardened", "bare"])
@pytest.mark.parametrize("name", scenarios.SCENARIO_NAMES)
def test_scenario_matches_reference(name, hardened):
    ref, port = pair(name, SEED, hardened)
    assert port == ref
    assert port["name"] == name and port["seed"] == SEED and port["hardened"] is hardened


def test_slash_cascade_at_another_seed_matches_reference():
    ref, port = pair("slash_cascade", SEED + 1)
    assert port == ref
    assert port["trace_digest"] != run("slash_cascade")["trace_digest"]


_ISOLATED = """
import json, sys
sys.modules["pydantic"] = None
import importlib
pkg = sys.argv[1]
models = importlib.import_module(pkg + ".api.models")
assert models._HAVE_PYDANTIC is False
scenarios = importlib.import_module(pkg + ".testing.scenarios")
kw = {} if pkg == "hypervisor_tpu" else {"device": "cpu"}
print(json.dumps(scenarios.run_scenario("byzantine_fuzz", 11, **kw).to_dict()))
"""


def _isolated_byzantine(pkg: str) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _ISOLATED, pkg], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_byzantine_fuzz_without_pydantic_matches_reference():
    """The card has no pydantic: the stand-in models give the same
    statuses in both packages, so the same digest."""
    ref, port = _isolated_byzantine("hypervisor_tpu"), _isolated_byzantine("hypervisor_tpu_torch")
    assert port == ref
    assert port["score"] >= scenarios.DEFAULT_CONTAINMENT_FLOOR
    assert port["components"]["no_server_errors"] == 1.0


# ── seed determinism: same seed -> same trace -> same score ──────────


class TestSeedDeterminism:
    @pytest.mark.parametrize("name", scenarios.SCENARIO_NAMES)
    def test_replay_twin_is_bit_identical(self, name):
        first = run(name)
        twin = scenarios.run_scenario(name, SEED, hardened=True, device="cpu")
        assert first["trace_digest"] == twin.trace_digest
        assert first["score"] == twin.score
        assert first["components"] == twin.components
        assert first["attack_events"] == twin.attack_events

    def test_hardened_flag_is_part_of_the_identity(self):
        assert (run("sybil_flood")["trace_digest"]
                != run("sybil_flood", hardened=False)["trace_digest"])

    def test_unknown_scenario_refuses(self):
        with pytest.raises(ValueError, match="unknown scenario"):
            scenarios.run_scenario("nope", SEED, device="cpu")

    def test_the_card_is_the_default_and_never_falls_back(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device runs")
        for name in ("sybil_flood", "collusion_ring", "compensation_storm",
                     "byzantine_fuzz", "noisy_neighbor"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                scenarios.run_scenario(name, SEED)


# ── containment: the hardened suite holds the floor ──────────────────


class TestContainment:
    @pytest.mark.parametrize("name", scenarios.SCENARIO_NAMES)
    def test_hardened_scenario_contains(self, name):
        result = run(name)
        assert result["score"] >= scenarios.DEFAULT_CONTAINMENT_FLOOR, result["components"]

    @pytest.mark.parametrize("name,key", [
        ("sybil_flood", "invariants_clean"),
        ("collusion_ring", "escrow_conservation"),
        ("compensation_storm", "invariants_clean"),
        ("byzantine_fuzz", "invariants_clean"),
    ])
    def test_invariants_survive_every_adversary(self, name, key):
        assert run(name)["components"][key] == 1.0

    @pytest.mark.parametrize("name", scenarios.SCENARIO_NAMES)
    def test_honest_traffic_survives(self, name):
        comps = run(name)["components"]
        honest_keys = [k for k in comps if k.startswith("honest")]
        assert honest_keys, comps
        assert all(comps[k] == 1.0 for k in honest_keys), comps


class TestHardeningDeltas:
    @pytest.mark.parametrize("name", ["sybil_flood", "collusion_ring", "slash_cascade",
                                      "compensation_storm", "noisy_neighbor"])
    def test_unhardened_twin_scores_strictly_lower(self, name):
        hard, bare = run(name), run(name, hardened=False)
        assert bare["score"] < hard["score"], (name, bare["components"], hard["components"])

    def test_sybil_damper_protects_capacity(self):
        hard = run("sybil_flood")["components"]
        bare = run("sybil_flood", hardened=False)["components"]
        assert bare["flood_work_damped"] == 0.0
        assert hard["flood_work_damped"] > 0.5
        assert bare["capacity_preserved"] < hard["capacity_preserved"]
        assert bare["honest_admission"] < 1.0
        assert hard["honest_admission"] == 1.0

    def test_collusion_detector_neutralizes_before_defection(self):
        hard, bare = run("collusion_ring"), run("collusion_ring", hardened=False)
        assert hard["components"]["pump_neutralized"] == 1.0
        assert bare["components"]["pump_neutralized"] == 0.0
        assert hard["components"]["detector_precision"] == 1.0
        assert hard["details"]["honest_flagged"] == []

    def test_cascade_dedupe_and_canonical_order(self):
        hard, bare = run("slash_cascade"), run("slash_cascade", hardened=False)
        assert hard["components"]["single_settlement"] == 1.0
        assert bare["components"]["single_settlement"] < 1.0
        assert hard["components"]["deterministic_settlement"] == 1.0
        assert bare["components"]["deterministic_settlement"] == 0.0
        assert hard["details"]["dedupes"] >= 1
        assert bare["details"]["dedupes"] == 0

    def test_backpressure_drains_the_storm(self):
        hard, bare = run("compensation_storm"), run("compensation_storm", hardened=False)
        assert hard["components"]["storm_drained"] == 1.0
        assert bare["components"]["storm_drained"] < 1.0
        assert hard["components"]["backpressure_engaged"] == 1.0
        assert hard["components"]["degraded_exited"] == 1.0
        assert hard["details"]["arrivals_deferred"] > 0
        assert bare["details"]["arrivals_deferred"] == 0

    def test_noisy_neighbor_corruption_stays_in_its_own_slice(self):
        hard = run("noisy_neighbor")
        assert hard["components"]["honest_neighbor_chains"] == 1.0
        assert hard["components"]["honest_neighbor_members"] == 1.0
        assert hard["details"]["shed"][0] > 0  # the flood shed against its own quota


# ── hardening mechanisms, unit level (the port on the CPU) ───────────


def _state():
    from hypervisor_tpu_torch.state import HypervisorState

    return HypervisorState(device="cpu")


class TestAdmissionDamper:
    def test_targeted_shed_lets_honest_joins_flow(self):
        from hypervisor_tpu_torch.models import SessionConfig
        from hypervisor_tpu_torch.resilience.policy import AdmissionDamper, SybilShedRefusal

        st = _state()
        st.admission_damper = AdmissionDamper(rate_threshold=5.0, low_sigma_fraction=0.5,
                                              sigma_floor=0.5, window_seconds=1.0)
        slot = st.create_session("damp:a", SessionConfig(min_sigma_eff=0.0), now=0.0)
        shed = 0
        for i in range(6):
            try:
                st.enqueue_join(slot, f"did:low:{i}", 0.1, now=i * 0.01)
            except SybilShedRefusal:
                shed += 1
        assert shed == 1
        assert st.admission_damper.active
        assert st.degraded_policy is not None
        assert st.degraded_policy.admission_sigma_floor == 0.5
        with pytest.raises(SybilShedRefusal):
            st.enqueue_join(slot, "did:low:x", 0.2, now=0.07)
        assert st.enqueue_join(slot, "did:ok", 0.9, now=0.08) >= 0
        assert st.admission_damper.damped == 2

    def test_damper_exits_when_the_flood_recedes(self):
        from hypervisor_tpu_torch.resilience.policy import AdmissionDamper

        st = _state()
        damper = AdmissionDamper(rate_threshold=5.0, window_seconds=1.0, sigma_floor=0.5)
        st.admission_damper = damper
        for i in range(6):
            damper.note_join(st, 0.1, i * 0.01)
        assert damper.active
        damper.note_join(st, 0.1, 100.0)
        assert not damper.active
        assert st.degraded_policy is None

    def test_supervisor_escalation_replaces_targeted_policy(self):
        from hypervisor_tpu_torch.resilience.policy import AdmissionDamper
        from hypervisor_tpu_torch.resilience.supervisor import Supervisor

        st = _state()
        damper = AdmissionDamper(rate_threshold=2.0, window_seconds=1.0, sigma_floor=0.5)
        st.admission_damper = damper
        sup = Supervisor(st, degrade_after_comp_backlog=2, sleep=lambda s: None)
        for i in range(4):
            damper.note_join(st, 0.1, i * 0.01)
        assert damper.active
        assert not st.degraded_policy.shed_admissions
        st.health.emit_event("comp_backlog", {"backlog": 5})
        assert st.degraded_policy.shed_admissions
        assert st.degraded_policy.pause_saga_fanout
        damper.note_join(st, 0.1, 0.05)
        assert not damper.active
        _ = sup

    def test_restore_carries_the_damper_across(self, tmp_path):
        from hypervisor_tpu_torch.resilience.policy import AdmissionDamper
        from hypervisor_tpu_torch.resilience.supervisor import Supervisor
        from hypervisor_tpu_torch.resilience.wal import WriteAheadLog

        st = _state()
        st.journal = WriteAheadLog(tmp_path / "wal.log", fsync=False)
        damper = AdmissionDamper(rate_threshold=1e9)
        st.admission_damper = damper
        sup = Supervisor(st, checkpoint_dir=str(tmp_path / "ckpt"), sleep=lambda s: None)
        sup.checkpoint()
        recovered = sup.restore_state("drill")
        assert recovered is not st
        assert recovered.admission_damper is damper
        assert recovered.device.type == "cpu"

    def test_supervisor_clean_exit_leaves_targeted_policy_alone(self):
        from hypervisor_tpu_torch.resilience.policy import AdmissionDamper
        from hypervisor_tpu_torch.resilience.supervisor import Supervisor

        st = _state()
        damper = AdmissionDamper(rate_threshold=2.0, window_seconds=1.0, sigma_floor=0.5)
        st.admission_damper = damper
        sup = Supervisor(st, exit_after_clean=1, sleep=lambda s: None)
        for i in range(4):
            damper.note_join(st, 0.1, i * 0.01)
        assert damper.active
        sup.dispatch("wave", lambda: None)
        assert st.degraded_policy is not None
        assert damper.active
        assert sup.degraded_exits == 0

    def test_damper_never_clobbers_supervisor_policy(self):
        from hypervisor_tpu_torch.resilience.policy import AdmissionDamper, DegradedPolicy

        st = _state()
        damper = AdmissionDamper(rate_threshold=1.0, window_seconds=1.0)
        st.admission_damper = damper
        supervisor_policy = DegradedPolicy(reason="operator shed")
        st.degraded_policy = supervisor_policy
        for i in range(8):
            damper.note_join(st, 0.1, i * 0.01)
        assert st.degraded_policy is supervisor_policy
        assert not damper.active


class TestCollusionDetector:
    def _engine_with_clique(self):
        from hypervisor_tpu_torch.liability.vouching import VouchingEngine

        eng = VouchingEngine()
        s = "s:collusion"
        for leaf in ("did:h1", "did:h2", "did:h3"):
            eng.vouch("did:hub", leaf, s, voucher_sigma=0.9)
        clique = [f"did:c{i}" for i in range(4)]
        for a, b in [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]:
            eng.vouch(clique[a], clique[b], s, voucher_sigma=0.55)
        return eng, s, clique

    def test_flags_clique_not_hub(self):
        from hypervisor_tpu_torch.liability.collusion import CollusionDetector

        eng, s, clique = self._engine_with_clique()
        findings = CollusionDetector().scan(eng, s)
        assert len(findings) == 1
        assert list(findings[0].members) == sorted(clique)
        assert findings[0].dual_role_fraction >= 0.5
        assert "did:hub" not in findings[0].members

    def test_scan_is_deterministic(self):
        from hypervisor_tpu_torch.liability.collusion import CollusionDetector

        eng, s, _ = self._engine_with_clique()
        a = [f.to_dict() for f in CollusionDetector().scan(eng, s)]
        b = [f.to_dict() for f in CollusionDetector().scan(eng)]
        assert a == b

    def test_sweep_rescan_charges_each_finding_once(self):
        from hypervisor_tpu_torch.core import Hypervisor
        from hypervisor_tpu_torch.models import SessionConfig

        async def drive():
            hv = Hypervisor(device="cpu")
            managed = await hv.create_session(SessionConfig(min_sigma_eff=0.5), "did:op")
            sid = managed.sso.session_id
            clique = [f"did:c{i}" for i in range(4)]
            for did in clique:
                await hv.join_session(sid, did, sigma_raw=0.55)
            for a, b in [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]:
                hv.vouching.vouch(clique[a], clique[b], sid, voucher_sigma=0.55)
            first = hv.detect_collusion(sid)
            charges = len(hv.ledger.get_agent_history(clique[0]))
            again = hv.detect_collusion(sid)
            assert len(first) == len(again) == 1
            assert len(hv.ledger.get_agent_history(clique[0])) == charges

        asyncio.run(drive())

    def test_released_bonds_leave_the_graph(self):
        from hypervisor_tpu_torch.liability.collusion import CollusionDetector

        eng, s, _ = self._engine_with_clique()
        for rec in eng.all_records():
            if rec.voucher_did.startswith("did:c"):
                eng.release_bond(rec.vouch_id)
        assert CollusionDetector().scan(eng, s) == []


class TestCascadeHardening:
    def _diamond(self, dedupe: bool):
        from hypervisor_tpu_torch.liability.slashing import SlashingEngine
        from hypervisor_tpu_torch.liability.vouching import VouchingEngine

        eng = VouchingEngine()
        s = "s:diamond"
        eng.vouch("did:m1", "did:root", s, voucher_sigma=0.8)
        eng.vouch("did:m2", "did:root", s, voucher_sigma=0.8)
        eng.vouch("did:w", "did:m1", s, voucher_sigma=0.8)
        eng.vouch("did:w", "did:m2", s, voucher_sigma=0.8)
        slashing = SlashingEngine(eng, dedupe_cascade=dedupe)
        scores = {d: 0.8 for d in ("did:root", "did:m1", "did:m2", "did:w")}
        slashing.slash("did:root", s, 0.8, 0.99, "diamond", scores)
        return slashing, scores

    def test_legacy_diamond_double_clips_the_shared_voucher(self):
        slashing, _ = self._diamond(dedupe=False)
        clipped = [c.voucher_did for e in slashing.history for c in e.voucher_clips]
        assert clipped.count("did:w") == 2
        assert slashing.cascade_dedupes == 0

    def test_deduped_diamond_settles_each_agent_once(self):
        slashing, _ = self._diamond(dedupe=True)
        clipped = [c.voucher_did for e in slashing.history for c in e.voucher_clips]
        assert clipped.count("did:w") == 1
        assert slashing.cascade_dedupes == 1
        assert all(not r.is_active for r in slashing._vouching.all_records())

    def test_max_depth_override_stops_the_cascade(self):
        from hypervisor_tpu_torch.liability.slashing import SlashingEngine
        from hypervisor_tpu_torch.liability.vouching import VouchingEngine

        eng = VouchingEngine()
        s = "s:chain"
        for i in range(4):
            eng.vouch(f"did:c{i + 1}", f"did:c{i}", s, voucher_sigma=0.8)
        slashing = SlashingEngine(eng)
        scores = {f"did:c{i}": 0.8 for i in range(5)}
        slashing.slash("did:c0", s, 0.8, 0.99, "bounded", scores, max_depth=0)
        assert len(slashing.history) == 1
        assert scores["did:c2"] == 0.8


class TestCompensationBackpressure:
    def test_saga_work_budget_is_deterministic_prefix(self):
        from hypervisor_tpu_torch.models import SessionConfig

        st = _state()
        sess = st.create_session("bp:s", SessionConfig(min_sigma_eff=0.0), now=0.0)
        steps = [{"has_undo": True, "retries": 0}] * 2
        slots = [st.create_saga(f"bp:{i}", sess, steps) for i in range(6)]
        st.saga_round(exec_outcomes={s: True for s in slots})
        st.saga_round(exec_outcomes={s: False for s in slots})
        _, full = st.saga_work()
        _, capped = st.saga_work(comp_budget=2)
        assert len(full) == 6
        assert capped == full[:2]
        assert [s for s, _ in full] == sorted(s for s, _ in full)

    def test_backlog_event_flips_supervisor_degraded(self, monkeypatch):
        from hypervisor_tpu_torch.models import SessionConfig
        from hypervisor_tpu_torch.resilience.supervisor import Supervisor

        monkeypatch.setenv("HV_COMP_BACKLOG_WARN", "3")
        st = _state()
        sup = Supervisor(st, degrade_after_comp_backlog=4, sleep=lambda s: None)
        sess = st.create_session("bp:t", SessionConfig(min_sigma_eff=0.0), now=0.0)
        steps = [{"has_undo": True, "retries": 0}] * 2
        slots = [st.create_saga(f"bpt:{i}", sess, steps) for i in range(5)]
        st.saga_round(exec_outcomes={s: True for s in slots})
        assert not sup.degraded
        st.saga_round(exec_outcomes={s: False for s in slots})
        st.saga_work()
        assert sup.degraded
        assert "compensation storm" in st.degraded_policy.reason
        assert sup.summary()["pressure"]["comp_backlog"] == 5


class TestByzantineTransportHardening:
    @pytest.fixture()
    def server(self):
        from hypervisor_tpu_torch.api.server import HypervisorHTTPServer
        from hypervisor_tpu_torch.api.service import HypervisorService
        from hypervisor_tpu_torch.core import Hypervisor

        server = HypervisorHTTPServer(HypervisorService(hypervisor=Hypervisor(device="cpu"))).start()
        yield server
        server.stop()

    def _req(self, server, method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
        try:
            conn.request(method, path, body=body, headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def test_malformed_json_is_a_400_not_a_dropped_connection(self, server):
        status, body = self._req(server, "POST", "/api/v1/sessions", b'{"creator_did": ')
        assert status == 400
        assert b"malformed JSON" in body

    def test_array_body_is_a_422(self, server):
        status, _ = self._req(server, "POST", "/api/v1/sessions", b"[1, 2, 3]")
        assert status == 422

    def test_bad_limit_query_param_is_a_400(self, server):
        status, _ = self._req(server, "GET", "/api/v1/events?limit=abc")
        assert status == 400

    def _raw_status(self, server, content_length: str) -> int:
        raw = ("POST /api/v1/sessions HTTP/1.1\r\n"
               "Host: t\r\nContent-Type: application/json\r\n"
               f"Content-Length: {content_length}\r\n"
               "Connection: close\r\n\r\n{}").encode()
        with socket.create_connection(("127.0.0.1", server.port), timeout=10) as sock:
            sock.sendall(raw)
            head = sock.recv(4096)
        return int(head.split(b" ")[1])

    def test_negative_content_length_is_a_400(self, server):
        assert self._raw_status(server, "-1") == 400

    def test_oversized_content_length_is_a_413(self, server):
        assert self._raw_status(server, str(64 << 20)) == 413

    def test_non_finite_sigma_refused_at_the_door(self):
        from hypervisor_tpu_torch.api import models as M
        from hypervisor_tpu_torch.api.service import ApiError, HypervisorService
        from hypervisor_tpu_torch.core import Hypervisor

        svc = HypervisorService(hypervisor=Hypervisor(device="cpu"))
        created = asyncio.run(svc.create_session(M.CreateSessionRequest(creator_did="did:op")))
        for bad in (float("nan"), float("inf"), -1.0, 2.0):
            with pytest.raises(ApiError) as err:
                asyncio.run(svc.join_session(
                    created.session_id, M.JoinSessionRequest(agent_did="did:a", sigma_raw=bad)))
            assert err.value.status == 400

    def test_non_finite_vouch_inputs_refused(self):
        from hypervisor_tpu_torch.liability.vouching import VouchingEngine, VouchingError

        eng = VouchingEngine()
        with pytest.raises(VouchingError, match="finite"):
            eng.vouch("did:a", "did:b", "s", voucher_sigma=float("nan"))
        with pytest.raises(VouchingError, match="finite"):
            eng.vouch("did:a", "did:b", "s", voucher_sigma=0.8, bond_pct=float("inf"))


# ── scenario plumbing: metrics + events ──────────────────────────────


class TestScenarioPlumbing:
    def test_metrics_and_events_mirror_a_run(self):
        from hypervisor_tpu_torch.observability import EventType, HypervisorEventBus
        from hypervisor_tpu_torch.observability import metrics as mp
        from hypervisor_tpu_torch.observability.metrics import REGISTRY, Metrics

        metrics = Metrics(REGISTRY, device="cpu")
        bus = HypervisorEventBus()
        result = scenarios.run_scenario("slash_cascade", 3, metrics=metrics, event_bus=bus,
                                        device="cpu")
        snap = metrics.snapshot()
        assert snap.counter(mp.SCENARIO_RUNS) == 1
        assert snap.counter(mp.SCENARIO_ATTACK_EVENTS) == result.attack_events
        assert snap.gauge(mp.SCENARIO_CONTAINMENT) == result.score
        kinds = [e.event_type for e in bus.query(limit=10)]
        assert EventType.SCENARIO_STARTED in kinds
        assert EventType.SCENARIO_SCORED in kinds

    def test_aggregate_reports_the_floor_statistic(self):
        results = {name: scenarios.ScenarioResult(**run(name))
                   for name in ("slash_cascade", "sybil_flood")}
        agg = scenarios.aggregate(results)
        assert agg["min_score"] == min(r.score for r in results.values())
        assert set(agg["trace_digests"]) == set(results)
        assert agg["attack_events"] == sum(r.attack_events for r in results.values())


# ── the satellite nits ───────────────────────────────────────────────


class TestSatelliteNits:
    def test_record_calls_non_monotonic_now_never_shrinks_the_window(self):
        from hypervisor_tpu_torch.config import DEFAULT_CONFIG
        from hypervisor_tpu_torch.ops import security_ops as so
        from hypervisor_tpu_torch.tables.state import BD_BUCKETS

        cfg = DEFAULT_CONFIG.breach
        k = BD_BUCKETS
        sub = cfg.window_seconds / k
        win = torch.zeros((1, 3 * k), dtype=torch.int32)
        now1 = 100 * sub + 0.5 * sub
        now0 = (100 - k) * sub + 0.5 * sub
        add = torch.tensor([3], dtype=torch.int32)
        win = so.window_commit(win, add, add, now1, cfg)
        win = so.window_commit(win, torch.tensor([2], dtype=torch.int32),
                               torch.tensor([0], dtype=torch.int32), now0, cfg)
        calls, priv = so.window_totals(win, now1, cfg)
        assert int(calls[0]) == 5
        assert int(priv[0]) == 3
        assert int(win[0, 2 * k + (100 % k)]) == 100

    def test_staged_since_harvest_floors_at_zero(self, caplog):
        from hypervisor_tpu_torch.runtime.native import HAVE_NATIVE, StagingQueue

        assert HAVE_NATIVE  # g++ builds the native unit here, as on the card
        q = StagingQueue(capacity=8)
        q.push(0.5, 0, 0)
        q.push(0.5, 1, 0)
        with q._count_lock:
            q._staged_since_harvest -= 1
        with caplog.at_level(logging.WARNING, logger="hypervisor_tpu_torch.runtime.native"):
            n, *_ = q.harvest()
        assert n == 2
        assert q._staged_since_harvest == 0
        assert any("flooring" in r.message for r in caplog.records)

    def test_legacy_migration_warns_when_breach_counters_drop(self, tmp_path, caplog):
        from hypervisor_tpu_torch.models import SessionConfig
        from hypervisor_tpu_torch.runtime.checkpoint import restore_state, save_state
        from hypervisor_tpu_torch.tables.state import AI32_BD_WIN_START

        st = _state()
        slot = st.create_session("ck:warn", SessionConfig())
        st.enqueue_join(slot, "did:w0", sigma_raw=0.8)
        assert (st.flush_joins() == 0).all()
        target = save_state(st, tmp_path, step=1)
        path = target / "tables.npz"
        data = dict(np.load(path))
        i32 = np.asarray(data["agents.i32"])
        legacy = np.zeros((i32.shape[0], 5), np.int32)
        legacy[:, :AI32_BD_WIN_START] = i32[:, :AI32_BD_WIN_START]
        legacy[0, 3] = 7
        legacy[0, 4] = 2
        data["agents.i32"] = legacy
        with open(path, "wb") as f:
            np.savez(f, **data)
        with caplog.at_level(logging.WARNING, logger="hypervisor_tpu_torch.runtime.checkpoint"):
            back = restore_state(target, device="cpu")
        assert any("breach-window counters" in r.message for r in caplog.records)
        assert int(back.agents.bd_window.sum()) == 0

    def test_ignore_collect_defers_with_none(self, monkeypatch, tmp_path):
        import conftest as c

        monkeypatch.setenv("HV_HOST_PLANE_ONLY", "1")
        curated = tmp_path / "unit" / "test_models.py"
        other = tmp_path / "unit" / "test_state_things.py"
        assert c.pytest_ignore_collect(curated, None) is None
        assert c.pytest_ignore_collect(other, None) is True
        monkeypatch.delenv("HV_HOST_PLANE_ONLY")
        assert c.pytest_ignore_collect(other, None) is None
