"""The port's fleet (registry, drain, trace, workers, the ten routes)
against the reference's, on the CPU.

`fleet/registry.py` and `fleet/trace.py` are copies of the reference's
modules (held as text by `test_torch_host_engines`), `fleet/drain.py` a
copy with two comment edits; here they run on the same inputs in both
packages: the lease chain's seeded schedules must give the reference's
transition logs and digests, the merged expositions and stitched traces
the reference's text and documents (the OTLP service name is each
package's own), and `FleetSnapshot.digest()` the reference's digest.

The ten fleet routes with no fleet attached answer as the reference's,
status for status and body for body, through the service and through the
stdlib transport; with an observatory attached but no failover or
rebalance plane, `/fleet/{ownership,failover,rebalance}` answer the
reference's 503s (with the planes attached: `tests/test_torch_failover.py`
and `tests/test_torch_rebalance.py`). The one-real-worker end-to-end test
runs a worker subprocess with `WorkerSpec(device="cpu")`, as does the
durable worker's adoption.
"""

from __future__ import annotations

import asyncio
import dataclasses
import http.client
import json
import random
import urllib.request

import pytest
import torch

import hypervisor_tpu.fleet as REF_FLEET
import hypervisor_tpu_torch.fleet as PORT_FLEET
from hypervisor_tpu.fleet.drain import stamp_worker_label as ref_stamp
from hypervisor_tpu_torch.fleet import (
    ALIVE,
    DEAD,
    SUSPECTED,
    FleetObservatory,
    FleetRegistry,
    FleetSnapshot,
    FleetSupervisor,
    LeaseConfig,
    WorkerSpec,
    merge_expositions,
    sample_series_count,
    stitch_chrome,
    stitch_otlp,
    worker_label_coverage,
)
from hypervisor_tpu_torch.fleet.drain import stamp_worker_label
from hypervisor_tpu_torch.observability.metrics import MetricHandle, escape_label_value
from tests.test_torch_serving import Pkg, both

_ORDER = {ALIVE: 0, SUSPECTED: 1, DEAD: 2}


# ── the ONE escaping rule ────────────────────────────────────────────


class TestLabelEscaping:
    def test_spec_characters(self):
        assert escape_label_value('a"b') == 'a\\"b'
        assert escape_label_value("a\\b") == "a\\\\b"
        assert escape_label_value("a\nb") == "a\\nb"
        assert escape_label_value(7) == "7"

    def test_handle_labels_escape(self):
        h = MetricHandle("hv_x_total", "counter", 0, labels=(("q", 'jo"in\n'),))
        assert h.label_str() == '{q="jo\\"in\\n"}'

    def test_worker_stamp_uses_the_same_rule_and_the_reference_text(self):
        hostile = 'w"0",evil="1'
        text = "# HELP hv_up up\nhv_up 1\nhv_x{tenant=\"3\"} 2\n\nnot a sample\n"
        stamped = stamp_worker_label(text, hostile, emit_headers=True)
        expected = escape_label_value(hostile)
        assert f'hv_up{{worker="{expected}"}} 1' in stamped
        assert f'hv_x{{worker="{expected}",tenant="3"}} 2' in stamped
        for headers in (True, False):
            assert (stamp_worker_label(text, hostile, emit_headers=headers)
                    == ref_stamp(text, hostile, emit_headers=headers))


# ── merge conservation ───────────────────────────────────────────────


class TestMerge:
    PER = {
        "w1": "# HELP hv_up up\n# TYPE hv_up gauge\nhv_up 1\nhv_n 3\n",
        "w0": "# HELP hv_up up\n# TYPE hv_up gauge\nhv_up 1\nhv_n{tenant=\"2\"} 2\n",
    }

    def test_series_conserved_headers_once_as_the_reference(self):
        merged = merge_expositions(self.PER)
        assert merged == REF_FLEET.merge_expositions(self.PER)
        assert sample_series_count(merged) == sum(sample_series_count(t) for t in self.PER.values())
        assert merged.count("# HELP hv_up") == 1
        assert worker_label_coverage(merged) == 1.0
        assert merged.index('worker="w0"') < merged.index('worker="w1"')
        assert worker_label_coverage("") == REF_FLEET.worker_label_coverage("") == 0.0

    def test_tenant_rows_keep_both_labels(self):
        text = 'hv_q_depth{tenant="5",queue="join"} 2\n'
        stamped = stamp_worker_label(text, "w3", emit_headers=False)
        assert 'worker="w3"' in stamped and 'tenant="5"' in stamped
        assert stamped == ref_stamp(text, "w3", emit_headers=False)


# ── the lease chain (seeded drills against the reference) ────────────


CFG = dict(heartbeat_interval_s=1.0, suspect_windows=1.0, dead_windows=2.0, recover_beats=2)


def _never_skips(transitions):
    for t in transitions:
        if t.old == "joined":
            assert t.new == ALIVE
            continue
        assert abs(_ORDER[t.new] - _ORDER[t.old]) == 1, (t.old, t.new)


def _drive(fleet, script, seed: int):
    """Run one observation script on a package's registry; returns the
    registry and every `emit` call."""
    seen = []
    reg = fleet.FleetRegistry(fleet.LeaseConfig(**CFG), seed=seed,
                              emit=lambda kind, p: seen.append((kind, p)))
    states = []
    for obs in script:
        if obs[0] == "register":
            reg.register(obs[1], obs[2])
        elif obs[0] == "beat":
            reg.heartbeat(obs[1], obs[2])
        else:
            states.append(reg.evaluate(obs[1]))
    return reg, seen, states


def _same_as_reference(script, seed: int):
    ref, ref_seen, ref_states = _drive(REF_FLEET, script, seed)
    port, port_seen, port_states = _drive(PORT_FLEET, script, seed)
    assert [t.to_dict() for t in port.transitions] == [t.to_dict() for t in ref.transitions]
    assert port.transition_digest() == ref.transition_digest()
    assert port_seen == ref_seen and port_states == ref_states
    assert port.summary() == ref.summary()
    _never_skips(port.transitions)
    return port


def _random_script(seed: int) -> list:
    rng = random.Random(seed)
    workers = [f"w{i}" for i in range(4)]
    script = [("register", w, 0.0) for w in workers]
    now = 0.0
    for _ in range(200):
        now += rng.choice([0.25, 0.5, 1.0, 1.5])
        for w in workers:
            if rng.random() < 0.55:
                script.append(("beat", w, now))
        if rng.random() < 0.7:
            script.append(("eval", now))
    return script


class TestLeaseChain:
    def test_silence_walks_the_chain(self):
        reg = _same_as_reference([("register", "w0", 0.0), ("eval", 0.5), ("eval", 1.0),
                                  ("eval", 1.5), ("eval", 2.0)], seed=1)
        assert [t.new for t in reg.transitions] == [ALIVE, SUSPECTED, DEAD]

    def test_dead_within_two_windows_of_last_beat(self):
        script = [("register", "w0", 0.0)]
        for k in range(1, 4):
            script += [("beat", "w0", float(k)), ("eval", float(k))]
        script += [("eval", 4.0), ("eval", 5.0)]
        reg = _same_as_reference(script, seed=2)
        dead = [t for t in reg.transitions if t.new == DEAD]
        assert dead and dead[0].now - 3.0 <= 2.0

    def test_recovery_is_hysteretic_and_stepwise(self):
        reg = _same_as_reference(
            [("register", "w0", 0.0), ("eval", 1.0), ("eval", 2.0), ("beat", "w0", 3.0),
             ("beat", "w0", 4.0), ("beat", "w0", 5.0), ("beat", "w0", 6.0)], seed=3)
        assert [t.new for t in reg.transitions] == [ALIVE, SUSPECTED, DEAD, SUSPECTED, ALIVE]

    def test_missed_beat_resets_the_recovery_streak(self):
        reg = _same_as_reference(
            [("register", "w0", 0.0), ("eval", 1.0), ("beat", "w0", 1.5), ("eval", 2.5),
             ("beat", "w0", 3.0), ("beat", "w0", 3.5)], seed=4)
        assert reg.state_of("w0") == ALIVE

    @pytest.mark.parametrize("seed", [11, 29, 47])
    def test_random_schedules_match_reference_and_replay_identically(self, seed):
        reg = _same_as_reference(_random_script(seed), seed)
        assert len(reg.transitions) > 4
        replayed = FleetRegistry.replay(reg.observations, LeaseConfig(**CFG), seed=seed)
        assert [t.replay_key() for t in replayed.transitions] == [
            t.replay_key() for t in reg.transitions]
        assert replayed.transition_digest() == reg.transition_digest()
        other = FleetRegistry.replay(reg.observations, LeaseConfig(**CFG), seed=seed + 1)
        assert other.transition_digest() != reg.transition_digest()

    def test_transitions_fan_out_through_emit(self):
        _, seen, _ = _drive(PORT_FLEET, [("register", "w0", 0.0), ("eval", 1.0), ("eval", 2.0)],
                            seed=5)
        assert [k for k, _ in seen] == [
            "fleet_worker_joined", "fleet_worker_suspected", "fleet_worker_dead"]
        assert seen[-1][1]["worker"] == "w0"

    def test_env_knobs_read_per_call(self, monkeypatch):
        monkeypatch.setenv("HV_FLEET_HEARTBEAT_S", "0.125")
        monkeypatch.setenv("HV_FLEET_RECOVER_BEATS", "5")
        cfg = LeaseConfig.from_env()
        assert cfg.heartbeat_interval_s == 0.125 and cfg.recover_beats == 5
        assert dataclasses.asdict(cfg) == dataclasses.asdict(REF_FLEET.LeaseConfig.from_env())
        monkeypatch.setenv("HV_FLEET_HEARTBEAT_S", "garbage")
        assert LeaseConfig.from_env().heartbeat_interval_s == 0.25


# ── snapshot digest discipline ───────────────────────────────────────


def _snap(fleet_mod, **over):
    kw = dict(
        seq=3, now=12.5, workers=("w0", "w1"), states=(("w0", ALIVE), ("w1", SUSPECTED)),
        occupancy=(("w0", 4), ("w1", 2)), compiles=(("w0", 7), ("w1", 7)),
        recompiles=(("w0", 0), ("w1", 0)), series=(("w0", 100), ("w1", 100)),
        merged_series=200, transitions_digest="abc",
        floor_distance=(("w0", 3.14159), ("w1", None)),
        worst_burn=(("w1", "join", "warning"),), scrape_wall_ms=17.3, errors=(("w1", "slo"),),
    )
    kw.update(over)
    return fleet_mod.FleetSnapshot(**kw)


class TestSnapshotDigest:
    @pytest.mark.parametrize("over", [
        {}, {"worst_burn": (), "scrape_wall_ms": 999.9, "errors": ()}, {"merged_series": 201},
        {"states": (("w0", ALIVE), ("w1", DEAD))}, {"transitions_digest": "xyz"},
        {"now": 12.5000000001, "floor_distance": (("w0", 3.1400001), ("w1", None))},
    ])
    def test_digest_matches_reference(self, over):
        assert _snap(PORT_FLEET, **over).digest() == _snap(REF_FLEET, **over).digest()

    def test_advisories_do_not_shift_the_digest_and_inputs_do(self):
        a = _snap(PORT_FLEET)
        assert a.digest() == _snap(PORT_FLEET, worst_burn=(), scrape_wall_ms=999.9,
                                   errors=()).digest()
        assert a.digest() != _snap(PORT_FLEET, merged_series=201).digest()
        assert a.digest() == _snap(PORT_FLEET, now=12.5000000001).digest()

    def test_totals(self):
        assert _snap(PORT_FLEET).totals() == {
            "occupancy": 6, "compiles": 14, "recompiles": 0, "series": 200}
        assert isinstance(_snap(PORT_FLEET), FleetSnapshot)


# ── stitching ────────────────────────────────────────────────────────


def _chrome_frag(name: str) -> dict:
    return {
        "traceEvents": [
            {"name": "process_name", "ph": "M", "pid": 1, "args": {"name": "hv"}},
            {"name": f"wave:{name}", "cat": "hv", "ph": "X", "ts": 1.0, "dur": 2.0,
             "pid": 1, "tid": 7, "args": {}},
        ],
        "displayTimeUnit": "ms",
    }


def _otlp_frag() -> dict:
    return {"resourceSpans": [{
        "resource": {"attributes": [
            {"key": "service.name", "value": {"stringValue": "hv"}},
            {"key": "hv.worker", "value": {"stringValue": "stale"}},
            {"key": "host", "value": {"stringValue": "h"}}]},
        "scopeSpans": [{"scope": {"name": "s"}, "spans": [{"name": "x"}]}],
    }]}


class TestStitch:
    def test_chrome_worker_lanes_as_the_reference(self):
        frags = {"w1": _chrome_frag("b"), "w0": _chrome_frag("a"), "w2": {}}
        doc = stitch_chrome(frags)
        assert doc == REF_FLEET.stitch_chrome(frags)
        meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
        assert [(m["pid"], m["args"]["name"]) for m in meta] == [(1, "worker:w0"), (2, "worker:w1")]

    def test_otlp_resource_per_worker_as_the_reference(self):
        frags = {"w1": _otlp_frag(), "w0": _otlp_frag()}
        doc = stitch_otlp(frags)
        want = json.loads(json.dumps(REF_FLEET.stitch_otlp(frags)).replace(
            "hypervisor_tpu/", "hypervisor_tpu_torch/"))
        assert doc == want
        names = [{a["key"]: a["value"]["stringValue"] for a in rs["resource"]["attributes"]}
                 for rs in doc["resourceSpans"]]
        assert [(n["service.name"], n["hv.worker"]) for n in names] == [
            ("hypervisor_tpu_torch/w0", "w0"), ("hypervisor_tpu_torch/w1", "w1")]


# ── worker spec ──────────────────────────────────────────────────────


class TestWorkerSpec:
    def test_json_round_trip_keeps_the_device(self):
        spec = WorkerSpec(worker_id="w0", tenants=(0, 1), port=8123, env=(("HV_TRACE", "1"),),
                          device="cpu")
        again = WorkerSpec.from_json(spec.to_json())
        assert again == spec and again.device == "cpu"
        assert again.wants_arena
        assert not WorkerSpec(worker_id="s", tenants=(0,)).wants_arena

    def test_a_reference_spec_reads_as_the_card(self):
        raw = REF_FLEET.WorkerSpec(worker_id="w0", tenants=(0, 1), port=81).to_json()
        spec = WorkerSpec.from_json(raw)
        assert spec.device == "cuda"
        assert dataclasses.asdict(spec) == {**json.loads(raw), "tenants": (0, 1), "env": (),
                                            "device": "cuda"}
        assert spec.base_url == "http://127.0.0.1:81"

    def test_durable_ownership_is_refused_before_any_process_starts(self, tmp_path):
        """The name this test had while the port refused `durability_root`.
        A durable worker (a CPU subprocess) adopts its namespace before it
        serves: its manifest names its tenants and each tenant journals
        into its fenced WAL; a restart at a stale epoch (below the fence
        floor a failover left) refuses at `adopt`, before its READY line,
        and nothing is written into its old namespace."""
        from hypervisor_tpu_torch.fleet.failover import WorkerDurability

        spec = WorkerSpec(worker_id="w0", tenants=(0, 1), durability_root=str(tmp_path),
                          device="cpu")
        sup = FleetSupervisor([spec], log_dir=str(tmp_path / "logs"))
        sup.start()
        try:
            epoch_dir = tmp_path / "w0" / "epoch_0"
            manifest = json.loads((epoch_dir / "manifest.json").read_text())
            assert manifest == {"epoch": 0, "tenants": [0, 1], "worker_id": "w0"}
            sizes = {t: (epoch_dir / f"tenant_{t}" / "wal.log").stat().st_size for t in (0, 1)}
            assert all(sizes.values())  # the warm rounds journaled
        finally:
            sup.stop()
        WorkerDurability.write_fence(tmp_path, "w0", 1)
        stale = FleetSupervisor([spec], ready_timeout_s=120, log_dir=str(tmp_path / "logs"))
        with pytest.raises(RuntimeError, match="never printed its READY line"):
            stale.start()
        assert not stale.alive("w0")
        assert "FencingError" in (tmp_path / "logs" / "w0.err").read_text()
        assert {t: (epoch_dir / f"tenant_{t}" / "wal.log").stat().st_size
                for t in (0, 1)} == sizes

    def test_later_names_refuse_naming_their_slice(self):
        """The name this test had while the failover and rebalance names
        refused: each now resolves to the port's class, and the package
        exports the reference's `__all__`."""
        from hypervisor_tpu_torch.fleet import failover, rebalance

        for name, mod in (("FailoverController", failover), ("WorkerDurability", failover),
                          ("OwnershipMap", failover), ("FencedWal", failover),
                          ("RebalanceController", rebalance), ("PROTOCOL_STEPS", rebalance),
                          ("MigrationError", rebalance)):
            assert name in REF_FLEET.__all__
            assert getattr(PORT_FLEET, name) is getattr(mod, name)
        assert PORT_FLEET.__all__ == REF_FLEET.__all__
        assert not hasattr(PORT_FLEET, "_LATER")


# ── the ten fleet routes ─────────────────────────────────────────────


FLEET_ROUTES = [
    ("debug_fleet", "GET", "/debug/fleet", None),
    ("workers", "GET", "/fleet/workers", None),
    ("metrics", "GET", "/fleet/metrics", None),
    ("slo", "GET", "/fleet/slo", None),
    ("trace", "GET", "/fleet/trace/t1", None),
    ("trace_bad_format", "GET", "/fleet/trace/t1?format=protobuf", None),
    ("incidents", "GET", "/fleet/incidents", None),
    ("ownership", "GET", "/fleet/ownership", None),
    ("failover", "GET", "/fleet/failover", None),
    ("rebalance", "GET", "/fleet/rebalance", None),
    ("rebalance_post", "POST", "/fleet/rebalance", {"now": 1.0}),
]


def _service(P: Pkg, attach: bool):
    from tests.test_torch_api import service_for

    svc = service_for(P)
    if attach:
        svc.fleet = P.mod("fleet").FleetObservatory({})
    return svc


def _wall_free(label: str, body):
    """The observatory's scrape wall is measured (an advisory outside the
    snapshot digest): held to be a time, then set aside."""
    if label == "debug_fleet" and isinstance(body, dict) and "scrape_wall_ms" in body:
        assert body["scrape_wall_ms"] >= 0.0
        body = {**body, "scrape_wall_ms": "wall"}
    return body


def _via_service(P: Pkg, attach: bool) -> list:
    svc = _service(P, attach)
    M = P.mod("api.models")
    ApiError = P.mod("api.service").ApiError
    calls = {
        "debug_fleet": svc.debug_fleet, "workers": svc.fleet_workers,
        "metrics": svc.fleet_metrics, "slo": svc.fleet_slo,
        "trace": lambda: svc.fleet_trace("t1"),
        "trace_bad_format": lambda: svc.fleet_trace("t1", format="protobuf"),
        "incidents": svc.fleet_incidents, "ownership": svc.fleet_ownership,
        "failover": svc.fleet_failover, "rebalance": svc.fleet_rebalance,
        "rebalance_post": lambda: svc.fleet_rebalance_post(M.FleetRebalanceRequest(now=1.0)),
    }
    out = []
    for label, *_ in FLEET_ROUTES:
        try:
            body = asyncio.run(calls[label]())
            out.append((label, 200, _wall_free(label, body if isinstance(body, dict) else str(body))))
        except ApiError as e:
            out.append((label, e.status, e.detail))
    return out


def _via_http(P: Pkg, attach: bool) -> list:
    svc = _service(P, attach)
    server = P.mod("api").HypervisorHTTPServer(service=svc, port=0).start()
    out = []
    try:
        for label, method, path, body in FLEET_ROUTES:
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
            conn.request(method, path, body=None if body is None else json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            raw = resp.read().decode()
            conn.close()
            is_json = resp.getheader("Content-Type", "").startswith("application/json")
            out.append((label, resp.status, _wall_free(label, json.loads(raw) if is_json else raw)))
    finally:
        server.stop()
    return out


@pytest.mark.parametrize("attach", [False, True], ids=["no_fleet", "empty_fleet"])
@pytest.mark.parametrize("transport", [_via_service, _via_http], ids=["service", "http"])
def test_fleet_routes_answer_as_the_reference(transport, attach):
    ref, port = both(lambda P: transport(P, attach))
    assert port == ref
    rec = {label: (status, body) for label, status, body in port}
    if not attach:
        assert rec["debug_fleet"] == (200, {"enabled": False})
        assert all(rec[k][0] == 503 for k in rec if k not in ("debug_fleet", "trace_bad_format"))
    else:
        assert rec["debug_fleet"][0] == 200 and rec["debug_fleet"][1]["enabled"]
        assert rec["workers"] == (200, {"workers": {}, "counts": None})
        assert all(rec[k][0] == 503 for k in ("ownership", "failover", "rebalance",
                                              "rebalance_post"))
    assert rec["trace_bad_format"][0] == 400


# ── end to end: real worker subprocesses ─────────────────────────────


class TestFleetE2E:
    def test_one_worker_merged_drain_and_lease(self):
        sup = FleetSupervisor([WorkerSpec(worker_id="w0", tenants=(0,), device="cpu")])
        try:
            sup.start()
            assert sup.alive("w0")
            reg = FleetRegistry(LeaseConfig(heartbeat_interval_s=1.0), seed=9)
            reg.register("w0", 0.0)
            obs = FleetObservatory(sup.urls(), registry=reg)
            merged, snap = obs.drain(now=0.0)
            assert snap.merged_series == sum(v for _, v in snap.series) > 0
            assert worker_label_coverage(merged) == 1.0
            assert dict(snap.states)["w0"] == ALIVE and snap.errors == ()
            # The CPU runs the plain versions: the worker counts no launch.
            counts = sup.launch_counts("w0")
            assert "admission_block" in counts and not any(counts.values())
            from hypervisor_tpu_torch.api.server import HypervisorHTTPServer
            from hypervisor_tpu_torch.api.service import HypervisorService
            from hypervisor_tpu_torch.core import Hypervisor

            svc = HypervisorService(hypervisor=Hypervisor(device="cpu"))
            svc.fleet = obs
            srv = HypervisorHTTPServer(svc, port=0).start()
            try:
                doc = json.loads(urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/debug/fleet", timeout=10).read())
                assert doc["enabled"] and "w0" in doc["workers"]
                assert doc["registry"]["transition_count"] >= 1
                text = urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/fleet/metrics", timeout=10).read().decode()
                assert worker_label_coverage(text) == 1.0
            finally:
                srv.stop()
            sup.kill("w0")
            assert not sup.alive("w0")
            reg.evaluate(1.0)
            reg.evaluate(2.0)
            assert reg.state_of("w0") == DEAD
        finally:
            sup.stop()

    def test_a_worker_without_cuda_fails_loudly(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device starts")
        sup = FleetSupervisor([WorkerSpec(worker_id="w0")], ready_timeout_s=120,
                              log_dir=str(tmp_path))
        with pytest.raises(RuntimeError, match="never printed its READY line"):
            sup.start()
        assert not sup.alive("w0")
        assert "CUDA is not available" in (tmp_path / "w0.err").read_text()
