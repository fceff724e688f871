"""The port's supervisor against the reference's, on the CPU.

Counterparts of `tests/unit/test_resilience.py::TestSupervisor` and
`::TestSeededChaosEndToEnd` without their API half (the `/debug/resilience`
transports arrive with ROADMAP A5): the retry ladder and its backoff,
exhaustion into degraded mode (joins shed, the fan-out paused,
terminations and audit commits flowing) and the exit after clean
dispatches, health-event pressure, the device loss that is never retried,
watermarked periodic checkpoints and their skip, the facade's bus bridge,
and a seeded chaos run that ends equal to the clean run. Each runs on
both packages (the reference unarmed, `HV_WAVE_PALLAS=0`) and the
supervisors' accounting must be equal: `summary()` with the recovery
latencies (wall time) and paths set apart.
"""

from __future__ import annotations

import numpy as np
import pytest

import hypervisor_tpu as REF_PKG
import hypervisor_tpu_torch as PORT_PKG
from hypervisor_tpu.resilience import Supervisor as JaxSupervisor
from hypervisor_tpu_torch.observability import metrics as port_metrics
from hypervisor_tpu_torch.resilience import supervisor as port_supervisor
from hypervisor_tpu_torch.testing import same_health_on_every_run, supervisor_accounting
from tests.test_torch_metrics import both, masked, assert_snaps_equal, unarmed  # noqa: F401
from tests.test_torch_resilience import PORT, assert_same, fingerprint


def supervisor(pkg, st, **kw):
    return (JaxSupervisor if pkg.ref else port_supervisor.Supervisor)(st, **kw)


def rig(pkg, **kw):
    st = pkg.state()
    defaults = dict(max_retries=3, backoff_base_s=0.0, degrade_after_failures=1,
                    exit_after_clean=2, sleep=lambda s: None)
    defaults.update(kw)
    return st, supervisor(pkg, st, **defaults)


def wave(st, sup, pkg, tag, n=2, now=1.0):
    slots = st.create_sessions_batch([f"{tag}:{i}" for i in range(n)],
                                     pkg.models.SessionConfig(min_sigma_eff=0.0))
    return sup.dispatch("governance_wave", st.run_governance_wave, slots,
                        [f"did:{tag}:{i}" for i in range(n)], slots.copy(),
                        np.full(n, 0.8, np.float32), np.zeros((1, n, 16), np.uint32), now)


def chaos(pkg, seed, **plan):
    return pkg.chaos.WaveChaosInjector(pkg.chaos.WaveChaosPlan(seed=seed, **plan))


def test_retry_recovers_transient_faults():
    def run(pkg, clock):
        st, sup = rig(pkg)
        st.fault_injector = chaos(pkg, 3, fail_rate=0.5)
        for i in range(5):
            wave(st, sup, pkg, f"r{i}")
        return supervisor_accounting(sup), fingerprint(st), masked(st.metrics_snapshot())

    ref, port = both(run)
    assert port[0] == ref[0]
    assert_same(ref[1], port[1])
    assert_snaps_equal(ref[2], port[2])
    assert port[0]["dispatch"]["retries"] > 0 and port[0]["dispatch"]["failed"] == 0
    assert port[0]["mode"] == "normal" and port[0]["recovery_latency_ms"] > 0
    assert port[2]["counters"][port_metrics.DISPATCH_RETRIES.index] == port[0]["dispatch"][
        "retries"]


def test_backoff_is_exponential_and_capped():
    def run(pkg, clock):
        slept = []
        st, sup = rig(pkg, max_retries=5, backoff_base_s=0.1, sleep=slept.append)
        sup.backoff_cap_s = 0.5
        st.fault_injector = chaos(pkg, 0, fail_rate=1.0)
        with pytest.raises(pkg.chaos.InjectedWaveFault):
            wave(st, sup, pkg, "b")
        return slept, supervisor_accounting(sup)

    ref, port = both(run)
    assert port == ref
    assert port[0] == pytest.approx([0.1, 0.2, 0.4, 0.5, 0.5])


def test_exhaustion_degrades_sheds_and_recovers():
    def run(pkg, clock):
        st, sup = rig(pkg)
        st.fault_injector = chaos(pkg, 1, fail_rate=1.0)
        with pytest.raises(pkg.chaos.InjectedWaveFault):
            wave(st, sup, pkg, "x")
        out = [sup.degraded]
        with pytest.raises(pkg.policy.DegradedModeRefusal):
            st.enqueue_join(0, "did:shed", 0.9)
        st._fanout_groups[0] = [(0, [0, 1])]
        out.append(st.fanout_dispatch())
        del st._fanout_groups[0]
        slot = st.create_session("s:flow", pkg.models.SessionConfig(min_sigma_eff=0.0))
        st.fault_injector = None
        st.stage_delta(slot, -1, ts=1.0)
        out.append(st.flush_deltas())
        out.append(st.terminate_sessions([slot], now=2.0).tolist())
        wave(st, sup, pkg, "c0")
        wave(st, sup, pkg, "c1")
        out += [sup.degraded, sup.degraded_exits]
        return out, supervisor_accounting(sup), masked(st.metrics_snapshot())

    ref, port = both(run)
    assert port[0] == ref[0]
    assert port[0][0] is True and port[0][1] == [] and port[0][2] == 1
    assert port[0][-2:] == [False, 1]
    assert port[1] == ref[1]
    assert_snaps_equal(ref[2], port[2])


def test_health_pressure_degrades():
    def run(pkg, clock):
        out = []
        st, sup = rig(pkg, degrade_after_stragglers=2)
        st.health.emit_event("straggler", {"stage": "governance_wave", "trace_id": "t"})
        out.append(sup.degraded)
        sup._on_health_event("straggler", {})
        out.append(sup.degraded)
        st2, sup2 = rig(pkg, degrade_after_capacity=1)
        st2.health.emit_event("capacity", {"table": "agents"})
        out.append(sup2.degraded)
        # The compensation storm: saga_work's comp_backlog event.
        st3, sup3 = rig(pkg, degrade_after_comp_backlog=3)
        slot = st3.create_session("s:comp", pkg.models.SessionConfig(min_sigma_eff=0.0))
        gs = [st3.create_saga(f"g{i}", slot, [{"has_undo": True}, {}]) for i in range(4)]
        st3.saga_round({g: True for g in gs})
        st3.saga_round({g: False for g in gs})
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("HV_COMP_BACKLOG_WARN", "2")
            work = st3.saga_work()
        out += [work[1], sup3.degraded, sup3.comp_backpressure_entries]
        return out, supervisor_accounting(sup), supervisor_accounting(sup2), supervisor_accounting(sup3)

    ref, port = both(run)
    assert port == ref
    assert port[0][:3] == [False, True, True]
    assert port[0][4:] == [True, 1]


def test_device_loss_is_not_retried():
    def run(pkg, clock):
        st, sup = rig(pkg, max_retries=10)
        calls = []

        def drain():
            calls.append(1)
            raise pkg.chaos.InjectedDeviceLoss("corrupt drain")

        with pytest.raises(pkg.chaos.InjectedDeviceLoss):
            sup.dispatch("metrics_drain", drain)
        return len(calls), supervisor_accounting(sup)

    ref, port = both(run)
    assert port == ref and port[0] == 1 and port[1]["dispatch"]["device_losses"] == 1


def test_only_the_injected_fault_retries():
    """A fault that is not the injected chaos fault — a CUDA error, a
    failed build, a refused launch all reach the ladder as such —
    propagates on the first attempt, untouched."""
    st, sup = rig(PORT, max_retries=10)
    assert port_supervisor.RETRYABLE == (PORT.chaos.InjectedWaveFault,)
    calls = []

    def launch():
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    with pytest.raises(RuntimeError, match="CUDA error"):
        sup.dispatch("governance_wave", launch)
    assert calls == [1] and sup.retries == 0 and not sup.degraded


def test_periodic_checkpoints_use_fresh_steps_and_prune(tmp_path):
    def run(pkg, clock):
        side = tmp_path / ("ref" if pkg.ref else "port")
        st = pkg.state()
        sup = supervisor(pkg, st, checkpoint_dir=str(side), sleep=lambda s: None)
        sup.checkpoint_keep = 2
        names = [sup.checkpoint().name for _ in range(4)]
        durable = sorted(p.name for p in side.iterdir() if (p / ".done").exists())
        latest = pkg.recovery.latest_durable_checkpoint(side).name
        sup2 = supervisor(pkg, pkg.state(), checkpoint_dir=str(side), sleep=lambda s: None)
        return names, durable, latest, sup2.checkpoint().name

    ref, port = both(run)
    assert port == ref == (["step_1", "step_2", "step_3", "step_4"], ["step_3", "step_4"],
                           "step_4", "step_5")


def test_watermarked_periodic_checkpoint_and_its_skip(tmp_path):
    def run(pkg, clock):
        side = tmp_path / ("ref" if pkg.ref else "port")
        st = pkg.state()
        st.journal = pkg.wal.WriteAheadLog(side / "wal.log", fsync=False)
        sup = supervisor(pkg, st, checkpoint_dir=str(side / "ck"), checkpoint_every=2,
                         sleep=lambda s: None)
        for i in range(4):
            wave(st, sup, pkg, f"p{i}")
        first = supervisor_accounting(sup)
        slot = st.create_session("s:skip", pkg.models.SessionConfig(min_sigma_eff=0.0))
        st.enqueue_join(slot, "did:staged", 0.9)  # staged, unflushed: refuses a save
        out = [sup.dispatch("noop", lambda: "ok"), sup.dispatch("noop", lambda: "ok")]
        return first, out, sup.checkpoints_skipped, "staged" in sup.last_checkpoint_error

    ref, port = both(run)
    assert port == ref
    assert port[0]["checkpoint"]["step"] == 2 and port[0]["checkpoint"]["wal_seq"] > 0
    assert port[1] == ["ok", "ok"] and port[2] == 1 and port[3]


def test_transitions_reach_the_event_bus():
    def run(pkg, clock):
        mod = REF_PKG if pkg.ref else PORT_PKG
        bus = mod.HypervisorEventBus()
        hv = mod.Hypervisor(state=pkg.state(), event_bus=bus)
        same_health_on_every_run(hv)
        sup = supervisor(pkg, hv.state, sleep=lambda s: None)
        sup.force_degraded("bus test")
        sup.force_recovered()
        entered = bus.query_by_type(mod.EventType.DEGRADED_ENTERED)
        exited = bus.query_by_type(mod.EventType.DEGRADED_EXITED)
        return ([e.payload["reason"] for e in entered], [e.payload["degraded_s"] for e in exited],
                hv.state.incidents_summary()["captured"])

    ref, port = both(run)
    assert port == ref == (["bus test"], [0.0], 1)


def test_seeded_chaos_run_loses_no_committed_transition(tmp_path):
    """A chaos run (wave faults at seed 11 + the supervisor's retries)
    ends bit-identical to the same workload without chaos, with degraded
    enter/exit on the bus, and its journal replays losslessly; the
    retry and degraded accounting equal the reference's."""

    def drive(st, pkg, dispatch):
        for i in range(8):
            slots = st.create_sessions_batch([f"e2e{i}:{j}" for j in range(2)],
                                             pkg.models.SessionConfig(min_sigma_eff=0.0))
            dispatch(st.run_governance_wave, slots, [f"did:e2e{i}:{j}" for j in range(2)],
                     slots.copy(), np.full(2, 0.8, np.float32),
                     np.zeros((1, 2, 16), np.uint32), float(i))

    def run(pkg, clock):
        side = tmp_path / ("ref" if pkg.ref else "port")
        mod = REF_PKG if pkg.ref else PORT_PKG
        clean = pkg.state()
        drive(clean, pkg, lambda fn, *a: fn(*a))
        bus = mod.HypervisorEventBus()
        hv = mod.Hypervisor(state=pkg.state(), event_bus=bus)
        same_health_on_every_run(hv)
        chaotic = hv.state
        chaotic.journal = pkg.wal.WriteAheadLog(side / "e2e.log", fsync=False)
        sup = supervisor(pkg, chaotic, max_retries=6, backoff_base_s=0.0,
                         degrade_after_failures=1, exit_after_clean=1, sleep=lambda s: None)
        chaotic.fault_injector = chaos(pkg, 11, fail_rate=0.4)
        sup.force_degraded("exercise enter/exit during traffic")
        sup.force_recovered()
        drive(chaotic, pkg, lambda fn, *a: sup.dispatch("governance_wave", fn, *a))
        assert_same(fingerprint(clean), fingerprint(chaotic), ctx="(chaos vs clean)")
        pkg.recovery.checkpoint_with_watermark(chaotic, side / "ck")
        back, _ = pkg.recover(side / "ck", side / "e2e.log")
        assert_same(fingerprint(chaotic), fingerprint(back), ctx="(journal replayed)")
        kinds = [e.event_type.value for e in bus.all_events]
        return fingerprint(chaotic), supervisor_accounting(sup), kinds, masked(chaotic.metrics_snapshot())

    ref, port = both(run)
    assert_same(ref[0], port[0], ctx="(port vs reference)")
    assert port[1] == ref[1] and port[1]["dispatch"]["retries"] > 0
    assert port[2] == ref[2]
    assert "resilience.degraded_entered" in port[2] and "resilience.degraded_exited" in port[2]
    assert_snaps_equal(ref[3], port[3])


def test_periodic_checkpoint_never_swallows_a_device_fault(tmp_path):
    """ROADMAP C.2: a periodic checkpoint that fails for a reason of its
    own (staged joins, the disk) is skipped, as in the reference; one
    that fails with a CUDA error re-raises from the dispatch."""
    st = PORT.state()
    sup = port_supervisor.Supervisor(st, checkpoint_dir=str(tmp_path), checkpoint_every=1,
                                     sleep=lambda s: None)

    def card_fault(background=False):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    sup.checkpoint = card_fault
    with pytest.raises(RuntimeError, match="CUDA error"):
        sup.dispatch("noop", lambda: "ok")
    assert sup.checkpoints_skipped == 0

    def disk_fault(background=False):
        raise OSError("no space left on device")

    sup.checkpoint = disk_fault
    assert sup.dispatch("noop", lambda: "ok") == "ok"
    assert sup.checkpoints_skipped == 1 and "no space" in sup.last_checkpoint_error
