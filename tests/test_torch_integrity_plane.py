"""The port's integrity plane against the reference's, on the CPU.

Counterparts of `tests/unit/test_integrity.py` (clean runs, detection and
repair, the scrubber's escalation, the corruption-oracle property, the
escalation safety) on `hypervisor_tpu_torch.integrity.IntegrityPlane`
over the port's `HypervisorState(device="cpu")`, with the reference
unarmed (`HV_WAVE_PALLAS=0`, `HV_ROOFLINE=0`). Every sequence runs on
both packages with the same seeded corruptions
(`testing.chaos.InjectedCorruption`): an agent σ bit flip (out of range:
the repair rung) and a session row rewrite (an FSM code: the restore
rung, through the `Supervisor`'s checkpoint and WAL replay).

Tolerance 0: `integrity_summary` after each rung, the drained metrics
(`test_torch_metrics.masked`), every checkpointed column and the chain
heads, and the restored state against the uninterrupted history.
"""

from __future__ import annotations

import numpy as np
import pytest

from hypervisor_tpu.integrity import CATALOG as JAX_CATALOG
from hypervisor_tpu.integrity import IntegrityError as JaxIntegrityError
from hypervisor_tpu.integrity import IntegrityPlane as JaxPlane
from hypervisor_tpu.integrity import StateRestoredError as JaxRestored
from hypervisor_tpu.resilience import Supervisor as JaxSupervisor
from hypervisor_tpu_torch import integrity as port_integrity
from hypervisor_tpu_torch.integrity import IntegrityPlane as PortPlane
from hypervisor_tpu_torch.observability import metrics as port_metrics
from hypervisor_tpu_torch.resilience.supervisor import Supervisor as PortSupervisor
from tests.test_torch_metrics import assert_snaps_equal, both, masked, unarmed  # noqa: F401
from tests.test_torch_resilience import PORT, assert_same, fingerprint

#: The reference test's tables (`tests/unit/test_integrity.py` SMALL).
CAP = dict(max_agents=512, max_sessions=512, max_vouch_edges=64, max_sagas=16,
           max_steps_per_saga=8, max_elevations=16, delta_log_capacity=2048,
           event_log_capacity=128, trace_log_capacity=128)
SIGMA_FLIP = dict(kind="bit_flip", table="agents")
FSM_REWRITE = dict(kind="row_rewrite", table="sessions")


def plane_of(pkg):
    return JaxPlane if pkg.ref else PortPlane


def supervisor_of(pkg):
    return JaxSupervisor if pkg.ref else PortSupervisor


def restored_error(pkg):
    return JaxRestored if pkg.ref else port_integrity.StateRestoredError


def drive_waves(st, pkg, rounds, base=0, lanes=2):
    for r in range(base, base + rounds):
        slots = st.create_sessions_batch([f"w{r}:{i}" for i in range(lanes)],
                                         pkg.models.SessionConfig(min_sigma_eff=0.0))
        st.run_governance_wave(slots, [f"did:w{r}:{i}" for i in range(lanes)], slots.copy(),
                               np.full(lanes, 0.8, np.float32),
                               np.zeros((1, lanes, 16), np.uint32), now=float(r))


def injector(pkg, seed: int, **corruption):
    at = corruption.pop("at_dispatch", 1)
    return pkg.chaos.WaveChaosInjector(pkg.chaos.WaveChaosPlan(
        seed=seed, corruptions=(pkg.chaos.InjectedCorruption(at_dispatch=at, **corruption),)))


def test_catalog_matches_reference():
    assert port_integrity.CATALOG == JAX_CATALOG
    assert port_integrity.ESCROW_CAP == pytest.approx(1.0 + 1e-4)


def test_clean_waves_report_zero_violations_and_fold_the_sanitizer():
    """Twelve clean facade waves with the sanitizer every 2nd dispatch and
    a scrub tick every dispatch: the cadence folds the sanitizer into
    the facade wave (no pass of its own), every drain is equal and
    clean."""

    def run(pkg, clock):
        st = pkg.state(**CAP)
        plane = plane_of(pkg)(st, every=2, scrub_every=1, scrub_budget=32)
        drains = []
        for r in range(12):
            drive_waves(st, pkg, 1, base=r)
            drains.append(masked(st.metrics_snapshot()))
        return st.integrity_summary(), drains, plane.checks

    ref, port = both(run)
    assert port[0] == ref[0]
    assert port[2] == ref[2] == 6
    assert port[0]["violations_seen"] == 0 and port[0]["scrub"]["links_verified"] > 0
    for i, (a, b) in enumerate(zip(ref[1], port[1])):
        assert_snaps_equal(a, b, ctx=f"(drain {i})")
    last = port[1][-1]
    assert last["counters"][port_metrics.INTEGRITY_CHECKS.index] == 6
    assert last["counters"][port_metrics.INTEGRITY_SCRUB_LINKS.index] > 0
    assert last["gauges"][port_metrics.INTEGRITY_VIOLATION_ROWS.index] == 0


def test_facade_wave_takes_the_sanitize_variant_on_cadence(monkeypatch):
    from hypervisor_tpu_torch import state as port_state

    seen = []
    real = port_state._WAVE

    def spy(*args, **kwargs):
        seen.append(kwargs["sanitize"])
        return real(*args, **kwargs)

    monkeypatch.setattr(port_state, "_WAVE", spy)
    st = PORT.state(**CAP)
    PortPlane(st, every=2)
    drive_waves(st, PORT, 4)
    assert seen == [False, True, False, True]
    snap = st.metrics_snapshot()
    assert snap.counter(port_metrics.INTEGRITY_CHECKS) == 2


def test_sigma_bit_flip_is_repaired_in_place():
    """The repair rung: an out-of-range σ (a seeded exponent-bit flip)
    lands at the gate, the sampled sanitizer sees it, the drain marks the
    plane dirty, and the next gate repairs the row in place."""

    def run(pkg, clock):
        st = pkg.state(**CAP)
        plane = plane_of(pkg)(st, every=1)
        drive_waves(st, pkg, 2)
        st.fault_injector = injector(pkg, 21, **SIGMA_FLIP)
        drive_waves(st, pkg, 2, base=2)
        detect = masked(st.metrics_snapshot())
        st.fault_injector = None
        drive_waves(st, pkg, 1, base=4)
        after = masked(st.metrics_snapshot())
        return (st.integrity_summary(), detect, after, fingerprint(st), plane.repairs,
                plane.sanitize()["total"])

    ref, port = both(run)
    assert port[0] == ref[0]
    assert_snaps_equal(ref[1], port[1], ctx="(detecting drain)")
    assert_snaps_equal(ref[2], port[2], ctx="(after the repair)")
    assert_same(ref[3], port[3], ctx="(repaired tables)")
    assert port[4] == ref[4] >= 1 and port[5] == ref[5] == 0
    assert port[1]["gauges"][port_metrics.INTEGRITY_VIOLATION_ROWS.index] >= 1
    assert port[0]["repairs"]["rows_repaired"] >= 1


def _restore_round(st, sup, pkg, r, lanes=2):
    """One round with restore-retry semantics: a gate that restored
    refuses the wave, which re-issues against the recovered state."""
    slots = st.create_sessions_batch([f"w{r}:{i}" for i in range(lanes)],
                                     pkg.models.SessionConfig(min_sigma_eff=0.0))
    args = (slots, [f"did:w{r}:{i}" for i in range(lanes)], slots.copy(),
            np.full(lanes, 0.8, np.float32), np.zeros((1, lanes, 16), np.uint32))
    try:
        st.run_governance_wave(*args, now=float(r))
    except restored_error(pkg):
        sup.state.run_governance_wave(*args, now=float(r))
        return True
    return False


@pytest.mark.parametrize("corruption", [
    dict(FSM_REWRITE, at_dispatch=2), dict(SIGMA_FLIP, at_dispatch=2),
    dict(kind="chain_tamper", at_dispatch=2),
], ids=["fsm_code", "sigma", "chain_tamper"])
def test_restore_rung_lands_on_the_uninterrupted_history(corruption, tmp_path):
    """The restore rung (`ladder="restore"`: every violation escalates):
    the supervisor recovers from its checkpoint and the WAL on the
    state's device, and the result equals an uninterrupted run of the
    same workload, on both packages and across them."""

    def run(pkg, clock):
        side = tmp_path / ("ref" if pkg.ref else "port")
        oracle = pkg.state(**CAP)
        drive_waves(oracle, pkg, 6)
        st = pkg.state(**CAP)
        st.journal = pkg.wal.WriteAheadLog(side / "wal.log", fsync=False)
        sup = supervisor_of(pkg)(st, checkpoint_dir=str(side / "ckpt"), sleep=lambda s: None)
        plane = plane_of(pkg)(st, every=1, scrub_every=1, scrub_budget=256, ladder="restore")
        drive_waves(st, pkg, 3)
        sup.checkpoint()
        sup.state.fault_injector = injector(pkg, 13, **dict(corruption))
        restored_at = []
        for r in range(3, 6):
            if _restore_round(sup.state, sup, pkg, r):
                restored_at.append(r)
            sup.state.metrics_snapshot()
        if plane.restores == 0:
            assert plane.sanitize()["restored"]
        st = sup.state
        assert_same(fingerprint(oracle), fingerprint(st), ctx="(restored vs uninterrupted)")
        out = st.integrity_summary()
        # Paths and the recovery's wall time are each run's own.
        sup_summary = st.resilience_summary()
        for key in ("wall_ms", "checkpoint", "wal"):
            sup_summary["restores"]["last"].pop(key)
        sup_summary["checkpoint"].pop("path")
        sup_summary["journal"]["path"] = None
        return (fingerprint(st), out, sup_summary, restored_at, plane.restores,
                masked(st.metrics_snapshot()))

    ref, port = both(run)
    assert_same(ref[0], port[0], ctx="(port vs reference after restore)")
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[3] == ref[3] and port[4] == ref[4] >= 1
    assert_snaps_equal(ref[5], port[5], ctx="(the restored state's drain)")


def test_restore_class_without_a_restore_path_raises_on_both(tmp_path):
    def run(pkg, clock):
        out = []
        for wired in (False, True):
            st = pkg.state(**CAP)
            if wired:
                supervisor_of(pkg)(st, sleep=lambda s: None)  # no checkpoint_dir
            plane = plane_of(pkg)(st, every=0)
            drive_waves(st, pkg, 1)
            inj = injector(pkg, 4, **FSM_REWRITE)
            inj.dispatches = 1
            inj.apply_due_corruptions(st)
            err = JaxIntegrityError if pkg.ref else port_integrity.IntegrityError
            with pytest.raises(err, match="no supervisor restore|restore path"):
                plane.sanitize()
            out.append(st.metrics_snapshot().counter(port_metrics.INTEGRITY_RESTORES))
            out.append(st.integrity_summary()["sampling"]["pending"])
        return out

    ref, port = both(run)
    assert port == ref == [1, True, 1, True]


def test_environment_knobs_are_read_where_the_reference_reads_them(monkeypatch):
    monkeypatch.setenv("HV_INTEGRITY_EVERY", "3")
    monkeypatch.setenv("HV_SCRUB_EVERY", "5")
    monkeypatch.setenv("HV_SCRUB_BUDGET", "17")
    monkeypatch.setenv("HV_INTEGRITY_LADDER", "restore")

    def run(pkg, clock):
        plane = plane_of(pkg)(pkg.state(**CAP))
        return plane.every, plane.scrub_every, plane.scrubber.budget, plane.ladder

    ref, port = both(run)
    assert port == ref == (3, 5, 17, "restore")
    monkeypatch.setenv("HV_INTEGRITY_LADDER", "bogus")
    with pytest.raises(ValueError, match="unknown ladder"):
        PortPlane(PORT.state(**CAP))


def test_attach_after_restore_keeps_cumulative_scrub_stats():
    def run(pkg, clock):
        st = pkg.state(**CAP)
        plane = plane_of(pkg)(st, every=0, scrub_budget=64)
        drive_waves(st, pkg, 2)
        plane.scrub_tick()
        before = plane.scrubber.links_verified
        fresh = pkg.state(**CAP)
        plane.attach(fresh)
        return before, plane.scrubber.links_verified, fresh.integrity is plane, fresh.integrity_summary()

    ref, port = both(run)
    assert port == ref and port[0] == port[1] > 0 and port[2]
