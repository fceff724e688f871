"""The port's metrics plane against the reference's, on the CPU.

Counterparts of `tests/unit/test_metrics.py` (the registry, the bucket
quantiles, the wrap-safe drain, exposition, the host-plane tallies) and
of the drain half of `tests/unit/test_health.py`, on
`hypervisor_tpu_torch.observability.metrics` and the port's
`HypervisorState(device="cpu")`. The reference runs unarmed
(`HV_WAVE_PALLAS=0`) with its roofline observatory off (`HV_ROOFLINE=0`:
the port's arrives with ROADMAP A4b, so its gauges stay 0 on both).

Tolerance 0: after every op of the seeded all-ops sequence
(`test_torch_resilience.rich_sequence`), both states drain and every
counter, gauge, device histogram and `hist_sum` must be equal, and so
must the Prometheus text, except two families:

* the host plane's wall-clock stage histograms (`hv_stage_latency_us`):
  their names, labels and observation counts must be equal, their
  buckets and sums are each machine's clock;
* the compile counters (`hv_compiles_total`, `hv_recompiles_total`,
  `hv_donation_failures_total`, `hv_compile_wall_ms_total`): the
  reference counts its process-wide jit cache's misses, the port its
  compile watch's novel signatures (ROADMAP C.2,
  `test_compile_counters_count_novel_signatures`).

This module also holds the harness the other observability tests share
(`both`, `masked`, `prom_masked`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from hypervisor_tpu.observability import metrics as jax_metrics
from hypervisor_tpu_torch import u32
from hypervisor_tpu_torch.observability import health as port_health
from hypervisor_tpu_torch.observability import metrics as port_metrics
from tests.test_torch_facade_api import ManualTime, install_determinism
from tests.test_torch_resilience import PORT, REF, rich_sequence

#: Series of the host plane whose values are each machine's wall clock.
STAGE_ROWS = sorted(h.index for h in port_metrics.STAGE_LATENCY.values())
#: Counters the two packages count differently (ROADMAP C.2).
COMPILE_ROWS = sorted(h.index for h in (
    port_metrics.COMPILES, port_metrics.RECOMPILES, port_metrics.DONATION_FAILURES,
    port_metrics.COMPILE_WALL_MS))
_COMPILE_NAMES = ("hv_compiles_total", "hv_recompiles_total", "hv_donation_failures_total",
                  "hv_compile_wall_ms_total")


@pytest.fixture(autouse=True)
def unarmed(monkeypatch):
    """The reference's unarmed path with its roofline observatory off, and
    no environment knob of the planes under test left set."""
    monkeypatch.setenv("HV_WAVE_PALLAS", "0")
    monkeypatch.setenv("HV_ROOFLINE", "0")
    for name in ("HV_TRACE", "HV_TRACE_SAMPLE", "HV_INTEGRITY_EVERY", "HV_SCRUB_EVERY",
                 "HV_SCRUB_BUDGET", "HV_INTEGRITY_LADDER", "HV_WATCHDOG_K",
                 "HV_WATCHDOG_FLOOR_US", "HV_WATCHDOG_MIN_SAMPLES", "HV_OCC_WARN",
                 "HV_COMP_BACKLOG_WARN"):
        monkeypatch.delenv(name, raising=False)


def both(run):
    """`run(pkg, clock)` on the reference, then on the port, each with its
    own deterministic ids and manual clock starting at the same instant;
    returns (reference result, port result)."""
    outs = []
    for pkg in (REF, PORT):
        clock = ManualTime()
        with pytest.MonkeyPatch.context() as mp:
            install_determinism(mp, clock)
            outs.append(run(pkg, clock))
    return outs[0], outs[1]


def masked(snap) -> dict:
    """A snapshot's arrays with the wall-clock and compile rows set apart:
    the stage histograms keep their observation counts only."""
    counters = snap.counters.copy()
    counters[COMPILE_ROWS] = 0
    hist, hist_sum = snap.hist.copy(), snap.hist_sum.copy()
    stage_counts = hist[STAGE_ROWS].sum(axis=1)
    hist[STAGE_ROWS] = 0
    hist_sum[STAGE_ROWS] = 0.0
    return {"counters": counters, "gauges": snap.gauges.copy(), "hist": hist,
            "hist_sum": hist_sum, "stage_counts": stage_counts, "bounds": snap.bounds.copy()}


def prom_masked(text: str) -> list[str]:
    """Exposition lines with the wall-clock stage buckets and sums cut to
    their name and labels, and the compile counters to their name."""
    out = []
    for line in text.splitlines():
        if line.startswith(("hv_stage_latency_us_bucket", "hv_stage_latency_us_sum")):
            line = line.rsplit(" ", 1)[0]
        elif line.startswith(_COMPILE_NAMES):
            line = line.split(" ", 1)[0].split("{", 1)[0]
        out.append(line)
    return out


def assert_snaps_equal(a: dict, b: dict, ctx: str = "") -> None:
    assert sorted(a) == sorted(b), ctx
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, f"{k} {ctx}"
        assert a[k].tobytes() == b[k].tobytes(), f"{k} diverged {ctx}"


# ── the registry ─────────────────────────────────────────────────────


def test_registry_matches_reference_row_for_row():
    ref, port = jax_metrics.REGISTRY.handles, port_metrics.REGISTRY.handles
    assert len(ref) == len(port)
    for w, g in zip(ref, port):
        assert (g.name, g.kind, g.index, g.help, g.labels) == (
            w.name, w.kind, w.index, w.help, w.labels)
    assert port_metrics.REGISTRY.counts() == jax_metrics.REGISTRY.counts() == (92, 189, 34)
    assert port_metrics.STAGES == jax_metrics.STAGES and len(port_metrics.STAGES) == 13
    assert port_metrics.REGISTRY.bounds == jax_metrics.REGISTRY.bounds
    assert port_metrics.HEALTH_TABLES == jax_metrics.HEALTH_TABLES
    assert port_metrics.PROMETHEUS_CONTENT_TYPE == jax_metrics.PROMETHEUS_CONTENT_TYPE
    reg = port_metrics.MetricsRegistry()
    assert reg.counter("x", kind="a") is reg.counter("x", kind="a")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x", kind="a")
    with pytest.raises(ValueError, match="series already registered"):
        reg.gauge("x", kind="b")


def test_table_create_matches_reference():
    port_m = port_metrics.Metrics(device="cpu")
    ref_m = jax_metrics.Metrics()
    for f in ("counters", "gauges", "hist", "hist_sum", "bounds"):
        w, g = np.asarray(getattr(ref_m.table, f)), getattr(port_m.table, f).numpy()
        assert g.shape == w.shape and g.view(w.dtype).tobytes() == w.tobytes(), f
    assert port_m.table.footprint() == ref_m.table.footprint()


# ── exposition and quantiles on identical snapshots ──────────────────


def _random_snapshot(mod, seed: int):
    rng = np.random.RandomState(seed)
    c, g, h = mod.REGISTRY.counts()
    nb = len(mod.REGISTRY.bounds) + 1
    gauges = rng.choice([0.0, 1.0, 0.5, 1e-7, 123456789.0, 0.1 + 0.2, -3.0, 2.0**60], g)
    return mod.MetricsSnapshot(
        registry=mod.REGISTRY, counters=rng.randint(0, 2**40, c).astype(np.int64),
        gauges=gauges, hist=rng.randint(0, 50, (h, nb)).astype(np.int64),
        hist_sum=rng.uniform(0, 1e7, h), bounds=np.asarray(mod.REGISTRY.bounds, np.float64),
        taken_at=0.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exposition_and_quantiles_match_reference_byte_for_byte(seed):
    ref, port = _random_snapshot(jax_metrics, seed), _random_snapshot(port_metrics, seed)
    assert port.to_prometheus() == ref.to_prometheus()
    extra = {"tenant": 'a"b\\c\nd'}
    assert (port.to_prometheus(extra_labels=extra, emit_headers=False)
            == ref.to_prometheus(extra_labels=extra, emit_headers=False))
    for handle_r, handle_p in zip(jax_metrics.REGISTRY.handles, port_metrics.REGISTRY.handles):
        if handle_r.kind != "histogram":
            continue
        for q in (0.0, 0.25, 0.5, 0.95, 0.99, 1.0):
            assert port.quantile(handle_p, q) == ref.quantile(handle_r, q)
    assert list(port_metrics.iter_stage_quantiles(port, (0.5, 0.99))) == list(
        jax_metrics.iter_stage_quantiles(ref, (0.5, 0.99)))
    for v in (0.0, 1.0, -2.0, 0.1, 1e-9, 2.0**53, 1.5e300, 3.0000000000000004):
        assert port_metrics._fmt(v) == jax_metrics._fmt(v)


def test_host_tallies_match_reference():
    rng = np.random.RandomState(4)
    status = rng.randint(0, 4, 64).astype(np.int8)
    step = rng.randint(0, 7, 64).astype(np.int8)
    fsm_err = rng.rand(16) < 0.2
    sess = rng.randint(0, 5, 16).astype(np.int8)
    verdict = rng.randint(0, 3, 32).astype(np.int8)
    ref, port = jax_metrics.Metrics(), port_metrics.Metrics(device="cpu")
    for mod, m, conv in ((jax_metrics, ref, np.asarray), (port_metrics, port, torch.from_numpy)):
        mod.tally_wave_host(m, status=conv(status), step_state=conv(step), fsm_err=conv(fsm_err),
                            sess_state=conv(sess), released=5, lane_width=64, n_waves=3)
        mod.tally_gateway_host(m, conv(verdict), 32)
    assert_snaps_equal(masked(ref.snapshot()), masked(port.snapshot()))


# ── the drain on a seeded sequence of every journaled op ─────────────


def drained_sequence(pkg, clock, seed: int):
    st = pkg.state()
    st.hindsight_clock = lambda: clock.t
    drains = []

    def after():
        clock.advance(0.25)
        drains.append((masked(st.metrics_snapshot()), prom_masked(st.metrics_prometheus())))

    rich_sequence(st, pkg, seed, after=after)
    return st, drains


@pytest.mark.parametrize("seed", [1, 2])
def test_every_drain_of_the_all_ops_sequence_matches_reference(seed):
    (ref_st, ref), (port_st, port) = both(lambda pkg, clock: drained_sequence(pkg, clock, seed))
    assert len(ref) == len(port) > 40
    for i, ((rs, rp), (ps, pp)) in enumerate(zip(ref, port)):
        assert_snaps_equal(rs, ps, ctx=f"(drain {i})")
        assert pp == rp, f"exposition diverged at drain {i}"
    # The stage timers sat on the reference's dispatch sites: the same
    # stages saw the same number of dispatches.
    counts = ref[-1][0]["stage_counts"]
    stages = dict(zip(port_metrics.STAGES, counts.tolist()))
    for stage in ("governance_wave", "admission_wave", "saga_round", "slash_cascade",
                  "gateway_wave", "breach_sweep", "delta_chain", "terminate_wave"):
        assert stages[stage] > 0, stage
    # The drain never wrote the table it refreshed.
    assert (port_st.metrics.table.gauges.numpy().tobytes()
            == np.asarray(ref_st.metrics.table.gauges).tobytes())


def test_double_drain_is_idempotent_on_both_packages():
    """Draining twice without traffic leaves every counter and histogram
    where it was (the history gauges count the drains themselves)."""
    def run(pkg, clock):
        st, _ = drained_sequence(pkg, clock, 1)
        a, b = masked(st.metrics_snapshot()), masked(st.metrics_snapshot())
        for k in ("counters", "hist", "hist_sum"):
            assert a[k].tobytes() == b[k].tobytes(), f"{k} moved on a quiet drain"
        return b

    ref, port = both(run)
    assert_snaps_equal(ref, port)


def test_u32_counter_carried_across_the_wrap_between_two_drains():
    """A device counter seeded just below 2^32 crosses the wrap between
    two drains: the drained total keeps counting past 2^32 on both."""

    def run(pkg, clock):
        st = pkg.state()
        tick = port_metrics.WAVE_TICKS.index
        admitted = port_metrics.ADMITTED.index
        seed_words = np.array([0xFFFFFFFF, 0xFFFFFFF0], np.uint32)
        if pkg.ref:
            t = st.metrics.table
            st.metrics.commit(dataclasses.replace(
                t, counters=t.counters.at[np.array([tick, admitted])].set(seed_words)))
        else:
            st.metrics.table.counters[[tick, admitted]] = u32.narrow(
                torch.from_numpy(seed_words.astype(np.int64)))
        first = st.metrics_snapshot()
        free = pkg.models.SessionConfig(min_sigma_eff=0.0)
        for w in range(3):
            slots = st.create_sessions_batch([f"wrap{w}:{i}" for i in range(8)], free)
            st.run_governance_wave(slots, [f"did:wrap{w}:{i}" for i in range(8)], slots.copy(),
                                   np.full(8, 0.8, np.float32), np.zeros((1, 8, 16), np.uint32),
                                   now=float(w))
        second = st.metrics_snapshot()
        return (first.counter(port_metrics.WAVE_TICKS), first.counter(port_metrics.ADMITTED),
                second.counter(port_metrics.WAVE_TICKS), second.counter(port_metrics.ADMITTED),
                masked(second))

    ref, port = both(run)
    assert ref[:4] == port[:4] == (0xFFFFFFFF, 0xFFFFFFF0, 0xFFFFFFFF + 3, 0xFFFFFFF0 + 24)
    assert_snaps_equal(ref[4], port[4])


def test_gauges_fresh_after_a_wave_and_cleared_by_the_next_mutation():
    """A facade wave leaves its epilogue's gauges current (the drain skips
    its refresh); a mutation between the wave and the drain clears the
    mark, so the drain refreshes and serves the mutated tables."""

    def run(pkg, clock):
        st = pkg.state()
        free = pkg.models.SessionConfig(min_sigma_eff=0.0)
        s = st.create_session("s:fresh", free, now=0.0)
        for i in range(4):
            st.enqueue_join(s, f"did:fresh:{i}", 0.8)
        st.flush_joins(now=1.0)
        slots = st.create_sessions_batch(["w:0", "w:1"], free)
        st.run_governance_wave(slots, ["did:w0", "did:w1"], slots.copy(),
                               np.full(2, 0.8, np.float32), np.zeros((1, 2, 16), np.uint32),
                               now=2.0)
        fresh = st._gauges_fresh
        quarantined_before = st.metrics_snapshot().gauge(port_metrics.QUARANTINED)
        rows = [st.agent_row(f"did:fresh:{i}")["slot"] for i in range(2)]
        st.quarantine_rows(rows, now=3.0)
        cleared = st._gauges_fresh
        quarantined_after = st.metrics_snapshot().gauge(port_metrics.QUARANTINED)
        return fresh, cleared, quarantined_before, quarantined_after

    ref, port = both(run)
    assert ref == port == (True, False, 0.0, 2.0)


def test_fresh_gauges_skip_the_refresh(monkeypatch):
    st = PORT.state()
    free = PORT.models.SessionConfig(min_sigma_eff=0.0)
    slots = st.create_sessions_batch(["w:0"], free)
    st.run_governance_wave(slots, ["did:w0"], slots.copy(), np.full(1, 0.8, np.float32),
                           np.zeros((1, 1, 16), np.uint32), now=1.0)
    from hypervisor_tpu_torch import state as port_state

    calls = []
    monkeypatch.setattr(port_state, "_UPDATE_GAUGES", lambda *a, **k: calls.append(1))
    st.metrics_snapshot()
    assert calls == []
    st.set_agent_risk(0, 0.5)
    st.metrics_snapshot()
    assert calls == [1]


def test_drain_reads_the_device_once_and_never_inside_a_wave(monkeypatch):
    """The drain's one read (`_host_columns`) runs once per drain, and no
    wave of the sequence reads through it."""
    calls = []
    real = port_metrics._host_columns
    monkeypatch.setattr(port_metrics, "_host_columns",
                        lambda t, pinned: calls.append(1) or real(t, pinned))
    st = PORT.state()
    rich_sequence(st, PORT, 1)
    assert calls == []
    st.metrics_snapshot()
    st.metrics_prometheus()
    assert calls == [1, 1]


def test_compile_counters_count_novel_signatures():
    """ROADMAP C.2: the port has no jit cache, so its compile watch counts
    each novel abstract signature of a watched entry as one compile, and
    donation failures stay 0 (tables update in place). The drain
    publishes the process-global totals as absolute host counters."""
    calls = []
    watch = port_health.instrument("test_watch_probe", lambda x, flag=False: calls.append(x))
    base = port_health._LOG.totals()
    watch(torch.zeros(4))
    watch(torch.ones(4))                      # same signature: no compile
    watch(torch.zeros(8))                     # a new shape: a recompile
    watch(torch.zeros(8, dtype=torch.int32))  # a new dtype: a recompile
    stats = watch.stats()
    assert (stats["compiles"], stats["recompiles"], stats["signatures"]) == (3, 2, 3)
    assert stats["donation_failures"] == 0
    assert stats["last"]["changed"] == ["x: float32[8] -> int32[8]"]
    totals = port_health._LOG.totals()
    assert totals["compiles"] - base["compiles"] == 3 and len(calls) == 4
    st = PORT.state()
    snap = st.metrics_snapshot()
    assert snap.counter(port_metrics.COMPILES) == port_health._LOG.totals()["compiles"]
    assert snap.counter(port_metrics.DONATION_FAILURES) == 0
    assert st.compile_summary()["by_program"]


def test_kernel_builds_are_timed_into_compile_wall(monkeypatch):
    from hypervisor_tpu_torch.kernels import _build

    def building(x):
        _build.load_wall_ms += 12.5
        return x

    watch = port_health.instrument("test_watch_build", building)
    watch(torch.zeros(2))
    first = watch.stats()["compile_wall_ms"]
    watch(torch.zeros(2))  # a hit that ran into a build
    assert watch.stats()["compile_wall_ms"] == pytest.approx(first + 12.5, abs=1e-3)
    assert watch.stats()["compiles"] == 1


def test_stage_timer_records_only_completed_dispatches():
    m = port_metrics.Metrics(device="cpu")
    with m.stage("saga_round"):
        pass
    with pytest.raises(RuntimeError):
        with m.stage("saga_round"):
            raise RuntimeError("boom")
    n, _ = m.host_quantile(port_metrics.STAGE_LATENCY["saga_round"], 0.5)
    assert n == 1
    with pytest.raises(ValueError, match="pre-fetched drain"):
        m.snapshot(refresh=lambda t: t, host_table=m.table)


def test_prefetched_drain_equals_the_read_drain():
    m = port_metrics.Metrics(device="cpu")
    m.table.counters[0] = 7
    m.inc(port_metrics.ADMITTED, 3)
    host = type("Host", (), {f: getattr(m.table, f).numpy().copy()
                             for f in ("counters", "gauges", "hist", "hist_sum")})
    a = m.snapshot(host_table=host)
    b = m.snapshot()
    assert_snaps_equal(masked(a), masked(b))
    assert a.counter(port_metrics.WAVE_TICKS) == 7 and a.counter(port_metrics.ADMITTED) == 3


def test_module_imports_no_jax():
    import ast
    from pathlib import Path

    for mod in (port_metrics, port_health):
        tree = ast.parse(Path(mod.__file__).read_text())
        names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert not names & {"jax", "hypervisor_tpu"}, mod.__name__

