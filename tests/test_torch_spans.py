"""The port's span recorder (`observability.profiling.stage_scope`), on the CPU.

One primitive times every named region: the wave's phases, the
`Metrics.stage` brackets (which add their histogram sample), the state's
staging, booking and client calls, the headline pipeline's phases and
the telemetry's own `obs.*` cost. These cases hold what the recorder
keeps (paths, parents, self time, totals across threads, the ring's
bound, the wrap read-back's counters), what it feeds (the flight
recorder's measured stage times, the roofline join's device spans, the
exporters) and where it must add nothing (the stage histograms).
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest
import torch

from hypervisor_tpu_torch.config import HypervisorConfig, TableCapacity
from hypervisor_tpu_torch.models import SessionConfig
from hypervisor_tpu_torch.observability import metrics as port_mp
from hypervisor_tpu_torch.observability import profiling, roofline, tracing
from hypervisor_tpu_torch.ops import pipeline
from hypervisor_tpu_torch.state import HypervisorState
from tests.test_torch_roofline import cost, fresh, roofline_gauges, seeded, walls  # noqa: F401

#: A phase slowed by this much stands out of the run-to-run change of
#: any unslowed phase of a small CPU wave, whatever the machine's load.
SLOW_S = 1.0


@pytest.fixture(autouse=True)
def clean_recorder():
    """Each case reads a recorder holding its own spans only."""
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def small_state(delta_log_capacity: int = 512) -> HypervisorState:
    cap = TableCapacity(max_agents=256, max_sessions=256, max_vouch_edges=64, max_sagas=8,
                        delta_log_capacity=delta_log_capacity, event_log_capacity=64,
                        trace_log_capacity=256)
    return HypervisorState(HypervisorConfig(capacity=cap), device="cpu")


def facade_wave(st, rnd: int, lanes: int = 8, turns: int = 2):
    slots = st.create_sessions_batch([f"span:r{rnd}:{i}" for i in range(lanes)],
                                     SessionConfig(min_sigma_eff=0.0))
    return st.run_governance_wave(
        slots, [f"did:span:r{rnd}:{i}" for i in range(lanes)], slots.copy(),
        np.full(lanes, 0.8, np.float32), np.zeros((turns, lanes, 16), np.uint32), float(rnd),
        pad_to=(16, 16))


def totals():
    return profiling.span_totals()["spans"]


# ── what a span keeps ────────────────────────────────────────────────


def test_paths_parents_and_self_time():
    with profiling.stage_scope("outer") as outer:
        time.sleep(0.01)
        with profiling.stage_scope("a") as a:
            time.sleep(0.02)
        with profiling.stage_scope("b") as b:
            with profiling.stage_scope("c") as c:
                time.sleep(0.01)
    got = totals()
    assert set(got) == {"outer", "outer/a", "outer/b", "outer/b/c"}
    assert got["outer"] == (1, outer.ns, outer.ns - a.ns - b.ns)
    assert got["outer/b"] == (1, b.ns, b.ns - c.ns)
    assert got["outer/a"] == (1, a.ns, a.ns) and got["outer/b/c"] == (1, c.ns, c.ns)
    assert got["outer"][2] >= 0.009e9
    (root,) = profiling.span_trees()
    assert root.name == "hv.outer" and root.parent_span_word is None
    assert [s.stage for s in root.children] == ["a", "b"]
    assert root.children[1].children[0].parent_span_word == root.children[1].span_word
    assert all(s.wave_seq == -1 for s in root.walk())


@pytest.mark.parametrize("threads", [1, 4, 16])
def test_totals_add_up_across_threads(threads):
    n = 200
    barrier = threading.Barrier(threads)

    def work():
        barrier.wait(timeout=30)
        for _ in range(n):
            with profiling.stage_scope("thread_work"):
                with profiling.stage_scope("inner"):
                    pass

    pool = [threading.Thread(target=work) for _ in range(threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    got = totals()
    assert set(got) == {"thread_work", "thread_work/inner"}
    assert got["thread_work"][0] == got["thread_work/inner"][0] == threads * n
    assert got["thread_work"][1] == got["thread_work"][2] + got["thread_work/inner"][1]


def test_the_ring_is_bounded_and_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(profiling, "_ring", profiling.deque(maxlen=8))
    for i in range(20):
        with profiling.stage_scope(f"s{i}"):
            pass
    roots = profiling.span_trees()
    assert [s.stage for s in roots] == [f"s{i}" for i in range(12, 20)]
    assert totals()["s0"][0] == 1  # totals outlive the ring


def test_a_raising_span_still_records_and_unwinds():
    with pytest.raises(ValueError):
        with profiling.stage_scope("raises"):
            with profiling.stage_scope("inner"):
                raise ValueError("x")
    assert profiling.current_stage() is None
    assert totals()["raises"][0] == totals()["raises/inner"][0] == 1


@pytest.mark.parametrize("scope,samples", [("stage_scope", 0), ("Metrics.stage", 1)])
def test_only_the_stage_brackets_sample_the_histogram(scope, samples):
    m = port_mp.Metrics(device="cpu")
    handle = port_mp.STAGE_LATENCY["admission_wave"]
    before = m.snapshot().hist_count(handle)
    opened = (profiling.stage_scope("admission_wave") if scope == "stage_scope"
              else m.stage("admission_wave"))
    with opened:
        time.sleep(0.002)
    assert m.snapshot().hist_count(handle) - before == samples
    assert totals()["admission_wave"][0] == 1


def test_a_wave_adds_no_stage_sample_from_its_phase_scopes():
    """The fused wave's phases (`admission_wave`, `delta_chain`, ...)
    are spans inside its bracket: the wave books one sample, under
    `governance_wave`, as before."""
    st = small_state()
    snap = st.metrics.snapshot()
    counts = {s: snap.hist_count(h) for s, h in port_mp.STAGE_LATENCY.items()}
    facade_wave(st, 0)
    snap = st.metrics.snapshot()
    moved = {s: snap.hist_count(h) - counts[s] for s, h in port_mp.STAGE_LATENCY.items()}
    assert {s: n for s, n in moved.items() if n} == {"governance_wave": 1}
    got = totals()
    for phase in ("admission_wave", "session_fsm", "delta_chain", "epilogue"):
        assert got[f"governance_wave/{phase}"][0] == 1, phase
    for path in ("staging", "audit_booking", "sessions_create", "obs.bracket",
                 "governance_wave/upload", "governance_wave/obs.compile_key",
                 "governance_wave/obs.stamps"):
        assert got[path][0] >= 1, path


# ── the dispatch bracket at every site ───────────────────────────────


def _members(st, tag: str, n: int = 4):
    """A session with `n` admitted members: (session slot, agent rows)."""
    s = st.create_session(f"site:{tag}", SessionConfig(min_sigma_eff=0.0), now=1.0)
    dids = [f"did:site:{tag}:{i}" for i in range(n)]
    for did in dids:
        st.enqueue_join(s, did, 0.8)
    st.flush_joins(now=1.0)
    return s, [st.agent_row(did)["slot"] for did in dids]


def _wave_call(st, tag: str, mesh=None):
    slots = st.create_sessions_batch([f"site:{tag}:{i}" for i in range(8)],
                                     SessionConfig(min_sigma_eff=0.0))
    kw = {"pad_to": (16, 16)} if mesh is None else {"mesh": mesh}
    return lambda: st.run_governance_wave(
        slots, [f"did:site:{tag}:w{i}" for i in range(8)], slots.copy(),
        np.full(8, 0.8, np.float32), np.zeros((2, 8, 16), np.uint32), 2.0, **kw)


def _joins_call(st, tag: str):
    s = st.create_session(f"site:{tag}", SessionConfig(min_sigma_eff=0.0), now=1.0)
    for i in range(3):
        st.enqueue_join(s, f"did:site:{tag}:{i}", 0.8)
    return lambda: st.flush_joins(now=2.0)


def _deltas_call(st, tag: str):
    s, rows = _members(st, tag)
    for k, row in enumerate(rows[:3]):
        st.stage_delta(s, row, ts=2.0 + k, change_words=np.arange(3 + k, dtype=np.uint32))
    return st.flush_deltas


def _terminate_call(st, tag: str):
    s, _ = _members(st, tag)
    return lambda: st.terminate_sessions([s], now=3.0)


def _slash_call(st, tag: str):
    s, rows = _members(st, tag)
    st.add_vouch(rows[0], rows[1], s, bond=0.125)
    return lambda: st.apply_slash(s, rows[1], 0.5, now=3.0)


def _saga_call(st, tag: str):
    s, _ = _members(st, tag)
    g = st.create_saga(f"saga:{tag}", s, [{"retries": 1, "has_undo": True}, {}])
    return lambda: st.saga_round({g: True})


def _gateway_call(st, tag: str, mesh=None):
    _, rows = _members(st, tag)
    return lambda: st.check_actions_wave(rows, [2, 1, 0, 2], [False, True, False, False],
                                         [False] * 4, [False] * 4, [False] * 4, now=3.0,
                                         mesh=mesh)


def _mesh():
    import hypervisor_tpu_torch.parallel as par

    return par.make_mesh(4, platform="cpu")


#: stage -> (prepare(state, tag) -> the one dispatching call, its stamps' plane)
SITES = {
    "governance_wave": (_wave_call, "device"),
    "governance_wave_sharded": (lambda st, tag: _wave_call(st, tag, mesh=_mesh()), "host"),
    "admission_wave": (_joins_call, "device"),
    "delta_chain": (_deltas_call, "host"),
    "terminate_wave": (_terminate_call, "host"),
    "slash_cascade": (_slash_call, "device"),
    "saga_round": (_saga_call, "device"),
    "gateway_wave": (_gateway_call, "device"),
    "gateway_wave_sharded": (lambda st, tag: _gateway_call(st, tag, mesh=_mesh()), "host"),
}


@pytest.mark.parametrize("traced", [True, False], ids=["traced", "HV_TRACE=0"])
@pytest.mark.parametrize("stage", list(SITES))
def test_every_dispatch_site_records_one_bracket(monkeypatch, stage, traced):
    """Each of the state's dispatches goes through one `Tracer.dispatch`:
    one wave record of its stage, holding the stage's own span, one
    latency sample, its stamps (in the ring, or mirrored on the host) and
    `last_closed`. With the plane off the sample is still taken."""
    if not traced:
        monkeypatch.setenv("HV_TRACE", "0")
    st = small_state()
    prepare, plane = SITES[stage]
    call = prepare(st, stage)
    tr = st.tracer
    handle = port_mp.STAGE_LATENCY[stage]
    samples = st.metrics.snapshot().hist_count(handle)
    seqs, cursor, host_rows = set(tr._waves), tr.cursor, len(tr._host_rows)
    ring = None if tr.table is None else int(tr.table.cursor)
    call()
    assert st.metrics.snapshot().hist_count(handle) - samples == 1
    if not traced:
        assert tr.table is None and not tr._waves and tr.last_closed is None
        return
    new = [r for seq, r in tr._waves.items() if seq not in seqs and r.stage == stage]
    assert len(new) == 1, [r.stage for r in new]
    (record,) = new
    assert record.mode == plane and stage in record.phases
    assert tr.last_closed is record
    assert record.t0_us < record.t1_us
    stamps = tracing.stamp_count(stage)
    if plane == "device":
        assert (tr.cursor - cursor, int(tr.table.cursor) - ring) == (stamps, stamps)
        assert len(tr._host_rows) == host_rows
    else:
        assert (tr.cursor, int(tr.table.cursor)) == (cursor, ring)
        assert len(tr._host_rows) - host_rows == stamps


# ── the flight recorder's measured times ─────────────────────────────


def _slow(fn):
    def call(*args, **kwargs):
        time.sleep(SLOW_S)
        return fn(*args, **kwargs)
    return call


@pytest.mark.parametrize("phase,block", [("admission_wave", "admission"),
                                         ("session_fsm", "fsm_saga"),
                                         ("delta_chain", "chain_ring")])
def test_a_slowed_phase_shows_its_own_measured_time(monkeypatch, phase, block):
    st = small_state()
    facade_wave(st, 0)  # first dispatch: the signature's count
    facade_wave(st, 1)
    blocks = pipeline.KERNEL_BLOCKS
    monkeypatch.setattr(pipeline, "KERNEL_BLOCKS",
                        blocks._replace(**{block: _slow(getattr(blocks, block))}))
    facade_wave(st, 2)
    base, root = st.tracer.drain()[-2:]
    before = {c.stage: c.end_us - c.start_us for c in base.children}
    durations = {c.stage: c.end_us - c.start_us for c in root.children}
    assert set(durations) == set(tracing.WAVE_CHILD_STAGES["governance_wave"])
    for stage, us in durations.items():
        if stage == phase:
            assert us >= SLOW_S * 1e6, (stage, us)
        else:
            assert abs(us - before[stage]) < SLOW_S * 1e6 / 2, (stage, us, before[stage])
    # B5's saga step and terminate walk have no span of their own: marks
    # at the end of `session_fsm`, whose interval holds their time.
    by_stage = {c.stage: c for c in root.children}
    for stage in ("saga_round", "terminate_wave"):
        assert by_stage[stage].start_us == by_stage[stage].end_us == by_stage[
            "session_fsm"].end_us
    for child in root.children:
        assert root.start_us <= child.start_us <= child.end_us <= root.end_us, child.stage
    # The children do not overlap: each measured phase runs after the last.
    ends = sorted((c.start_us, c.end_us) for c in root.children)
    assert all(a1 <= b0 for (_, a1), (b0, _) in zip(ends, ends[1:])), ends


def _shares_of(root) -> dict:
    """What `attribution.wave_phase_shares` should give for one wave:
    each phase's children's measured time over the bracket, and the rest
    of the bracket on `epilogue`."""
    from hypervisor_tpu_torch.observability.attribution import HV_PHASES, WAVE_PHASE_OF

    wall = root.end_us - root.start_us
    want = dict.fromkeys(HV_PHASES, 0.0)
    for c in root.children:
        want[WAVE_PHASE_OF[c.stage]] += (c.end_us - c.start_us) / wall
    want["epilogue"] += 1.0 - sum(want.values())
    return want


def test_phase_shares_count_each_measured_phase_once(monkeypatch):
    """On the real clock, a `session_fsm` slowed by `SLOW_S` takes its
    own span's share of the bracket as `fsm_saga` (once, though three
    stamps map there), and `epilogue` takes the rest of the bracket."""
    from hypervisor_tpu_torch.observability import attribution

    st = small_state()
    facade_wave(st, 0)
    blocks = pipeline.KERNEL_BLOCKS
    monkeypatch.setattr(pipeline, "KERNEL_BLOCKS",
                        blocks._replace(fsm_saga=_slow(blocks.fsm_saga)))
    facade_wave(st, 1)
    root = st.tracer.drain()[-1]
    fsm = next(c for c in root.children if c.stage == "session_fsm")
    wall = root.end_us - root.start_us
    shares = attribution.wave_phase_shares(st.tracer, last=1)
    assert shares["fsm_saga"] == pytest.approx((fsm.end_us - fsm.start_us) / wall, abs=1e-5)
    assert shares["fsm_saga"] >= SLOW_S * 1e6 / wall
    covered = sum(c.end_us - c.start_us for c in root.children)
    assert 0.0 < covered < wall
    assert shares["epilogue"] == pytest.approx(1.0 - covered / wall, abs=1e-5)
    assert shares == pytest.approx(_shares_of(root), abs=1e-5)


def test_a_replaced_tracer_clock_keeps_each_phase_at_its_measured_share(monkeypatch):
    """A tracer module on a clock of its own (a deterministic test's,
    which steps 1 ms a read) still places each child at its span's
    measured share of the bracket: the bracket's edges and the children
    are read once each, on the recorder's clock, so the record's times
    are those readings."""
    from hypervisor_tpu_torch.observability import attribution
    from tests.test_torch_serving import FakeClock

    monkeypatch.setattr(tracing, "time", FakeClock())
    st = small_state()
    facade_wave(st, 0)
    (root,) = st.tracer.drain()[-1:]
    record = st.tracer.last_closed
    assert record.stage == "governance_wave" and root.wave_seq == record.wave_seq
    ns0, ns1 = record.bracket_ns
    # One clock: the record's bracket is the recorder's two readings.
    assert record.t1_us - record.t0_us == pytest.approx((ns1 - ns0) / 1e3, abs=1e-3)
    assert (root.start_us, root.end_us) == (record.t0_us, record.t1_us)
    for child in root.children:
        if child.end_us > child.start_us:
            a, b = record.phases[child.stage]
            assert (child.end_us - child.start_us) / (root.end_us - root.start_us) == \
                pytest.approx((b - a) / (ns1 - ns0), rel=1e-9), child.stage
    assert attribution.wave_phase_shares(st.tracer, last=1) == pytest.approx(
        _shares_of(root), abs=1e-5)


def test_the_mesh_wave_times_each_phase():
    """The sharded wave runs each phase over every shard in one span: its
    host-mirrored children are measured, one after another, and the
    bracket's rest is the only `epilogue`."""
    import hypervisor_tpu_torch.parallel as par

    st = small_state()
    slots = st.create_sessions_batch([f"span:m{i}" for i in range(8)],
                                     SessionConfig(min_sigma_eff=0.0))
    st.run_governance_wave(slots, [f"did:span:m{i}" for i in range(8)], slots.copy(),
                           np.full(8, 0.8, np.float32), np.zeros((1, 8, 16), np.uint32), 1.0,
                           mesh=par.make_mesh(4, platform="cpu"))
    root = [s for s in st.tracer.drain() if s.stage == "governance_wave_sharded"][-1]
    assert [c.stage for c in root.children] == list(
        tracing.WAVE_CHILD_STAGES["governance_wave_sharded"])
    record = st.tracer._waves[root.wave_seq]
    assert set(tracing.WAVE_CHILD_STAGES["governance_wave_sharded"]) <= set(record.phases)
    ends = [(c.start_us, c.end_us) for c in root.children]
    assert all(a0 < a1 for a0, a1 in ends), ends
    assert all(a1 <= b0 for (_, a1), (b0, _) in zip(ends, ends[1:])), ends
    assert root.start_us <= ends[0][0] and ends[-1][1] <= root.end_us
    got = totals()
    for phase in tracing.WAVE_CHILD_STAGES["governance_wave_sharded"]:
        assert got[f"governance_wave_sharded/{phase}"][0] == 1, phase


def test_a_child_without_a_span_is_a_zero_width_mark():
    """A host-mirrored wave whose phases ran in no span gets no made-up
    times: each child is a mark at the root's start."""
    tr = tracing.Tracer(device="cpu")
    h = tr.begin_wave("governance_wave_sharded", sessions=[1, 2], lanes=2, device=False)
    time.sleep(0.01)
    tr.stamp_wave_host(h)
    tr.end_wave(h)
    (root,) = tr.drain()
    assert root.end_us - root.start_us >= 0.009e6
    assert len(root.children) == len(tracing.WAVE_CHILD_STAGES["governance_wave_sharded"])
    assert all(c.start_us == c.end_us == root.start_us for c in root.children)


def test_brackets_tag_their_spans_and_close():
    tr = tracing.Tracer(device="cpu")
    h = tr.begin_wave("admission_wave", lanes=1, device=False)
    with profiling.stage_scope("admission_wave"):
        pass
    tr.end_wave(h)
    with profiling.stage_scope("after"):
        pass
    assert set(h.record.phases) == {"obs.bracket", "admission_wave"}
    by_stage = {s.stage: s for s in profiling.span_trees()}
    assert by_stage["admission_wave"].wave_seq == h.record.wave_seq
    assert by_stage["after"].wave_seq == -1


# ── the wrap read-back ───────────────────────────────────────────────


def test_the_wrap_read_back_is_timed_and_counted():
    """Each read fetches one int32 state per recycled session, not the
    whole session-state column."""
    st = small_state(delta_log_capacity=64)
    for rnd in range(6):  # 16 records a wave: the fifth wave wraps the ring
        facade_wave(st, rnd)
    snap = profiling.span_totals()
    reads = snap["counters"].get("wrap_readback.reads", 0)
    assert reads >= 1
    # Waves 4 and 5 each recycle the rows of one earlier wave's 8 sessions.
    assert reads == 2
    column = st.sessions.i32[:, 0]
    assert snap["counters"]["wrap_readback.bytes"] == 4 * (8 + 8)
    assert snap["counters"]["wrap_readback.bytes"] < reads * column.numel() * column.element_size()
    assert snap["spans"]["audit_booking/wrap_readback"][0] == reads


# ── the roofline join ────────────────────────────────────────────────


class FakeEvent:
    def __init__(self, t_ms: float, done: bool = True) -> None:
        self.t_ms, self.done = t_ms, done

    def query(self) -> bool:
        return self.done

    def elapsed_time(self, end: "FakeEvent") -> float:
        return end.t_ms - self.t_ms


def test_resolution_reads_only_what_the_device_passed():
    for t0, t1, done in ((0.0, 0.5, True), (1.0, 1.7, True), (2.0, 2.25, False),
                         (3.0, 3.1, True)):
        profiling._dev_pending.append(("governance_wave", FakeEvent(t0), FakeEvent(t1, done)))
    assert profiling.resolve_device_spans() == 2  # stops at the first the device has not passed
    assert profiling.span_totals()["device"] == {"governance_wave": (2, 1_200_000)}
    assert profiling.device_span_quantile("governance_wave", 0.5) == (2, 700.0)
    assert profiling.device_span_quantile("other", 0.5) == (0, 0.0)
    assert len(profiling._dev_pending) == 2


def test_a_cpu_device_span_records_nothing():
    with profiling.device_span("governance_wave", torch.device("cpu")) as span:
        assert span.pair is None
    assert not profiling._dev_pending and profiling.resolve_device_spans() == 0


@pytest.mark.parametrize("device_spans,wall",
                         [((), None), ((0.5,), None), ((0.6, 0.6, 0.6), 600.0)])
def test_the_roofline_join_divides_by_the_device_span(fresh, device_spans, wall):
    """With enough resolved device spans (`HV_ROOFLINE_MIN_SAMPLES`) the
    wave's measured wall is their p50; with fewer, the host plane's."""
    _, port_reg = fresh
    m = port_mp.Metrics(device="cpu")
    entry = cost(roofline, int_ops=0.0)
    seeded(port_reg, roofline, entry)
    walls(m, port_mp)
    host_wall = roofline._measured_wall_us(m, "governance_wave")
    for i, ms in enumerate(device_spans):
        profiling._dev_pending.append(("governance_wave", FakeEvent(10.0 * i),
                                       FakeEvent(10.0 * i + ms)))
    profiling.resolve_device_spans()
    got = roofline._measured_wall_us(m, "governance_wave")
    assert got == (host_wall if wall is None else wall)
    roofline.publish(m)
    gauges = roofline_gauges(m.snapshot(), port_mp)
    bw = float(roofline.peak_rates("cpu")["peak_bw_bytes_s"])
    want = entry.bytes_accessed / (got / 1e6) / bw
    assert gauges[("bw", "governance_wave")] == pytest.approx(want)


# ── the profiler's clock and the exporters ───────────────────────────


def test_profiler_ranges_match_the_records_within_one_offset():
    from torch.profiler import ProfilerActivity, profile

    gap_s, tolerance_us = 0.03, 10_000.0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm"):
            pass
        with profiling.stage_scope("p_outer"):
            time.sleep(gap_s)
            with profiling.stage_scope("p_a"):
                time.sleep(gap_s)
            time.sleep(gap_s)
            with profiling.stage_scope("p_b"):
                time.sleep(gap_s)
                with profiling.stage_scope("p_c"):
                    time.sleep(gap_s)
    ranges = sorted((e.time_range.start, e.time_range.end, e.name[3:]) for e in prof.events()
                    if e.name.startswith("hv.p_"))
    records = sorted((s.start_us, s.end_us, s.stage, s.parent_span_word, s.span_word)
                     for root in profiling.span_trees() for s in root.walk())
    assert [r[2] for r in ranges] == [r[2] for r in records] == ["p_outer", "p_a", "p_b", "p_c"]
    words = {r[4]: r[2] for r in records}
    assert [words.get(r[3]) for r in records] == [None, "p_outer", "p_outer", "p_b"]
    offsets = [a - b for (a0, a1, _), (b0, b1, *_) in zip(ranges, records) for a, b in
               ((a0, b0), (a1, b1))]
    median = float(np.median(offsets))
    assert max(abs(o - median) for o in offsets) < tolerance_us, offsets


@pytest.mark.parametrize("exporter", [tracing.to_chrome_trace, tracing.to_otlp])
def test_the_ring_exports_through_the_flight_recorders_exporters(exporter):
    with profiling.stage_scope("e_outer"):
        with profiling.stage_scope("e_inner"):
            pass
    out = exporter(profiling.span_trees())
    text = repr(out)
    assert "hv.e_outer" in text and "hv.e_inner" in text
