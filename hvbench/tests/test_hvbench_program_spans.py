"""`hvbench.program_spans`: the readings of the program's own spans, the
labelling of the device's idle time by program span, and one tiny cell
run through it on the CPU."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from hvbench import program_spans as ps
from hvbench.tests.conftest import REPO, SEED, make_tiny

MS = 1_000_000  # ns


def totals(spans=None, device=None, counters=None) -> dict:
    return {"spans": spans or {}, "device": device or {}, "counters": counters or {}}


#: A window of 4 calls of a facade cell: path -> (count, total ns, self ns).
FACADE = totals(
    spans={"staging": (4, 8 * MS, 8 * MS),
           "governance_wave": (4, 40 * MS, 10 * MS),
           "governance_wave/gateway_wave": (4, 12 * MS, 12 * MS),
           "governance_wave/epilogue": (4, 6 * MS, 6 * MS),
           "governance_wave/upload": (4, 2 * MS, 2 * MS),
           "governance_wave/obs.compile_key": (4, 1 * MS, 1 * MS),
           "governance_wave/obs.stamps": (4, 2 * MS, 2 * MS),
           "obs.bracket": (8, 3 * MS, 3 * MS),
           "audit_booking": (4, 20 * MS, 16 * MS),
           "audit_booking/wrap_readback": (2, 4 * MS, 4 * MS),
           "sessions_create": (4, 2 * MS, 2 * MS),
           "vouch_add": (12, 6 * MS, 6 * MS)},
    device={"governance_wave": (4, 10 * MS)},
    counters={"wrap_readback.reads": 2})
PIPELINE = totals(spans={"governance_pipeline": (4, 16 * MS, 1 * MS),
                         "governance_pipeline/consensus": (4, 2 * MS, 2 * MS)})


@pytest.mark.parametrize("name,facade,pipeline", [
    ("span_staging_ms", 2.0, None),
    ("span_dispatch_ms", (40 - 12 - 6 - 2) / 4, None),
    ("span_gateway_ms", 3.0, None),
    ("span_epilogue_ms", 1.5, None),
    ("span_upload_ms", 0.5, None),
    ("span_audit_booking_ms", 5.0, None),
    ("span_wrap_readback_ms", 1.0, None),
    ("span_client_ms", 2.0, None),      # sessions_create + vouch_add; no edge_free ran
    ("span_consensus_ms", None, 0.5),
    ("span_observability_ms", 1.5, None),
    ("wave_device_span_ms", 2.5, None),  # the mean of one wave's span
])
def test_each_reading_and_none_where_its_span_is_absent(name, facade, pipeline):
    read = ps.READERS[name]
    for window, want in ((FACADE, facade), (PIPELINE, pipeline), (totals(), None)):
        got = read(window, 4)
        assert (got is None) if want is None else got == pytest.approx(want)


def test_every_reading_is_tested():
    assert set(ps.READERS) == {
        "span_staging_ms", "span_dispatch_ms", "span_gateway_ms", "span_epilogue_ms",
        "span_upload_ms", "span_audit_booking_ms", "span_wrap_readback_ms", "span_client_ms",
        "span_consensus_ms", "span_observability_ms", "wave_device_span_ms"}


def test_a_window_is_the_difference_of_two_reads():
    before = totals({"a": (2, 10, 8), "a/b": (1, 2, 2)}, {"governance_wave": (1, 5)},
                    {"wrap_readback.reads": 3})
    after = totals({"a": (5, 40, 30), "a/b": (1, 2, 2), "c": (1, 7, 7)},
                   {"governance_wave": (3, 9)}, {"wrap_readback.reads": 3, "x": 4})
    assert ps.window(before, after) == totals({"a": (3, 30, 22), "c": (1, 7, 7)},
                                              {"governance_wave": (2, 4)}, {"x": 4})


@pytest.mark.parametrize("busy,ranges,want", [
    # No busy time, no spans: all unattributed.
    ([], [], {ps.UNATTRIBUTED: 10.0}),
    # A span over the middle; the device busy over part of it.
    ([(4, 5)], [(2, 8, "staging")], {ps.UNATTRIBUTED: 4.0, "staging": 5.0}),
    # Nested spans label by the innermost; an entry's own time is unattributed.
    ([], [(0, 10, "governance_wave"), (2, 4, "admission_wave"),
          (5, 9, "gateway_wave")], {ps.UNATTRIBUTED: 4.0, "admission_wave": 2.0,
                                    "gateway_wave": 4.0}),
    # A grandchild inside a child of the entry.
    ([(0, 1)], [(0, 10, "governance_pipeline"), (1, 6, "audit"), (2, 3, "x")],
     {ps.UNATTRIBUTED: 4.0, "audit": 4.0, "x": 1.0}),
    # Busy intervals that overlap and reach past the window.
    ([(-5, 1), (0.5, 2), (9, 20)], [(0, 10, "audit_booking")], {"audit_booking": 7.0}),
])
def test_idle_time_is_labelled_by_the_innermost_program_span(busy, ranges, want):
    got = ps.label_idle(busy, ranges, 0.0, 10.0)
    assert got == pytest.approx(want)


def test_the_unattributed_share():
    assert ps.unattributed_share({ps.UNATTRIBUTED: 1.0, "staging": 3.0}) == 25.0
    assert ps.unattributed_share({"staging": 3.0}) == 0.0
    assert ps.unattributed_share({}) is None


def test_clock_offsets_pair_ranges_with_records():
    ranges = [(100.0, 200.0, "a"), (120.0, 150.0, "b")]
    records = [(10.0, 111.0, "a"), (31.0, 60.0, "b")]
    assert ps.clock_offsets(ranges, records) == {"pairs": 2, "median": 89.5, "min": 89.0,
                                                 "p10": 89.0, "p90": 90.0, "max": 90.0}
    assert ps.clock_offsets(ranges, records[:1]) is None


@pytest.mark.parametrize("cell", ["gov10k_2m.wave32", "pipeline10k.headline"])
def test_a_tiny_cell_runs_through_it_on_the_cpu(tmp_path, cell):
    make_tiny(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "hvbench.program_spans", "--workload", cell, "--seed", str(SEED),
         "--seconds", "0.5", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["device"] == "cpu" and got["calls"] >= 1
    read = got["program_ms_per_call"]
    if cell.startswith("gov10k"):
        for name in ("span_staging_ms", "span_dispatch_ms", "span_gateway_ms",
                     "span_epilogue_ms", "span_upload_ms", "span_audit_booking_ms",
                     "span_wrap_readback_ms", "span_client_ms", "span_observability_ms"):
            assert read[name] > 0, name
        assert read["wave_device_span_ms"] is None  # no events on the CPU
        assert got["counters"]["wrap_readback.reads"] >= 1
        assert all(v is not None for v in got["twins_ms_per_call"].values())
    else:
        assert read["span_consensus_ms"] > 0 and read["span_staging_ms"] is None
    assert got["clock_offset_us"]["pairs"] >= 1
    assert got["span_cost_ns"]["span_off"] > 0
