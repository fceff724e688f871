"""The port's examples against the reference's, on the CPU.

Each example of `hypervisor_tpu_torch.examples` runs on the CPU
(`--device cpu`) and the reference's `examples/` script runs beside it
under the same ids and clock (`test_torch_facade_api.install_determinism`);
their standard output is held line for line after
`testing.compare.masked_output` masks what depends on the device or on
wall time (the card run in `chip_smoke.py` is held to its CPU rerun with
the same mask). The lines that differ by design are named here, each
with its reason. `multichip` runs on 8 CPU shards against the reference
on its 8 virtual CPU devices (`tests/conftest.py`).
"""

from __future__ import annotations

import asyncio
import contextlib
import io
import json
import re
import runpy
import sys
from pathlib import Path

import pytest
import torch
import torch._dynamo  # noqa: F401  (its lazy import would draw patched uuids)

import hypervisor_tpu as REF
import hypervisor_tpu_torch as PORT
import hypervisor_tpu_torch.examples.dashboard.app as port_app
import hypervisor_tpu_torch.examples.dashboard.web as port_web
from hypervisor_tpu_torch.examples import demo as port_demo
from hypervisor_tpu_torch.examples import hv_top as port_hv_top
from hypervisor_tpu_torch.examples import metrics_watch as port_metrics_watch
from hypervisor_tpu_torch.examples import multichip as port_multichip
from hypervisor_tpu_torch.examples import trace_watch as port_trace_watch
from hypervisor_tpu_torch.testing.compare import (
    TIMING_PANELS,
    masked_output,
    recompile_events_off,
)
from tests.test_torch_facade_api import ManualTime, install_determinism

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
#: The watchdog stays unarmed in both runs: its deadlines are each run's
#: own stage times, so a straggler (and the incident it opens) would part
#: two runs by chance. The roofline observatory is off, as in every
#: parity run: each package models its own device (ROADMAP C.2).
UNARMED = {"HV_WATCHDOG_MIN_SAMPLES": str(1 << 62), "HV_ROOFLINE": "0"}


def run_ref(script: str, argv: list[str], call=None) -> str:
    """The reference's example script, as its own tests run it (runpy,
    `sys.argv` set), stdout captured."""
    out = io.StringIO()
    saved_argv, saved_path = sys.argv, list(sys.path)
    sys.argv = [script, *argv]
    try:
        with contextlib.redirect_stdout(out):
            mod = runpy.run_path(str(EXAMPLES / script), run_name="ref_example")
            try:
                result = (call or (lambda m: m["main"]()))(mod)
                if asyncio.iscoroutine(result):
                    asyncio.run(result)
            except SystemExit as e:
                assert e.code in (0, None)
    finally:
        sys.argv, sys.path[:] = saved_argv, saved_path
    return out.getvalue()


def run_port(fn, *args) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*args)
    assert rc in (0, None)
    return out.getvalue()


def both(ref, port) -> tuple[str, str]:
    """Each side under the same ids, clock and environment, with its
    facades' `recompile` events kept off their buses (each package
    counts compiles its own way, ROADMAP C.2, and by what its process
    dispatched before)."""
    outs = []
    for side, pkg in ((ref, REF), (port, PORT)):
        with pytest.MonkeyPatch.context() as mp, recompile_events_off(pkg.core.Hypervisor):
            install_determinism(mp, ManualTime())
            for k, v in UNARMED.items():
                mp.setenv(k, v)
            outs.append(side())
    return outs[0], outs[1]


def masked(text: str, device: str = "cpu") -> list[str]:
    return masked_output(text, device_names=(device,))


# ── the output mask ──────────────────────────────────────────────────


class TestMask:
    def test_masks_clock_times_devices_and_timing_panels(self):
        text = (
            "hv_top @ 12:34:56  backend=cuda  uptime=3s\n"
            "device: NVIDIA H100 80GB HBM3\n"
            "4096/4096 done in 0.42 ms p50 (1,234.5 µs/session)\n"
            "stage latency (host bracket, µs)\n"
            "  stage  n  p50  p99\n"
            "  wave   3  1.0  2.0\n"
            "\n"
            "merkle root = 0ac16c1d, σ_eff = 0.517, 13/16 admitted\n"
            "mesh: 8 x cuda over axis 'agents' (8 shards of cuda:0)\n"
        )
        assert masked_output(text, ("NVIDIA H100 80GB HBM3", "cuda:0", "cuda")) == [
            "hv_top @ <clock>  backend=<device>  uptime=<t>",
            "device: <device>",
            "4096/4096 done in <t> p50 (<t>/session)",
            "stage latency <masked>",
            "",
            "merkle root = 0ac16c1d, σ_eff = 0.517, 13/16 admitted",
            "mesh: 8 x <device> over axis 'agents' (8 shards of <device>)",
        ]

    def test_the_same_text_on_another_device_masks_equal(self):
        card = "wave p50 3.25 ms on cuda:0\nroofline   peak=3,350 GB/s\n  wave 1 2\n"
        host = "wave p50 41.9 ms on cpu\nroofline   peak=80 GB/s\n  wave 9 9 9\n"
        assert masked_output(card, ("cuda:0",)) == masked_output(host, ("cpu",))


# ── the entry points ─────────────────────────────────────────────────


class TestEntryPoints:
    @pytest.mark.parametrize("main", [
        port_demo.main, port_multichip.main, port_metrics_watch.main,
        port_trace_watch.main, port_hv_top.main,
    ], ids=["demo", "multichip", "metrics_watch", "trace_watch", "hv_top"])
    def test_the_card_is_the_default_and_never_replaced(self, main, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default runs there")
        argv = ["--out", str(tmp_path / "t.json")] if main is port_trace_watch.main else []
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)


# ── each example against the reference's ────────────────────────────

#: The demo's lines that differ by design: the pipeline section's
#: banner (the reference jits its pipeline for its TPU; the port
#: dispatches it on the card), and the device line (a JAX device repr
#: against the torch device or the card's name).
DEMO_BANNERS = {
    "  6. TPU path: 4096 governance pipelines in one jitted tick":
        "  6. Device path: 4096 governance pipelines in one dispatch",
}


def test_demo_matches_reference():
    ref, port = both(
        lambda: run_ref("demo.py", [], call=lambda m: m["main"]()),
        lambda: run_port(port_demo.main, ["--device", "cpu"]),
    )
    ref_lines = [DEMO_BANNERS.get(line, line) for line in masked(ref)]
    port_lines = masked(port)
    for lines in (ref_lines, port_lines):
        i = next(i for i, line in enumerate(lines) if line.startswith("device: "))
        lines[i] = "device: <device>"
    assert port_lines == ref_lines
    assert "4096/4096 sessions completed the full pipeline in <t> p50 (<t>/session)" \
        in port_lines
    assert "wave: 2048/2048 lanes OK, 256/256 vouched lanes lifted to Ring 2, " \
        "256 bonds released at terminate" in port_lines
    assert port_lines[-1] == "All demos complete."


#: The fused wave's line names the port's form: a sharded wave of
#: per-shard phases and collectives, where the reference has one
#: `shard_map` program.
MULTICHIP_LINES = {
    "fused sharded wave: 16 joins into 8 sessions, full pipeline in one shard_map program, "
    "Merkle roots bit-identical to the single-device wave, all sessions archived":
    "fused sharded wave: 16 joins into 8 sessions, full pipeline in one sharded wave, "
    "Merkle roots bit-identical to the single-device wave, all sessions archived",
}


def test_multichip_matches_reference():
    """The port's mesh line is the reference's on its 8 virtual CPU
    devices; the port adds one line saying the mesh is virtual."""
    ref, port = both(
        lambda: run_ref("multichip.py", []),
        lambda: run_port(port_multichip.main, ["--device", "cpu"]),
    )
    port_lines = port.splitlines()
    assert port_lines[1] == ("  (a virtual mesh: 8 shards of cpu; the port's make_mesh never "
                             "scales down to the devices it finds)")
    assert port_lines[:1] + port_lines[2:] == [
        MULTICHIP_LINES.get(line, line) for line in ref.splitlines()]
    assert ref.splitlines()[0] == "mesh: 8 x cpu over axis 'agents'"
    assert port_lines[-1] == "multichip walkthrough complete."


def test_metrics_watch_matches_reference():
    ref, port = both(
        lambda: run_ref("metrics_watch.py", ["--sessions", "8", "--rounds", "2"]),
        lambda: run_port(port_metrics_watch.main,
                         ["--sessions", "8", "--rounds", "2", "--device", "cpu"]),
    )
    assert masked(port) == masked(ref)
    assert "  hv_governance_wave_ticks_total                      2" in port.splitlines()


def test_metrics_watch_prometheus_matches_reference():
    """The exposition without the compile series and the stage timings
    (`test_torch_metrics.prom_masked`: the compile counters count novel
    signatures in the port, ROADMAP C.2)."""
    from tests.test_torch_metrics import prom_masked

    ref, port = both(
        lambda: run_ref("metrics_watch.py", ["--sessions", "8", "--prometheus"]),
        lambda: run_port(port_metrics_watch.main,
                         ["--sessions", "8", "--prometheus", "--device", "cpu"]),
    )
    assert prom_masked(port) == prom_masked(ref)


def test_trace_watch_matches_reference(tmp_path):
    out = tmp_path / "trace.json"
    docs = []

    def kept(run):
        text = run()
        docs.append(json.loads(out.read_text()))
        return text

    ref, port = both(
        lambda: kept(lambda: run_ref("trace_watch.py", ["--sessions", "8", "--rounds", "2",
                                                        "--out", str(out)])),
        lambda: kept(lambda: run_port(port_trace_watch.main,
                                      ["--sessions", "8", "--rounds", "2", "--device", "cpu",
                                       "--out", str(out)])),
    )
    assert masked(port) == masked(ref)
    assert port.splitlines()[0] == "flight recorder: 2 reconstructed wave(s)"

    def events(doc):
        # The span tree and its names, ids and lanes; not the wall times.
        # The process is named after each package, as its tracer names
        # itself (ROADMAP C.2, the OTLP stitch).
        doc = json.loads(json.dumps(doc).replace('"hypervisor_tpu_torch"', '"hypervisor_tpu"'))
        return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                for e in doc["traceEvents"]]

    assert events(docs[1]) == events(docs[0])


#: hv_top's panels masked between the packages: the timing panels, and
#: the compile panel, which counts the port's novel signatures against
#: the reference's jit compiles (ROADMAP C.2).
HV_TOP_PANELS = TIMING_PANELS + ("compiles ",)


def _ref_hv_top_without_trajectory(mod: dict):
    """The reference's bench trajectory is its own rounds' file at the
    repo root; the port has no benchmark yet, so neither side shows one."""
    mod["main"].__globals__["load_trajectory"] = lambda root: []
    return mod["main"]()


def test_hv_top_in_process_matches_reference():
    ref, port = both(
        lambda: run_ref("hv_top.py", ["--sessions", "8"], call=_ref_hv_top_without_trajectory),
        lambda: run_port(port_hv_top.main, ["--sessions", "8", "--device", "cpu"]),
    )
    port_lines = masked_output(port, ("cpu",), panels=HV_TOP_PANELS)
    assert port_lines == masked_output(ref, ("cpu",), panels=HV_TOP_PANELS)
    assert any(line.startswith("compiles   total=") for line in port.splitlines())
    assert {"stage latency <masked>", "compiles <masked>"} <= set(port_lines)


def test_dashboard_matches_reference(capsys):
    """The simulated world through the real engines, as the terminal
    renderer prints it and as `/data.json` serves it."""
    ref_app = runpy.run_path(str(EXAMPLES / "dashboard/app.py"), run_name="ref_dashboard")
    ref_web = runpy.run_path(str(EXAMPLES / "dashboard/web.py"), run_name="ref_dashboard_web")

    def side(app, web, **kw):
        def run():
            st = asyncio.run(app["simulate"](n_sessions=3, **kw))
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                app["render_terminal"](st)
            doc = web["state_to_json"](st)
            doc.pop("generated_at")
            return out.getvalue() + json.dumps(doc, sort_keys=True)
        return run

    ref, port = both(side(ref_app, ref_web),
                     side(vars(port_app), vars(port_web), device="cpu"))
    # The panels' titles name each package; rich pads the borders to the
    # title's width.
    def same_titles(text: str) -> list[str]:
        return [re.sub("─+", "─", line) for line in
                masked(text.replace("hypervisor_tpu_torch dashboard", "hypervisor_tpu dashboard"))]

    assert same_titles(port) == same_titles(ref)
    assert '"device_stats"' in port
