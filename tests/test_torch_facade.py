"""The port's facade against the reference's, end to end, on the CPU.

One seeded sequence runs on the JAX package's `HypervisorState` (unarmed:
`HV_WAVE_PALLAS=0`, `HV_SHA256_PALLAS=0`) and on the port's
`HypervisorState(device="cpu")`:

  * three lifecycle waves through `run_governance_wave`, vouched lanes
    placed toward the rows each wave will claim (fresh rows, then rows
    popped off the free list), the second wave crowded (a capacity
    refusal) and padded to a bucket, the third wrapping the DeltaLog
    ring over the first wave's archived sessions and the trace ring
    over its oldest stamps;
  * standing sessions with members, `stage_delta` + `flush_deltas`
    (one explicit leaf digest), which evicts more archived rows;
  * `verify_session_chain` on full and wrap-truncated histories;
  * `MerkleScrubber` sweeps, before and after one digest bit is flipped
    on both sides;
  * `terminate_sessions` with frontier roots, a recomputed root, member
    reclaim and the dangling-edge scrub;
  * the refusal to wrap the ring into a live session.

A second sequence books leaves onto sessions that already hold some: a
wave on six sessions, a second wave on the same six (each frontier
carried), a wave on six others that wraps the DeltaLog over the first
six's oldest rows (their frontiers evicted), a wave on the first six
again (five frontiers built anew from the wave's leaves, one carried) and
their termination (roots recomputed from the recorded leaves).

Held equal bit for bit after every step: every `WaveResult` field; the
agents, sessions and vouches tables; the DeltaLog; the whole metrics
table (counters, the gauges the wave's epilogue refreshes, histograms
and their sums); the TraceLog words; the host
audit index, frontier stacks and roots, ring-row ownership, free lists and
membership keys; the scrubber reports, the verify verdicts and the
roots. Trace ids are made deterministic by patching `secrets.token_hex`.
"""

from __future__ import annotations

import itertools
import secrets
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervisor_tpu import config as jax_config
from hypervisor_tpu import models as jax_models
from hypervisor_tpu.integrity.scrubber import MerkleScrubber as JaxScrubber
from hypervisor_tpu.runtime.checkpoint import state_arrays
from hypervisor_tpu.state import HypervisorState as JaxState
from hypervisor_tpu.tables.struct import replace as jax_replace
from hypervisor_tpu_torch import config as port_config
from hypervisor_tpu_torch import models as port_models
from hypervisor_tpu_torch import tables as port_tables
from hypervisor_tpu_torch import u32
from hypervisor_tpu_torch.integrity.scrubber import MerkleScrubber
from hypervisor_tpu_torch.state import HypervisorState as PortState
from hypervisor_tpu_torch.tables.state import AI32_DID, AI32_FLAGS, AI32_SESSION, SI32_NPART

K, T = 6, 3
CAP = dict(max_agents=16, max_sessions=40, max_vouch_edges=32, delta_log_capacity=40,
           trace_log_capacity=32)
BUDGET = 16
#: Agent rows each wave's first two lanes claim: fresh rows for waves 1
#: and 2 (wave 2 is padded to 10 lanes), rows popped off the free list's
#: end for wave 3.
VOUCHED_ROWS = ([0, 1], [6, 7], [15, 14])
_TABLES = ("agents", "sessions", "vouches", "delta_log")
_METRICS = ("counters", "gauges", "hist", "hist_sum", "bounds")
_WAVE_FIELDS = ("status", "ring", "sigma_eff", "saga_step_state", "fsm_error")


class _Ref:
    """The sequence's operations on the JAX package's state."""

    def __init__(self):
        self.st = JaxState(jax_config.HypervisorConfig(capacity=jax_config.TableCapacity(
            **CAP, max_sagas=8, max_steps_per_saga=4, max_elevations=8, event_log_capacity=16,
        )))
        self.scrubber = JaxScrubber(self.st, budget=BUDGET, use_pallas=False)

    def session_config(self, **kw):
        return jax_models.SessionConfig(**kw)

    def place_edges(self, rows, voucher, vouchee, session, bond, expiry):
        v, e = self.st.vouches, jnp.asarray(rows)
        self.st.vouches = jax_replace(
            v, voucher=v.voucher.at[e].set(voucher), vouchee=v.vouchee.at[e].set(vouchee),
            session=v.session.at[e].set(session), bond=v.bond.at[e].set(bond),
            bond_pct=v.bond_pct.at[e].set(0.2), active=v.active.at[e].set(True),
            expiry=v.expiry.at[e].set(expiry),
        )

    def place_member(self, row, did, session):
        a, s = self.st.agents, self.st.sessions
        self.st.agents = jax_replace(a, did=a.did.at[row].set(did),
                                     session=a.session.at[row].set(session),
                                     flags=a.flags.at[row].set(1))
        self.st.sessions = jax_replace(
            s, n_participants=s.n_participants.at[session].add(1))

    def flip_digest_bit(self, row):
        d = self.st.delta_log
        self.st.delta_log = jax_replace(d, digest=d.digest.at[row, 0].set(d.digest[row, 0] ^ 1))

    def wave_result(self, res):
        out = {f: np.asarray(getattr(res, f)) for f in _WAVE_FIELDS}
        out["chain"] = np.asarray(res.chain)
        out["merkle_root"] = np.asarray(res.merkle_root)
        out["released"] = int(np.asarray(res.released))
        return out

    def snapshot(self):
        arrays = state_arrays(self.st)
        out = {k: v for k, v in arrays.items() if k.split(".")[0] in _TABLES}
        for c in _METRICS:
            out[f"metrics.{c}"] = np.array(getattr(self.st.metrics.table, c))
        out["trace.words"] = np.array(self.st.tracer.table.words)
        out["trace.cursor"] = np.array(self.st.tracer.table.cursor)
        return out


class _Port(_Ref):
    """The same operations on the port's state, on the CPU."""

    def __init__(self):
        self.st = PortState(port_config.HypervisorConfig(
            capacity=port_config.TableCapacity(**CAP)), device="cpu")
        self.scrubber = MerkleScrubber(self.st, budget=BUDGET)

    def session_config(self, **kw):
        return port_models.SessionConfig(**kw)

    def place_edges(self, rows, voucher, vouchee, session, bond, expiry):
        v, e = self.st.vouches, torch.tensor(rows)
        for col, val in (("voucher", voucher), ("vouchee", vouchee), ("session", session),
                         ("bond", bond), ("bond_pct", 0.2), ("active", True), ("expiry", expiry)):
            getattr(v, col)[e] = torch.as_tensor(np.asarray(val)).to(getattr(v, col).dtype)

    def place_member(self, row, did, session):
        a = self.st.agents.i32[row]
        a[AI32_DID], a[AI32_SESSION], a[AI32_FLAGS] = did, session, 1
        self.st.sessions.i32[session, SI32_NPART] += 1

    def flip_digest_bit(self, row):
        self.st.delta_log.digest[row, 0] ^= 1

    def wave_result(self, res):
        out = {f: getattr(res, f).numpy().copy() for f in _WAVE_FIELDS}
        out["chain"] = u32.to_numpy_u32(res.chain)
        out["merkle_root"] = u32.to_numpy_u32(res.merkle_root)
        out["released"] = int(res.released)
        return out

    def snapshot(self):
        st = self.st
        out = port_tables.to_state_arrays(port_tables.StateTables(
            st.agents, st.sessions, st.vouches, delta_log=st.delta_log))
        for c in _METRICS:
            a = getattr(st.metrics.table, c).numpy().copy()
            out[f"metrics.{c}"] = a.view(np.uint32) if c in ("counters", "hist") else a.copy()
        out["trace.words"] = st.tracer.table.words.numpy().view(np.uint32).copy()
        out["trace.cursor"] = st.tracer.table.cursor.numpy().copy()
        return out


def _host_state(st) -> dict:
    return {
        "audit_rows": {s: list(r) for s, r in st._audit_rows.items()},
        "turns": dict(st._turns),
        "chain_seed": {s: np.asarray(v, np.uint32).tolist() for s, v in st._chain_seed.items()},
        "frontier": {s: (f.count, f.hash_count, f.to_meta()["nodes"], f.root_hex())
                     for s, f in st._frontier.items()},
        "row_session": st._row_session.tolist(),
        "free_agent_slots": list(st._free_agent_slots),
        "free_edge_slots": list(st._free_edge_slots),
        "scrubbed_edges": list(st._scrubbed_edges),
        "members": sorted(st._members),
        "cursors": (st._next_agent_slot, st._next_session_slot),
    }


def _run(side) -> list[tuple[str, object]]:
    """The sequence; every step records what both sides must agree on."""
    log: list[tuple[str, object]] = []
    st = side.st

    def record(label, value=None):
        log.append((label, value))
        log.append((label + ":tables", side.snapshot()))
        log.append((label + ":host", _host_state(st)))

    rng = np.random.RandomState(20)
    edge = 0
    for w in range(3):
        slots = st.create_sessions_batch(
            [f"w{w}:s{i}" for i in range(K)],
            side.session_config(min_sigma_eff=0.55, max_participants=1),
        )
        lane_sessions = np.concatenate([slots, slots[:1]]) if w == 1 else slots
        b = len(lane_sessions)
        rows = VOUCHED_ROWS[w]
        # Two vouchers on lane 0, one on lane 1, one expired edge on lane 1.
        side.place_edges(
            list(range(edge, edge + 4)), voucher=np.arange(4) + 2 * w, vouchee=[rows[0], rows[0],
            rows[1], rows[1]], session=[slots[0], slots[0], slots[1], slots[1]],
            bond=rng.uniform(0.05, 0.3, 4).astype(np.float32),
            expiry=np.array([np.inf, np.inf, np.inf, 1.0], np.float32),
        )
        edge += 4
        sigma = rng.uniform(0.3, 1.0, b).astype(np.float32)
        sigma[0] = 0.45  # lifted over the ring-2 threshold by its vouchers
        trust = rng.uniform(size=b) > 0.15
        trust[0] = True
        bodies = rng.randint(0, 2**32, (T, K, 16), dtype=np.uint64).astype(np.uint32)
        res = st.run_governance_wave(
            slots, [f"did:{w}:{i}" for i in range(b)], lane_sessions, sigma, bodies,
            now=10.0 + w, omega=0.5, trustworthy=trust,
            pad_to=(10, 8) if w == 1 else None,
        )
        record(f"wave{w}", side.wave_result(res))

    # Standing sessions: two members in s_a, a bond inside s_a and a bond
    # in s_c that names a member (dangling once s_a terminates).
    cfg = side.session_config(min_sigma_eff=0.5)
    s_a, s_b, s_c = (st.create_session(f"stand:{i}", cfg, now=13.0) for i in range(3))
    members = [st._free_agent_slots.pop() for _ in range(2)]
    for i, row in enumerate(members):
        side.place_member(row, 900 + i, s_a)
    side.place_edges([30, 31], voucher=[members[1], members[0]], vouchee=[members[0], 3],
                     session=[s_a, s_c], bond=np.array([0.1, 0.2], np.float32),
                     expiry=np.full(2, np.inf, np.float32))
    for turn in range(3):
        st.stage_delta(s_a, members[0], ts=1.0 + turn, change_words=rng.randint(0, 2**31, 8))
    st.stage_delta(s_b, 0, ts=2.5, change_words=[7, 8])
    st.stage_delta(s_b, 0, ts=3.5, digest_words=rng.randint(0, 2**31, 8).astype(np.uint32))
    st.stage_delta(s_c, 1, ts=4.0)
    record("flush1", st.flush_deltas())
    for turn in range(2):
        st.stage_delta(s_a, members[1], ts=5.0 + turn, change_words=rng.randint(0, 2**31, 8))
    record("flush2", st.flush_deltas())

    truncated = 7  # wave 2's second session: the ring kept 2 of its 3 rows
    assert st._turns[truncated] == 3 and len(st._audit_rows[truncated]) == 2
    assert truncated not in st._frontier
    log.append(("verify", [st.verify_session_chain(s) for s in (s_a, s_b, s_c, truncated, 12)]))

    def sweep(label):
        reports = [side.scrubber.tick()]
        while not reports[-1]["sweep_completed"]:
            reports.append(side.scrubber.tick())
        log.append((label, reports))
        log.append((label + ":summary", side.scrubber.summary()))

    sweep("scrub_clean")
    side.flip_digest_bit(st._audit_rows[s_a][1])
    log.append(("verify_flipped", [st.verify_session_chain(s) for s in (s_a, s_c)]))
    sweep("scrub_flipped")

    record("terminate", st.terminate_sessions([s_a, s_b, truncated], now=14.0))
    for _ in range(40):
        st.stage_delta(s_c, 1, ts=9.0)
    with pytest.raises(RuntimeError, match="live session"):
        st.flush_deltas()
    record("live_wrap_refused")
    log.append(("spans", [[(s.name, s.span_word, s.parent_span_word, s.wave_seq)
                           for s in root.walk()] for root in st.tracer.drain()]))
    return log


def _on_both(run, ref_side, port_side) -> tuple:
    """`run` on a new reference side, then on a new port side, each with
    trace ids counted from 0 and both packages' kernels unarmed; returns
    both logs and the port side."""
    counter = itertools.count()

    def token_hex(nbytes=None):
        return f"{next(counter):0{2 * nbytes}x}"

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HV_WAVE_PALLAS", "0")
        mp.setenv("HV_SHA256_PALLAS", "0")
        mp.delenv("HV_TRACE", raising=False)
        mp.delenv("HV_TRACE_SAMPLE", raising=False)
        mp.setattr(secrets, "token_hex", token_hex)
        ref = run(ref_side())
        counter = itertools.count()
        port_obj = port_side()
        port = run(port_obj)
    return ref, port, port_obj


@pytest.fixture(scope="module")
def runs():
    ref, port, port_side = _on_both(_run, _Ref, _Port)
    return dict(ref), dict(port), port_side


def _run_scattered(side) -> list[tuple[str, object]]:
    """A lifecycle wave on a session layout with gaps and in no order:
    twelve sessions created, three terminated, one left standing with a
    member and a live bond, and the wave on six of the rest, shuffled,
    padded to a bucket (its parked rows past the twelve)."""
    log: list[tuple[str, object]] = []
    st = side.st
    rng = np.random.RandomState(21)
    slots = st.create_sessions_batch([f"sc:s{i}" for i in range(12)],
                                     side.session_config(min_sigma_eff=0.55, max_participants=1))
    log.append(("terminated", st.terminate_sessions([2, 5, 9], now=9.0).tolist()))
    standing = 7
    side.place_member(15, 901, standing)
    wave_slots = np.array([10, 0, 4, 3, 11, 1], np.int32)
    side.place_edges(list(range(5)), voucher=[12, 13, 14, 12, 15], vouchee=[0, 0, 1, 1, 14],
                     session=[10, 10, 0, 0, standing],
                     bond=rng.uniform(0.05, 0.3, 5).astype(np.float32),
                     expiry=np.array([np.inf, np.inf, np.inf, 1.0, np.inf], np.float32))
    b = len(wave_slots) + 1
    lane_sessions = np.concatenate([wave_slots, wave_slots[:1]])
    sigma = rng.uniform(0.3, 1.0, b).astype(np.float32)
    sigma[0] = 0.45
    bodies = rng.randint(0, 2**32, (T, len(wave_slots), 16), dtype=np.uint64).astype(np.uint32)
    res = st.run_governance_wave(
        wave_slots, [f"did:sc:{i}" for i in range(b)], lane_sessions, sigma, bodies,
        now=10.0, omega=0.5, pad_to=(10, 8),
    )
    log.append(("wave", side.wave_result(res)))
    log.append(("wave:tables", side.snapshot()))
    log.append(("wave:host", _host_state(st)))
    assert slots.tolist() == list(range(12))
    return log


@pytest.fixture(scope="module")
def scattered_runs():
    ref, port, _ = _on_both(_run_scattered, _Ref, _Port)
    return dict(ref), dict(port)


def _run_rebooked(side) -> list[tuple[str, object]]:
    """Waves that book leaves onto sessions that already hold some (the
    module docstring's second sequence)."""
    log: list[tuple[str, object]] = []
    st = side.st
    rng = np.random.RandomState(22)
    cfg = side.session_config(min_sigma_eff=0.55, max_participants=1)
    first = st.create_sessions_batch([f"rb:s{i}" for i in range(K)], cfg)

    def wave(label, slots, t, now):
        b = len(slots)
        bodies = rng.randint(0, 2**32, (t, b, 16), dtype=np.uint64).astype(np.uint32)
        sigma = rng.uniform(0.3, 1.0, b).astype(np.float32)
        res = st.run_governance_wave(slots, [f"did:{label}:{i}" for i in range(b)], slots,
                                     sigma, bodies, now=now, omega=0.5)
        log.append((label, side.wave_result(res)))
        log.append((label + ":tables", side.snapshot()))
        log.append((label + ":host", _host_state(st)))

    wave("first", first, T, 10.0)
    wave("again", first, 2, 11.0)
    others = st.create_sessions_batch([f"rb:n{i}" for i in range(K)], cfg)
    wave("wrap", others, T, 12.0)
    wave("rebuilt", first, 1, 13.0)
    log.append(("terminate", st.terminate_sessions(list(first), now=14.0).tolist()))
    log.append(("terminate:tables", side.snapshot()))
    log.append(("terminate:host", _host_state(st)))
    return log


@pytest.fixture(scope="module")
def rebooked_runs():
    ref, port, _ = _on_both(_run_rebooked, _Ref, _Port)
    return dict(ref), dict(port)


def _assert_same(label, got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), label
        for key, w in want.items():
            _assert_same(f"{label} {key}", got[key], w)
    elif isinstance(want, np.ndarray):
        g = np.asarray(got)
        assert g.dtype == want.dtype and g.shape == want.shape, label
        assert g.tobytes() == want.tobytes(), f"{label} diverged"
    else:
        assert got == want, label


@pytest.mark.parametrize("step", ["wave0", "wave1", "wave2"])
def test_lifecycle_waves_match_reference(runs, step):
    ref, port, _ = runs
    for suffix in ("", ":tables", ":host"):
        _assert_same(step + suffix, port[step + suffix], ref[step + suffix])
    res = port[step]
    assert (res["status"] == 0).any()
    assert res["sigma_eff"][0] > np.float32(0.45)  # the vouched lane rode its claimed row
    if step == "wave1":
        assert 3 in res["status"] and res["status"].shape == (K + 1,)  # trimmed, capacity refusal


@pytest.mark.parametrize("step", ["terminated", "wave", "wave:tables", "wave:host"])
def test_lifecycle_wave_on_a_scattered_layout_matches_reference(scattered_runs, step):
    ref, port = scattered_runs
    _assert_same(step, port[step], ref[step])
    if step == "wave":
        res = port["wave"]
        assert (res["status"] == 0).any() and 3 in res["status"]  # the repeated session fills
        assert res["released"] == 4  # every bond in a wave session; the standing session's stays
    if step == "wave:tables":
        assert port[step]["agents.i32"][15, AI32_FLAGS] == 1  # the standing member keeps its seat
        assert port[step]["vouches.active"][4]      # and its bond


@pytest.mark.parametrize("step", ["flush1", "flush2"])
def test_flush_deltas_matches_reference(runs, step):
    ref, port, _ = runs
    for suffix in ("", ":tables", ":host"):
        _assert_same(step + suffix, port[step + suffix], ref[step + suffix])


@pytest.mark.parametrize("step", ["first", "again", "wrap", "rebuilt", "terminate"])
def test_rebooked_sessions_match_reference(rebooked_runs, step):
    """Frontiers carried across waves, evicted by a wrap and built anew:
    every step held to the reference's."""
    ref, port = rebooked_runs
    for suffix in ("", ":tables", ":host"):
        _assert_same(step + suffix, port[step + suffix], ref[step + suffix])
    host = port[step + ":host"]
    counts = {s: host["frontier"][s][0] if s in host["frontier"] else None for s in range(K)}
    rows = {s: len(host["audit_rows"][s]) for s in range(K)}
    if step == "again":
        assert counts == rows == dict.fromkeys(range(K), T + 2)      # every lane carried
    if step == "wrap":
        assert all(counts[s] is None for s in range(K) if rows[s] < T + 2)
    if step == "rebuilt":
        evicted = [s for s in range(K) if port["wrap:host"]["frontier"].get(s) is None]
        assert evicted and all(counts[s] == 1 < rows[s] for s in evicted)
        assert any(counts[s] == T + 3 for s in range(K))           # a frontier carried


def test_verify_session_chain_matches_reference(runs):
    ref, port, _ = runs
    assert port["verify"] == ref["verify"] == [True, False, True, True, True]
    assert port["verify_flipped"] == ref["verify_flipped"] == [False, True]


@pytest.mark.parametrize("step", ["scrub_clean", "scrub_flipped"])
def test_scrubber_reports_match_reference(runs, step):
    ref, port, _ = runs
    assert port[step] == ref[step]
    assert port[step + ":summary"] == ref[step + ":summary"]
    # s_b's pinned leaf (an explicit digest, row 18) never re-hashes; the
    # flipped digest (s_a's row 15) fails its own link and its child's.
    rows = sorted(m["row"] for r in port[step] for m in r["mismatches"])
    assert rows == ([18] if step == "scrub_clean" else [15, 16, 18])


def test_terminate_sessions_matches_reference(runs):
    ref, port, _ = runs
    for suffix in ("", ":tables", ":host"):
        _assert_same("terminate" + suffix, port["terminate" + suffix], ref["terminate" + suffix])
    host = port["terminate:host"]
    assert host["scrubbed_edges"] == [31]          # the bond in s_c named a reclaimed member
    assert 7 in host["frontier"]                   # recomputed and re-primed


def test_live_wrap_refusal_matches_reference(runs):
    ref, port, _ = runs
    for suffix in (":tables", ":host"):
        _assert_same("live_wrap_refused" + suffix, port["live_wrap_refused" + suffix],
                     ref["live_wrap_refused" + suffix])


def test_trace_spans_match_reference(runs):
    ref, port, _ = runs
    assert port["spans"] == ref["spans"]
    roots = [wave[0][0] for wave in port["spans"]]
    # 36 stamps on a 32-row ring: wave 0 lost its first four, root included.
    assert roots.count("hv.governance_wave") == 2
    assert {"hv.delta_chain", "hv.terminate_wave"} <= set(roots)


def test_host_cursor_mirrors_match_the_device(runs):
    *_, side = runs
    st = side.st
    assert st._delta_cursor == int(st.delta_log.cursor)
    assert st.tracer.cursor == int(st.tracer.table.cursor) == 36


def test_port_import_leaves_jax_out_of_sys_modules():
    """A fresh interpreter that imports the port's facade, audit and
    trace modules loads neither jax nor the JAX package."""
    code = (
        "import sys\n"
        "import hypervisor_tpu_torch.state, hypervisor_tpu_torch.integrity.scrubber\n"
        "import hypervisor_tpu_torch.kernels, hypervisor_tpu_torch.tables\n"
        "import hypervisor_tpu_torch.runtime.saga_scheduler, hypervisor_tpu_torch.saga.dsl\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'hypervisor_tpu')))\n"
    )
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_unported_facade_arguments_are_refused():
    """The facade wave's argument checks. The mesh wave is ported: on an
    8-shard CPU mesh it equals the reference's on its 8-device mesh, and
    a `mesh` that is not a mesh is refused with the reference's own
    error."""
    from hypervisor_tpu import parallel as jax_parallel
    from hypervisor_tpu_torch import parallel as port_parallel

    jax_st = JaxState(jax_config.HypervisorConfig(capacity=jax_config.TableCapacity(**CAP)))
    st = PortState(port_config.HypervisorConfig(capacity=port_config.TableCapacity(**CAP)),
                   device="cpu")
    bodies = np.random.RandomState(5).randint(0, 2**32, (T, 1, 16), dtype=np.uint64)
    outs = []
    for state, models, mesh in ((jax_st, jax_models, jax_parallel.make_mesh(8, platform="cpu")),
                                (st, port_models, port_parallel.make_mesh(8, platform="cpu"))):
        slots = state.create_sessions_batch(["a"], models.SessionConfig())
        args = (slots, ["d"], slots, np.ones(1, np.float32), bodies.astype(np.uint32))
        res = state.run_governance_wave(*args, mesh=mesh)
        outs.append([np.asarray(getattr(res, f)).tolist() for f in _WAVE_FIELDS + ("released",)]
                    + [np.asarray(res.merkle_root).view(np.uint32).tolist(),
                       np.asarray(state.sessions.i32).tolist()])
        with pytest.raises(AttributeError) as err:
            state.run_governance_wave(*args, mesh=object())
        outs[-1].append(str(err.value))
    assert outs[1] == outs[0]
    assert outs[1][-1] == "'object' object has no attribute 'devices'"
    with pytest.raises(ValueError, match="action slots out of range"):
        st.run_governance_wave(*args, actions={"slots": [CAP["max_agents"]]})
    with pytest.raises(ValueError, match="below the wave shape"):
        st.run_governance_wave(*args, pad_to=(0, 1))
    with pytest.raises(ValueError, match="pad_to is the single-device bucket contract"):
        st.run_governance_wave(*args, pad_to=(1, 1), mesh=port_parallel.make_mesh(8, platform="cpu"))


# ── the facade with actions, and a sanitized wave on its tables ──────

ACT_CAP = dict(max_agents=48, max_sessions=40, max_vouch_edges=32, delta_log_capacity=40,
               trace_log_capacity=64)
#: Standing members the actions come from, past every row a wave claims.
ACTORS = np.arange(32, 48)
ACT_K = 4
_ACT_TABLES = ("agents", "sessions", "vouches", "sagas", "elevations", "delta_log", "event_log")
_GATEWAY_LANES = ("verdict", "ring_status", "eff_ring", "sigma_eff", "severity", "anomaly_rate",
                  "window_calls", "tripped")


def _act_ref_state():
    return JaxState(jax_config.HypervisorConfig(capacity=jax_config.TableCapacity(
        **ACT_CAP, max_sagas=8, max_steps_per_saga=4, max_elevations=8, event_log_capacity=16)))


def _act_port_state():
    return PortState(port_config.HypervisorConfig(capacity=port_config.TableCapacity(
        **ACT_CAP, max_sagas=8, max_steps_per_saga=4, max_elevations=8, event_log_capacity=16)),
        device="cpu")


def _act_columns(rng):
    """The standing actors' rows: ring 2 at sigma 0.8 with 40 tokens, but
    row 40 holds 2.5 tokens, 41 is quarantined, 42's breaker runs to 100,
    44-47 are ring 3 at sigma 0.4; and two sudo grants, 43 to ring 0 for
    good and 44 to ring 1 until 11.5 (it lapses after the first wave)."""
    n = len(ACTORS)
    flags = np.full(n, 1, np.int32)
    flags[41 - 32] |= 2
    flags[42 - 32] |= 4
    ring = np.where(ACTORS >= 44, 3, 2).astype(np.int8)
    sigma = np.where(ACTORS >= 44, 0.4, 0.8).astype(np.float32)
    tokens = np.full(n, 40.0, np.float32)
    tokens[40 - 32] = 2.5
    until = np.zeros(n, np.float32)
    until[42 - 32] = 100.0
    elev = dict(agent=np.array([43, 44, -1], np.int32), granted_ring=np.array([0, 1, 3], np.int8),
                expires_at=np.array([1e6, 11.5, 0.0], np.float32),
                active=np.array([True, True, False]))
    return flags, ring, sigma, tokens, until, elev


def _actions(rng, b):
    return {
        "slots": rng.choice(ACTORS, b).astype(np.int32),  # about 2x duplicates
        "required_rings": np.where(rng.uniform(size=b) < 0.3, 0, rng.randint(1, 4, b)),
        "is_read_only": rng.uniform(size=b) < 0.2,
        "has_consensus": rng.uniform(size=b) < 0.5,
        "has_sre_witness": rng.uniform(size=b) < 0.2,
        "host_tripped": rng.uniform(size=b) < 0.05,
    }


class _ActRef(_Ref):
    def __init__(self):
        self.st = _act_ref_state()

    def session_config(self, **kw):
        return jax_models.SessionConfig(**kw)

    def place_actors(self, rng):
        flags, ring, sigma, tokens, until, elev = _act_columns(rng)
        a, rows = self.st.agents, jnp.asarray(ACTORS)
        s = self.st.create_session("actors", self.session_config(max_participants=20), now=1.0)
        self.st.agents = jax_replace(
            a, did=a.did.at[rows].set(jnp.asarray(1000 + ACTORS, jnp.int32)),
            session=a.session.at[rows].set(s), flags=a.flags.at[rows].set(flags),
            ring=a.ring.at[rows].set(ring), sigma_eff=a.sigma_eff.at[rows].set(sigma),
            sigma_raw=a.sigma_raw.at[rows].set(sigma), rl_tokens=a.rl_tokens.at[rows].set(tokens),
            bd_breaker_until=a.bd_breaker_until.at[rows].set(until))
        sess = self.st.sessions
        self.st.sessions = jax_replace(
            sess, n_participants=sess.n_participants.at[s].set(len(ACTORS)))
        e, idx = self.st.elevations, jnp.arange(3)
        self.st.elevations = jax_replace(e, **{k: getattr(e, k).at[idx].set(v)
                                               for k, v in elev.items()})

    def corrupt(self):
        a, s = self.st.agents, self.st.sessions
        self.st.agents = jax_replace(a, flags=a.flags.at[33].set(a.flags[33] | (1 << 9)))
        self.st.sessions = jax_replace(s, n_participants=s.n_participants.at[1].set(99))
        v = self.st.vouches
        self.st.vouches = jax_replace(v, bond=v.bond.at[2].set(-1.0), active=v.active.at[2].set(True))
        e = self.st.elevations
        self.st.elevations = jax_replace(e, agent=e.agent.at[0].set(999))

    def gateway(self, gw):
        return {f: np.asarray(getattr(gw, f)) for f in _GATEWAY_LANES}

    def sanitized_wave(self, lanes):
        from hypervisor_tpu.ops import pipeline as jax_pipeline
        import jax

        st = self.st
        wave = jax.jit(jax_pipeline.governance_wave,
                       static_argnames=("use_pallas", "unique_sessions", "wave_kernels", "sanitize"))
        res = wave(
            st.agents, st.sessions, st.vouches,
            *(jnp.asarray(lanes[k]) for k in ("slot", "did", "session_slot", "sigma_raw",
                                               "trustworthy", "duplicate", "wave_sessions",
                                               "bodies")),
            12.5, 0.5, use_pallas=False, wave_kernels=False, unique_sessions=True,
            metrics=st.metrics.table, elevations=st.elevations,
            gateway_args=tuple(jnp.asarray(c) for c in lanes["gateway"]),
            delta_log=st.delta_log, epilogue_tables=(st.sagas, st.event_log), sanitize=True,
            ring_bursts=jnp.asarray(st.config.rate_limit.ring_bursts, jnp.float32),
        )
        st.agents, st.sessions, st.vouches, st.delta_log = (
            res.agents, res.sessions, res.vouches, res.delta_log)
        st.metrics.commit(res.metrics)
        out = {f: np.asarray(getattr(res.sanitizer, f)) for f in (
            "agent_mask", "session_mask", "vouch_mask", "saga_mask", "elev_mask", "log_mask")}
        out.update(total=int(res.sanitizer.total), unrepairable=int(res.sanitizer.unrepairable))
        out["gateway"] = self.gateway(res.gateway)
        return out

    def snapshot(self):
        out = {k: v for k, v in state_arrays(self.st).items() if k.split(".")[0] in _ACT_TABLES}
        for c in _METRICS:
            out[f"metrics.{c}"] = np.array(getattr(self.st.metrics.table, c))
        out["trace.words"] = np.array(self.st.tracer.table.words)
        return out


class _ActPort(_ActRef):
    wave_result = _Port.wave_result

    def __init__(self):
        self.st = _act_port_state()

    def session_config(self, **kw):
        return port_models.SessionConfig(**kw)

    def place_actors(self, rng):
        flags, ring, sigma, tokens, until, elev = _act_columns(rng)
        a, rows = self.st.agents, torch.from_numpy(ACTORS)
        s = self.st.create_session("actors", self.session_config(max_participants=20), now=1.0)
        a.i32[rows, AI32_DID] = torch.from_numpy((1000 + ACTORS).astype(np.int32))
        a.i32[rows, AI32_SESSION] = s
        a.i32[rows, AI32_FLAGS] = torch.from_numpy(flags)
        a.ring[rows] = torch.from_numpy(ring)
        for col, val in ((0, sigma), (1, sigma), (4, tokens), (6, until)):
            a.f32[rows, col] = torch.from_numpy(val)
        self.st.sessions.i32[s, SI32_NPART] = len(ACTORS)
        for k, v in elev.items():
            getattr(self.st.elevations, k)[:3] = torch.from_numpy(v)

    def corrupt(self):
        st = self.st
        st.agents.i32[33, AI32_FLAGS] |= 1 << 9
        st.sessions.i32[1, SI32_NPART] = 99
        st.vouches.bond[2], st.vouches.active[2] = -1.0, True
        st.elevations.agent[0] = 999

    def gateway(self, gw):
        return {f: getattr(gw, f).numpy().copy() for f in _GATEWAY_LANES}

    def sanitized_wave(self, lanes):
        from hypervisor_tpu_torch.ops import pipeline as port_pipeline

        st = self.st
        t = torch.from_numpy
        res = port_pipeline.governance_wave(
            st.agents, st.sessions, st.vouches,
            *(t(np.ascontiguousarray(lanes[k])) for k in (
                "slot", "did", "session_slot", "sigma_raw", "trustworthy", "duplicate",
                "wave_sessions")),
            u32.from_numpy_u32(lanes["bodies"], "cpu"), 12.5, 0.5, unique_sessions=True,
            metrics=st.metrics.table, elevations=st.elevations,
            gateway_args=tuple(t(np.ascontiguousarray(c)) for c in lanes["gateway"]),
            delta_log=st.delta_log, delta_cursor=st._delta_cursor,
            epilogue_tables=(st.sagas, st.event_log), sanitize=True,
            ring_bursts=st.config.rate_limit.ring_bursts,
        )
        out = {f: getattr(res.sanitizer, f).numpy().view(np.uint32).copy() for f in (
            "agent_mask", "session_mask", "vouch_mask", "saga_mask", "elev_mask", "log_mask")}
        out.update(total=int(res.sanitizer.total), unrepairable=int(res.sanitizer.unrepairable))
        out["gateway"] = self.gateway(res.gateway)
        return out

    def snapshot(self):
        st = self.st
        out = port_tables.to_state_arrays(port_tables.StateTables(
            st.agents, st.sessions, st.vouches, delta_log=st.delta_log, sagas=st.sagas,
            elevations=st.elevations, event_log=st.event_log))
        for c in _METRICS:
            a = getattr(st.metrics.table, c).numpy().copy()
            out[f"metrics.{c}"] = a.view(np.uint32) if c in ("counters", "hist") else a
        out["trace.words"] = st.tracer.table.words.numpy().view(np.uint32).copy()
        return out


def _run_actions(side) -> dict:
    """Three facade waves with actions from standing members (the second
    padded to a bucket), the gauge epilogue on each; then one sanitized
    pipeline wave on the same tables, one field of four tables corrupted
    first."""
    log = {}
    st = side.st
    rng = np.random.RandomState(30)
    side.place_actors(rng)
    for w in range(3):
        slots = st.create_sessions_batch([f"a{w}:s{i}" for i in range(ACT_K)],
                                         side.session_config(min_sigma_eff=0.5, max_participants=1))
        lane_sessions = np.concatenate([slots, slots[:1]]) if w == 1 else slots
        b = len(lane_sessions)
        sigma = rng.uniform(0.4, 1.0, b).astype(np.float32)
        bodies = rng.randint(0, 2**32, (T, ACT_K, 16), dtype=np.uint64).astype(np.uint32)
        res, gw = st.run_governance_wave(
            slots, [f"a:{w}:{i}" for i in range(b)], lane_sessions, sigma, bodies,
            now=10.0 + w, actions=_actions(rng, (12, 20, 9)[w]),
            pad_to=(8, 6) if w == 1 else None)
        log[f"wave{w}"] = side.wave_result(res)
        log[f"wave{w}:gateway"] = side.gateway(gw)
        log[f"wave{w}:tables"] = side.snapshot()
    side.corrupt()
    slots = st.create_sessions_batch([f"san:s{i}" for i in range(ACT_K)],
                                     side.session_config(min_sigma_eff=0.5, max_participants=1))
    act = st._normalize_actions(_actions(rng, 10))
    lanes = dict(
        slot=np.arange(16, 16 + ACT_K, dtype=np.int32), did=np.arange(ACT_K, dtype=np.int32) + 500,
        session_slot=np.asarray(slots, np.int32), sigma_raw=np.full(ACT_K, 0.8, np.float32),
        trustworthy=np.ones(ACT_K, bool), duplicate=np.zeros(ACT_K, bool),
        wave_sessions=np.asarray(slots, np.int32),
        bodies=rng.randint(0, 2**32, (T, ACT_K, 16), dtype=np.uint64).astype(np.uint32),
        gateway=st._pad_gateway_lanes(act),
    )
    if isinstance(lanes["gateway"][0], jnp.ndarray):
        lanes["gateway"] = tuple(np.asarray(c) for c in lanes["gateway"])
    log["sanitized"] = side.sanitized_wave(lanes)
    log["sanitized:tables"] = side.snapshot()
    return log


@pytest.fixture(scope="module")
def action_runs():
    ref, port, _ = _on_both(_run_actions, _ActRef, _ActPort)
    return ref, port


@pytest.mark.parametrize("step", ["wave0", "wave1", "wave2"])
def test_facade_waves_with_actions_match_reference(action_runs, step):
    """Verdict lanes, the tables after the gateway and the whole metrics
    table (gateway counters and the epilogue's gauges) equal the
    reference's after every wave."""
    ref, port = action_runs
    for suffix in ("", ":gateway", ":tables"):
        _assert_same(step + suffix, port[step + suffix], ref[step + suffix])
    seen = {v for w in range(3) for v in port[f"wave{w}:gateway"]["verdict"].tolist()}
    assert {0, 1, 2, 3} <= seen  # allowed, breaker, quarantine and ring refusals
    tables = port[step + ":tables"]
    gauges = tables["metrics.gauges"]
    assert gauges[4] >= len(ACTORS) - 1 and gauges[29] > 0  # active rows, trace ring rows


def test_sanitized_pipeline_wave_on_the_facade_tables_matches_reference(action_runs):
    ref, port = action_runs
    _assert_same("sanitized", port["sanitized"], ref["sanitized"])
    _assert_same("sanitized:tables", port["sanitized:tables"], ref["sanitized:tables"])
    san = port["sanitized"]
    assert san["total"] >= 4 and san["agent_mask"][33] and san["session_mask"][1]
    assert san["vouch_mask"][2] and san["elev_mask"][0]
    counters = port["sanitized:tables"]["metrics.counters"]
    assert counters[50] == 1 and counters[51] == san["total"]
