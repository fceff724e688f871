"""The port's native host runtime (`runtime.native` over
`csrc/hv_runtime.cpp`) against hashlib, its own fallback and the
reference, on the CPU.

g++ is on this host, so the library really builds (into
`hypervisor_tpu_torch/_build/`) and runs here. The cases are the
counterparts of `tests/unit/test_native_runtime.py` and
`tests/integration/test_concurrent_ingest.py` on the port, plus:

  * each host route of `ops.merkle` (`tree_roots_host`,
    `verify_chain_digests_host`, `verify_chain_links_host`),
    `audit.delta.merkle_root_native`, the scrubber's strip and the four
    hash entries of `runtime.native`, run with the library and again with
    `HAVE_NATIVE` patched off (the plain torch versions, or the module's
    Python fallback), equal to each other and to the reference's outputs
    (tolerance 0);
  * the join staging queue under 8 producer threads on a port state,
    whose flush equals the same joins pushed into a fallback-form queue;
  * the port's library is its own file: a reference state and a port
    state stage joins interleaved, each harvest intact;
  * `csrc/hv_runtime.cpp` byte-equal to the reference's `native/hv_runtime.cpp`.
"""

from __future__ import annotations

import hashlib
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from hypervisor_tpu.audit import delta as jax_delta
from hypervisor_tpu.ops import merkle as jax_merkle
from hypervisor_tpu.runtime import native as jax_native
from hypervisor_tpu_torch import config as port_config
from hypervisor_tpu_torch import u32
from hypervisor_tpu_torch.audit import delta
from hypervisor_tpu_torch.integrity.scrubber import MerkleScrubber
from hypervisor_tpu_torch.models import SessionConfig
from hypervisor_tpu_torch.ops import merkle
from hypervisor_tpu_torch.runtime import (
    HAVE_NATIVE,
    StagingQueue,
    chain_digests_host,
    merkle_root_hex_host,
    native,
    sha256_batch_host,
    verify_chain_host,
)
from hypervisor_tpu_torch.state import HypervisorState, _contiguous_range_host, _mkey, _mkeys

ROOT = Path(__file__).resolve().parent.parent


def test_native_compiled():
    # g++ is on this host: the native path must be live here.
    assert HAVE_NATIVE and native.HAVE_NATIVE


def test_source_is_the_reference_file_byte_for_byte():
    assert (ROOT / "hypervisor_tpu_torch/csrc/hv_runtime.cpp").read_bytes() == (
        ROOT / "native/hv_runtime.cpp").read_bytes()


def test_library_is_the_ports_own_file():
    """Built under the package's `_build/`, named by the source-and-flags
    hash; never the reference's library."""
    path = native.library_path()
    assert path.exists() and path.parent == ROOT / "hypervisor_tpu_torch" / "_build"
    assert native._lib._name == str(path)
    assert Path(jax_native._lib._name).resolve() != path.resolve()


# ── tests/unit/test_native_runtime.py ────────────────────────────────


def test_sha256_batch_matches_hashlib():
    rng = np.random.RandomState(0)
    msgs = rng.randint(0, 256, size=(5, 73), dtype=np.int64).astype(np.uint8)
    out = sha256_batch_host(msgs)
    for i in range(5):
        assert out[i].tobytes() == hashlib.sha256(msgs[i].tobytes()).digest()


def test_chain_matches_device_format():
    rng = np.random.RandomState(1)
    bodies = rng.randint(0, 2**32, size=(6, merkle.BODY_WORDS), dtype=np.uint64).astype(np.uint32)
    host = chain_digests_host(bodies)
    dev = u32.to_numpy_u32(merkle.chain_digests(u32.from_numpy_u32(bodies[:, None, :], "cpu")))[:, 0]
    assert np.array_equal(host, np.ascontiguousarray(dev.astype(">u4")).view(np.uint8).reshape(6, 32))


def test_verify_chain_detects_tamper_index():
    rng = np.random.RandomState(2)
    bodies = rng.randint(0, 2**32, size=(5, 16), dtype=np.uint64).astype(np.uint32)
    digests = chain_digests_host(bodies)
    assert verify_chain_host(bodies, digests) == -1
    tampered = digests.copy()
    tampered[3, 0] ^= 1
    assert verify_chain_host(bodies, tampered) == 3


def test_merkle_root_matches_reference_semantics():
    leaves_hex = [hashlib.sha256(b"leaf%d" % i).hexdigest() for i in range(5)]
    leaves = np.stack([np.frombuffer(bytes.fromhex(h), np.uint8) for h in leaves_hex])
    assert merkle_root_hex_host(leaves) == delta.merkle_root_host(leaves_hex)


def test_staging_push_and_harvest():
    q = StagingQueue(capacity=8)
    assert q.push(0.8, 1, 2) == 0
    assert q.push(0.5, 3, 4, trustworthy=False) == 1
    n, sigma, agent, session, trust = q.harvest()
    assert n == 2
    assert sigma.tolist() == pytest.approx([0.8, 0.5])
    assert agent.tolist() == [1, 3] and trust.tolist() == [1, 0]
    assert q.harvest()[0] == 0  # epoch reset


def test_staging_overflow_returns_minus_one():
    q = StagingQueue(capacity=2)
    assert [q.push(0.1, 0, 0), q.push(0.2, 1, 0), q.push(0.3, 2, 0)] == [0, 1, -1]


def test_staging_concurrent_producers_unique_slots():
    q = StagingQueue(capacity=4096)
    slots: list[int] = []
    lock = threading.Lock()

    def producer(base):
        mine = [q.push(0.5, base * 1000 + i, 0) for i in range(1000)]
        with lock:
            slots.extend(mine)

    threads = [threading.Thread(target=producer, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    n, _, agent, _, _ = q.harvest()
    valid = [s for s in slots if s >= 0]
    assert n == 4000 and len(valid) == 4000 and len(set(valid)) == 4000
    assert len(set(agent.tolist())) == 4000  # every payload distinct


def test_second_queue_does_not_corrupt_first():
    q1 = StagingQueue(capacity=8)
    q2 = StagingQueue(capacity=8)  # binds the native side to q2
    assert q1.push(0.5, 3, 7) >= 0  # re-binds to q1 first
    n, sigma, agent, session, _ = q1.harvest()
    assert n == 1 and agent[0] == 3 and session[0] == 7 and abs(float(sigma[0]) - 0.5) < 1e-6
    assert q2.push(0.9, 1, 2) >= 0
    n2, _, agent2, session2, _ = q2.harvest()
    assert n2 == 1 and agent2[0] == 1 and session2[0] == 2


def test_interleaved_staging_fails_loudly():
    qa = StagingQueue(capacity=8)
    assert qa.push(0.5, 1, 1) >= 0
    StagingQueue(capacity=8)  # a foreign bind resets the epoch
    with pytest.raises(RuntimeError, match="staged join"):
        qa.harvest()
    assert qa.acknowledge_lost_epoch() == 1
    assert qa.push(0.7, 2, 3) >= 0
    n, _, agent, session, _ = qa.harvest()
    assert n == 1 and agent[0] == 2 and session[0] == 3


def test_contiguous_range_gate():
    assert _contiguous_range_host(np.arange(5, 12, dtype=np.int32)) == (5, 12)
    for bad in ([], [-1, 0, 1], [3, 5, 6], [3, 3, 4], [4, 3, 2]):
        assert _contiguous_range_host(np.array(bad, np.int32)) is None


def test_membership_keys_roundtrip():
    rng = np.random.RandomState(7)
    sessions = rng.randint(0, 2**20, 256).astype(np.int32)
    dids = rng.randint(0, 2**20, 256).astype(np.int32)
    keys = _mkeys(sessions, dids)
    for i in range(256):
        k = int(keys[i])
        assert k == _mkey(int(sessions[i]), int(dids[i]))
        assert (k >> 32, k & 0xFFFFFFFF) == (sessions[i], dids[i])
    assert len(set(keys.tolist())) == len({(int(s), int(d)) for s, d in zip(sessions, dids)})


# ── each host route with the library, without it, and the reference ──


def _both_routes(fn, monkeypatch):
    """fn() with the library and with HAVE_NATIVE patched off."""
    with_lib = fn()
    with monkeypatch.context() as mp:
        mp.setattr(native, "HAVE_NATIVE", False)
        without = fn()
    return with_lib, without


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_hash_entries_with_and_without_library_match_reference(monkeypatch):
    rng = np.random.RandomState(3)
    msgs = rng.randint(0, 256, (40, 96)).astype(np.uint8)
    bodies = rng.randint(0, 2**32, (33, 16), dtype=np.uint64).astype(np.uint32)
    leaves = rng.randint(0, 256, (13, 32)).astype(np.uint8)
    for fn, ref in (
        (lambda: native.sha256_batch_host(msgs), lambda: jax_native.sha256_batch_host(msgs)),
        (lambda: native.chain_digests_host(bodies), lambda: jax_native.chain_digests_host(bodies)),
        (lambda: native.merkle_root_hex_host(leaves),
         lambda: jax_native.merkle_root_hex_host(leaves)),
    ):
        got, fallback = _both_routes(fn, monkeypatch)
        _eq(got, fallback)
        _eq(got, ref())
    recorded = native.chain_digests_host(bodies)
    recorded[20, 5] ^= 0x10
    got, fallback = _both_routes(lambda: native.verify_chain_host(bodies, recorded), monkeypatch)
    assert got == fallback == jax_native.verify_chain_host(bodies, recorded) == 20


@pytest.mark.parametrize("p,counts", [(4, [0, 1, 2, 3, 4]), (16, [16, 9, 1, 5]), (64, [33, 64])])
def test_tree_roots_host_routes_match_reference(monkeypatch, p, counts):
    rng = np.random.RandomState(p)
    leaves = rng.randint(0, 2**32, (len(counts), p, 8), dtype=np.uint64).astype(np.uint32)
    cnt = np.array(counts, np.int32)
    got, plain = _both_routes(lambda: merkle.tree_roots_host(leaves, cnt, "cpu"), monkeypatch)
    _eq(got, plain)
    _eq(got, jax_merkle.tree_roots_host(leaves, cnt, use_pallas=False))


def test_verify_chain_digests_host_routes_match_reference(monkeypatch):
    rng = np.random.RandomState(4)
    n, lanes = 9, 6
    bodies = rng.randint(0, 2**32, (n, lanes, 16), dtype=np.uint64).astype(np.uint32)
    recorded = u32.to_numpy_u32(merkle.chain_digests(u32.from_numpy_u32(bodies, "cpu")))
    recorded[4, 1, 0] ^= 1          # tampered inside lane 1's count
    recorded[8, 2, 3] ^= 1          # tampered past lane 2's count
    counts = np.array([9, 9, 5, 0, 1, 9], np.int32)
    got, plain = _both_routes(
        lambda: merkle.verify_chain_digests_host(bodies, recorded, counts, "cpu"), monkeypatch)
    _eq(got, plain)
    _eq(got, jax_merkle.verify_chain_digests_host(bodies, recorded, counts, use_pallas=False))
    assert got.tolist() == [True, False, True, True, True, True]


def test_verify_chain_links_host_routes_match_reference(monkeypatch):
    rng = np.random.RandomState(5)
    c, b = 24, 16
    body = rng.randint(0, 2**32, (c, 16), dtype=np.uint64).astype(np.uint32)
    digest = rng.randint(0, 2**32, (c, 8), dtype=np.uint64).astype(np.uint32)
    rows = rng.randint(-2, c + 3, b)
    prev = rng.randint(-2, c + 3, b)
    seed = rng.uniform(size=b) < 0.3
    valid = rng.uniform(size=b) < 0.8
    # Make some links real so both verdicts occur.
    for i in range(0, b, 3):
        r = int(np.clip(rows[i], 0, c - 1))
        parent = np.zeros(8, np.uint32) if seed[i] else digest[int(np.clip(prev[i], 0, c - 1))]
        msg = np.concatenate([body[r], parent]).astype(">u4").tobytes()
        digest[r] = np.frombuffer(hashlib.sha256(msg).digest(), ">u4")
    cols = (u32.from_numpy_u32(body, "cpu"), u32.from_numpy_u32(digest, "cpu"))
    got, plain = _both_routes(
        lambda: merkle.verify_chain_links_host(*cols, rows, prev, seed, valid), monkeypatch)
    _eq(got, plain)
    _eq(got, jax_merkle.verify_chain_links_host(body, digest, rows, prev, seed, valid))
    assert got.any() and not got.all()


def test_merkle_root_native_routes_match_reference(monkeypatch):
    hashes = [hashlib.sha256(b"d%d" % i).hexdigest() for i in range(37)]
    got, fallback = _both_routes(lambda: delta.merkle_root_native(hashes), monkeypatch)
    assert got == fallback == jax_delta.merkle_root_native(hashes) == delta.merkle_root_host(hashes)


def _scrub_state():
    cap = port_config.TableCapacity(max_agents=16, max_sessions=8, max_vouch_edges=8,
                                    max_sagas=2, max_steps_per_saga=2, max_elevations=4,
                                    delta_log_capacity=64, event_log_capacity=8,
                                    trace_log_capacity=16)
    st = HypervisorState(port_config.HypervisorConfig(capacity=cap), device="cpu")
    for s in range(4):
        slot = st.create_session(f"s:{s}", SessionConfig(), now=0.0)
        for t in range(3 + s):
            st.stage_delta(slot, -1, ts=float(t), change_words=[s, t])
    st.flush_deltas()
    return st


def test_scrubber_strip_routes_agree(monkeypatch):
    """A sweep before and after one flipped digest bit gives the same
    reports on the native strip and on the plain one (the library
    patched off)."""
    reports = []
    for have in (True, False):
        monkeypatch.setattr(native, "HAVE_NATIVE", have)
        st = _scrub_state()
        assert merkle._native_route(st.delta_log.body.device) == have
        scrubber = MerkleScrubber(st, budget=8)
        log = [scrubber.tick() for _ in range(4)]
        st.delta_log.digest[5, 0] ^= 1
        log += [scrubber.tick() for _ in range(4)]
        reports.append((log, scrubber.summary()))
    assert reports[0] == reports[1]
    assert reports[0][1]["mismatches"] > 0


def test_cuda_columns_always_take_the_kernels(monkeypatch):
    """With the library built, a CUDA device still routes every host
    entry (and so the scrubber's strip) to its kernel; only a CPU device
    takes the C++ unit. The reference's `HV_SCRUB_NATIVE` switch has no
    counterpart in the port."""
    assert native.HAVE_NATIVE
    monkeypatch.setenv("HV_SCRUB_NATIVE", "1")
    assert not merkle._native_route(torch.device("cuda"))
    assert not merkle._native_route("cuda:0")
    assert merkle._native_route("cpu")


def test_import_builds_nothing(tmp_path):
    """Importing the package runs no compiler and loads no library: the
    host runtime builds at its first use."""
    code = ("import hypervisor_tpu_torch, hypervisor_tpu_torch.ops.merkle, "
            "hypervisor_tpu_torch.integrity.scrubber, hypervisor_tpu_torch.state\n"
            "from hypervisor_tpu_torch.runtime import native\n"
            "assert not native._loaded and native._lib is None\n"
            "assert 'HAVE_NATIVE' not in vars(native)\n"
            "assert native.HAVE_NATIVE and native._loaded\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)


# ── tests/integration/test_concurrent_ingest.py ──────────────────────


def _state(max_agents: int = 1024) -> HypervisorState:
    return HypervisorState(port_config.HypervisorConfig(
        capacity=port_config.TableCapacity(max_agents=max_agents, max_sessions=16)), device="cpu")


def _producer(state, session_slot, prefix, count, barrier):
    barrier.wait()
    for i in range(count):
        state.enqueue_join(session_slot, f"did:{prefix}:{i}", 0.8)


def _run_producers(st, slot, n_threads, per_thread, prefix, extra_parties=0):
    barrier = threading.Barrier(n_threads + extra_parties)
    threads = [threading.Thread(target=_producer, args=(st, slot, f"{prefix}{t}", per_thread,
                                                        barrier)) for t in range(n_threads)]
    for t in threads:
        t.start()
    return threads, barrier


def test_threaded_producers_one_flush():
    st = _state()
    slot = st.create_session("s:conc", SessionConfig(max_participants=1000))
    threads, _ = _run_producers(st, slot, 8, 25, "t")
    for t in threads:
        t.join()
    status = st.flush_joins()
    assert len(status) == 200 and (status == 0).all()
    assert st.participant_count(slot) == 200
    for t in range(8):
        for i in range(25):
            row = st.agent_row(f"did:t{t}:{i}")
            assert row is not None and row["session"] == slot


def test_producers_interleaved_with_flushes():
    st = _state()
    slot = st.create_session("s:interleave", SessionConfig(max_participants=1000))
    threads, barrier = _run_producers(st, slot, 4, 30, "p", extra_parties=1)
    barrier.wait()
    admitted = 0
    while any(t.is_alive() for t in threads):
        admitted += int((st.flush_joins() == 0).sum())
    for t in threads:
        t.join()
    admitted += int((st.flush_joins() == 0).sum())
    assert admitted == 120 and st.participant_count(slot) == 120


def test_capacity_budget_respected_under_concurrency():
    st = _state()
    slot = st.create_session("s:cap", SessionConfig(max_participants=17))
    threads, _ = _run_producers(st, slot, 6, 10, "c")
    for t in threads:
        t.join()
    status = st.flush_joins()
    assert int((status == 0).sum()) == 17 and st.participant_count(slot) == 17


def test_same_agent_raced_from_many_threads_admits_once():
    st = _state()
    slot = st.create_session("s:dupe", SessionConfig(max_participants=100))
    barrier = threading.Barrier(6)

    def racer():
        barrier.wait()
        st.enqueue_join(slot, "did:same", 0.9)

    threads = [threading.Thread(target=racer) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    status = st.flush_joins()
    assert int((status == 0).sum()) == 1 and st.participant_count(slot) == 1
    did = st.agent_ids.lookup("did:same")
    assert int((st.agents.did.numpy() == did).sum()) == 1


def _joined(st) -> dict:
    """A flush's outcome: per-membership results, members and tables."""
    return {"results": dict(st.last_join_results), "members": sorted(st._members),
            "agents.i32": st.agents.i32.numpy().tobytes(),
            "agents.f32": st.agents.f32.numpy().tobytes(),
            "sessions.i32": st.sessions.i32.numpy().tobytes()}


def test_eight_thread_staging_equals_the_fallback_queue(monkeypatch):
    """8 threads push 256 joins into a port state's native queue: every
    entry claims its own slot, and the flush equals the same joins pushed
    one by one into a fallback-form queue, in the harvested order."""
    st = _state()
    slots = [st.create_session(f"s:{k}", SessionConfig(max_participants=40, min_sigma_eff=0.5))
             for k in range(8)]
    claimed: list[int] = []
    lock = threading.Lock()
    barrier = threading.Barrier(8)

    def producer(t):
        barrier.wait()
        mine = [st.enqueue_join(slots[(t + i) % 8], f"did:{t}:{i % 24}", 0.3 + 0.02 * (i % 30))
                for i in range(32)]
        with lock:
            claimed.extend(mine)

    threads = [threading.Thread(target=producer, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(claimed) == list(range(256))
    order = [(int(st._queue.session[i]), int(st._queue.agent[i])) for i in range(256)]
    pending = {slot: st.agent_ids.string(did) for slot, (did, _s, _d) in st._pending_rows.items()}
    sigmas = st._queue.sigma[:256].copy()
    got = st.flush_joins()
    want_side = _state()
    for k in range(8):
        want_side.create_session(f"s:{k}", SessionConfig(max_participants=40, min_sigma_eff=0.5))
    monkeypatch.setattr(native, "HAVE_NATIVE", False)
    want_side._queue = StagingQueue(capacity=1024)
    for i, (sess, agent) in enumerate(order):
        want_side._next_agent_slot = agent  # claim the same row as the threaded run
        assert want_side.enqueue_join(sess, pending[agent], float(sigmas[i])) == i
    want = want_side.flush_joins()
    _eq(got, want)
    assert _joined(st) == _joined(want_side)
    assert (got == 0).any() and (got != 0).any()


def test_reference_and_port_states_stage_interleaved():
    """The reference's library and the port's are separate files with
    separate staging buffers: interleaved pushes into a reference state
    and a port state both harvest intact (no "staged join(s) lost")."""
    from hypervisor_tpu.config import HypervisorConfig as JaxConfig
    from hypervisor_tpu.config import TableCapacity as JaxCapacity
    from hypervisor_tpu.models import SessionConfig as JaxSessionConfig
    from hypervisor_tpu.state import HypervisorState as JaxState

    assert jax_native.HAVE_NATIVE
    ref = JaxState(JaxConfig(capacity=JaxCapacity(max_agents=64, max_sessions=4)))
    port = _state(64)
    rs = ref.create_session("s:r", JaxSessionConfig(max_participants=32))
    ps = port.create_session("s:p", SessionConfig(max_participants=32))
    for i in range(12):
        ref.enqueue_join(rs, f"did:r{i}", 0.8)
        port.enqueue_join(ps, f"did:p{i}", 0.8)
    ref_status = np.asarray(ref.flush_joins())
    assert len(ref_status) == 12 and (ref_status == 0).all()
    status = port.flush_joins()
    assert len(status) == 12 and (status == 0).all()
    assert port.participant_count(ps) == 12 == ref.participant_count(rs)


def test_second_port_state_mid_epoch_raises_lost_joins():
    """Within the port, one process-global buffer: a second state built
    while the first holds staged joins makes the first's harvest raise,
    as the reference's does."""
    a = _state(64)
    sa = a.create_session("s:a", SessionConfig())
    a.enqueue_join(sa, "did:x", 0.8)
    _state(64)
    with pytest.raises(RuntimeError, match="staged join"):
        a.flush_joins()
    assert a._queue.acknowledge_lost_epoch() == 1
