"""The port's device logs against the reference, on the CPU.

`DeltaLog` appends (whole batches and live prefixes, wrapping the ring)
and `TraceLog` stamps (sampled and unsampled) go through the JAX
package's tables and the port's on the same seeded inputs; the B6 ring
append's plain version, and B2's ring form (the chain with the append)
through its wrapper, are held against the reference's numpy twins
`ring_append_np` and `chain_digests_np`; and a seeded reference state's `delta_log.*` columns
round-trip through `tables.from_state_arrays`/`to_state_arrays`.
Tolerance 0 everywhere.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervisor_tpu.config import HypervisorConfig, TableCapacity
from hypervisor_tpu.kernels.mtu_pallas import chain_digests_np
from hypervisor_tpu.kernels.wave_pallas import ring_append_np
from hypervisor_tpu.models import SessionConfig
from hypervisor_tpu.runtime.checkpoint import state_arrays
from hypervisor_tpu.state import HypervisorState
from hypervisor_tpu.tables.logs import DeltaLog as JaxDeltaLog
from hypervisor_tpu.tables.logs import TraceLog as JaxTraceLog
from hypervisor_tpu.tables.struct import replace as jax_replace
from hypervisor_tpu_torch import tables as port_tables
from hypervisor_tpu_torch import u32
from hypervisor_tpu_torch.kernels import mtu, wave
from hypervisor_tpu_torch.tables.logs import DeltaLog, TraceLog

C = 16  # ring rows


def _records(rng, b):
    return (
        rng.randint(0, 2**32, (b, 16), dtype=np.uint64).astype(np.uint32),
        rng.randint(0, 2**32, (b, 8), dtype=np.uint64).astype(np.uint32),
        rng.randint(0, 50, b).astype(np.int32),
        rng.randint(0, 9, b).astype(np.int32),
    )


def _assert_delta_logs_equal(port: DeltaLog, ref: JaxDeltaLog) -> None:
    for col in ("body", "digest"):
        np.testing.assert_array_equal(u32.to_numpy_u32(getattr(port, col)),
                                      np.asarray(getattr(ref, col)), err_msg=col)
    for col in ("session", "turn", "cursor"):
        got, want = getattr(port, col).numpy(), np.asarray(getattr(ref, col))
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), col


@pytest.mark.parametrize("batches", [
    [(5, None), (7, None), (9, None)],   # the third batch wraps
    [(6, 4), (10, 10), (8, 0), (12, 5)],  # short prefixes, an empty one, a wrap
])
def test_delta_log_appends_match_reference(batches):
    rng = np.random.RandomState(len(batches))
    ref = JaxDeltaLog.create(C)
    port = DeltaLog.create(C, "cpu")
    for b, n_live in batches:
        body, digest, sess, turn = _records(rng, b)
        port_args = (u32.from_numpy_u32(body, "cpu"), u32.from_numpy_u32(digest, "cpu"),
                     torch.from_numpy(sess), torch.from_numpy(turn))
        ref_args = tuple(jnp.asarray(a) for a in (body, digest, sess, turn))
        if n_live is None:
            ref = ref.append_batch(*ref_args)
            port.append_batch(*port_args)
        else:
            ref = ref.append_batch_prefix(*ref_args, jnp.int32(n_live))
            port.append_batch_prefix(*port_args, n_live)
        _assert_delta_logs_equal(port, ref)
    assert int(np.asarray(ref.cursor)) > C  # the ring wrapped


@pytest.mark.parametrize("t,k,cursor,n_live", [
    (3, 5, 0, 15), (3, 5, 9, 15), (2, 6, 13, 7), (3, 4, 30, 0), (1, 16, 4, 16),
])
def test_ring_append_plain_matches_ring_append_np(t, k, cursor, n_live):
    """The twin rule: B6's plain version `ring_append_plain` against the
    reference's numpy oracle `ring_append_np`, from the same ring."""
    rng = np.random.RandomState(100 * t + k + cursor)
    ring = _records(rng, C)
    bodies = rng.randint(0, 2**32, (t, k, 16), dtype=np.uint64).astype(np.uint32)
    chain = rng.randint(0, 2**32, (t, k, 8), dtype=np.uint64).astype(np.uint32)
    sessions = rng.randint(0, 100, k).astype(np.int32)

    want = ring_append_np(
        *ring, np.int32(cursor),
        np.transpose(bodies, (1, 0, 2)).reshape(k * t, 16),
        np.transpose(chain, (1, 0, 2)).reshape(k * t, 8),
        np.repeat(sessions, t), np.tile(np.arange(t, dtype=np.int32), k), np.int32(n_live),
    )
    def port_ring():
        return DeltaLog(
            body=u32.from_numpy_u32(ring[0], "cpu"), digest=u32.from_numpy_u32(ring[1], "cpu"),
            session=torch.from_numpy(ring[2].copy()), turn=torch.from_numpy(ring[3].copy()),
            cursor=torch.tensor(cursor, dtype=torch.int32),
        )

    port = port_ring()
    args = (u32.from_numpy_u32(bodies, "cpu"), u32.from_numpy_u32(chain, "cpu"),
            torch.from_numpy(sessions), cursor, n_live)
    wave.ring_append_plain(port, *args)
    _assert_delta_logs_equal(port, JaxDeltaLog(*(jnp.asarray(a) for a in want)))

    # B2's ring form takes its plain pair for CPU tensors, counts no
    # launch, and appends the chain it computes from the bodies.
    again = port_ring()
    seeds = rng.randint(0, 2**32, (k, 8), dtype=np.uint64).astype(np.uint32)
    chain_np = chain_digests_np(bodies, seeds)
    want_ring = ring_append_np(
        *ring, np.int32(cursor),
        np.transpose(bodies, (1, 0, 2)).reshape(k * t, 16),
        np.transpose(chain_np, (1, 0, 2)).reshape(k * t, 8),
        np.repeat(sessions, t), np.tile(np.arange(t, dtype=np.int32), k), np.int32(n_live),
    )
    mtu.chain_digests_ring.launches = 0
    got_chain = mtu.chain_digests_ring(
        u32.from_numpy_u32(bodies, "cpu"), u32.from_numpy_u32(seeds, "cpu"), again,
        torch.from_numpy(sessions), cursor, n_live)
    assert mtu.chain_digests_ring.launches == 0
    np.testing.assert_array_equal(u32.to_numpy_u32(got_chain), chain_np)
    _assert_delta_logs_equal(again, JaxDeltaLog(*(jnp.asarray(a) for a in want_ring)))


def test_ring_append_refuses_more_live_rows_than_the_ring_holds():
    log = DeltaLog.create(4, "cpu")
    bodies = torch.zeros((2, 3, 16), dtype=torch.int32)
    seeds = torch.zeros((3, 8), dtype=torch.int32)
    sessions = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="exceed the ring"):
        mtu.chain_digests_ring(bodies, seeds, log, sessions, 0, 6)
    with pytest.raises(ValueError, match="n_live"):
        mtu.chain_digests_ring(bodies, seeds, log, sessions, 0, 7)
    mtu.chain_digests_ring(bodies, seeds, log, sessions, 0, 4)
    assert int(log.cursor) == 4


@pytest.mark.parametrize("sampled", [True, False])
def test_trace_log_stamps_match_reference(sampled):
    rng = np.random.RandomState(7)
    cap = 10
    ref = JaxTraceLog.create(cap)
    port = TraceLog.create(cap, "cpu")
    np.testing.assert_array_equal(port.words.numpy().view(np.uint32), np.asarray(ref.words))
    for b in (4, 5, 6):  # the third batch wraps
        traces = rng.randint(0, 2**32, b, dtype=np.uint64).astype(np.uint32)
        spans = rng.randint(0, 2**32, b, dtype=np.uint64).astype(np.uint32)
        stages = rng.randint(0, 12, b).astype(np.int32)
        kinds = rng.randint(0, 2, b).astype(np.int32)
        lanes = rng.randint(-1, 10_000, b).astype(np.int32)
        wave_seqs = np.full(b, 3, np.int32)
        ref = ref.stamp_batch(
            jnp.asarray(traces), jnp.asarray(spans), jnp.asarray(stages), jnp.asarray(kinds),
            jnp.asarray(lanes), jnp.asarray(wave_seqs), sampled=jnp.asarray(sampled),
        )
        port.stamp_batch(traces.astype(np.int64), spans.astype(np.int64), stages, kinds, lanes,
                         wave_seqs, sampled=sampled)
        np.testing.assert_array_equal(port.words.numpy().view(np.uint32), np.asarray(ref.words))
        assert int(port.cursor) == int(np.asarray(ref.cursor))
    assert int(port.cursor) == (15 if sampled else 0)


def test_delta_log_round_trips_through_state_arrays():
    """A seeded reference state with a wrapped DeltaLog loads into port
    tables and writes back byte-identical, u32 columns as uint32."""
    state = HypervisorState(HypervisorConfig(capacity=TableCapacity(
        max_agents=64, max_sessions=32, max_vouch_edges=64, max_sagas=8, max_steps_per_saga=4,
        max_elevations=8, delta_log_capacity=8, event_log_capacity=16, trace_log_capacity=16,
    )))
    s = state.create_sessions_batch(["a", "b"], SessionConfig())
    rng = np.random.RandomState(3)
    for turn in range(7):
        for slot in s:
            state.stage_delta(int(slot), 0, ts=float(turn), change_words=rng.randint(0, 9, 8))
        if turn % 3 == 2:
            # Archive both sessions, so the ring may wrap over their rows.
            state.sessions = jax_replace(state.sessions, state=state.sessions.state.at[s].set(4))
            state.flush_deltas(use_pallas=False)
    arrays = state_arrays(state)
    assert int(arrays["delta_log.cursor"]) > 8
    assert arrays["delta_log.body"].dtype == np.uint32
    tables = port_tables.from_state_arrays(arrays, "cpu")
    assert tables.delta_log is not None and tables.delta_log.body.dtype == torch.int32
    back = port_tables.to_state_arrays(tables)
    want = {k: v for k, v in arrays.items()
            if k.split(".")[0] in ("agents", "sessions", "vouches", "delta_log", "sagas",
                                    "elevations", "event_log")}
    assert sorted(back) == sorted(want)
    for key, value in want.items():
        assert back[key].dtype == value.dtype and back[key].shape == value.shape, key
        assert back[key].tobytes() == value.tobytes(), key
