"""The DeltaLog wrap's session-state read, held to the reference's.

When a wave's ring rows recycle rows of earlier sessions, the port reads
back only the recycled sessions' states (gathered on the device), where
the reference reads the whole session-state column. One seeded sequence
runs on the JAX package's `HypervisorState` and on the port's
(`device="cpu"`), with the DeltaLog cut to 20 rows:

  * seven lifecycle waves of four fresh sessions, three turns each (12
    rows a wave), so the ring wraps on every wave from the second on and
    goes round four times; after each wave every session the wave booked
    has its packed bodies read, so the wraps have cached bodies to drop;
  * then two of the sessions the eighth wave recycles, and one it does
    not, are set back to ACTIVE in the device's session table, and the
    eighth wave must be refused naming the two, in ascending order,
    before anything is evicted.

Held equal after every wave: the audit index, the Merkle frontiers, the
keys of the packed-body cache and the ring-row ownership.
"""

from __future__ import annotations

import numpy as np
import pytest

from hypervisor_tpu import config as jax_config
from hypervisor_tpu.state import HypervisorState as JaxState
from hypervisor_tpu.tables.struct import replace as jax_replace
from hypervisor_tpu_torch import config as port_config
from hypervisor_tpu_torch.models import SessionState
from hypervisor_tpu_torch.state import HypervisorState as PortState
from hypervisor_tpu_torch.tables.state import SI32_STATE
from tests.test_torch_facade import _assert_same, _on_both, _Port, _Ref

K, T, RING, WAVES = 4, 3, 20, 7
CAP = dict(max_agents=16, max_sessions=40, max_vouch_edges=16, delta_log_capacity=RING,
           trace_log_capacity=32)
#: Wave 7 writes ring rows 4..15 (its base is 7 * 12 = 84, mod 20). After
#: wave 6 their owners are wave 5's sessions 21 (rows 4, 5), 22 (6..8) and
#: 23 (9..11) and wave 6's sessions 24 (12..14) and 25 (15). Sessions 24
#: and 21 are set live (in that order) and must be named ascending;
#: session 26 (rows 18, 19, 0) is set live too, but wave 7 recycles none
#: of its rows.
FORCED_LIVE = (24, 21, 26)
REFUSED = [21, 24]
ACTIVE = SessionState.ACTIVE.code


class _WrapRef(_Ref):
    def __init__(self):
        self.st = JaxState(jax_config.HypervisorConfig(capacity=jax_config.TableCapacity(
            **CAP, max_sagas=8, max_steps_per_saga=4, max_elevations=8, event_log_capacity=16,
        )))

    def set_state(self, slot, code):
        s = self.st.sessions
        self.st.sessions = jax_replace(s, state=s.state.at[slot].set(code))


class _WrapPort(_Port):
    def __init__(self):
        self.st = PortState(port_config.HypervisorConfig(
            capacity=port_config.TableCapacity(**CAP)), device="cpu")

    def set_state(self, slot, code):
        self.st.sessions.i32[slot, SI32_STATE] = code


def _evictions(st) -> dict:
    """What a wrap may evict, read without hashing (a frontier's root
    would add to its hash count)."""
    return {"audit_rows": {s: list(r) for s, r in st._audit_rows.items()},
            "frontier": {s: (f.count, f.hash_count, f.to_meta()["nodes"])
                         for s, f in st._frontier.items()},
            "packed_bodies": sorted(st._packed_bodies), "row_session": st._row_session.tolist(),
            "turns": dict(st._turns)}


def _run_wraps(side) -> list[tuple[str, object]]:
    log: list[tuple[str, object]] = []
    st = side.st
    rng = np.random.RandomState(27)
    cfg = side.session_config(min_sigma_eff=0.55, max_participants=1)
    for w in range(WAVES + 1):
        slots = st.create_sessions_batch([f"wr{w}:s{i}" for i in range(K)], cfg)
        assert slots.tolist() == list(range(K * w, K * (w + 1)))
        bodies = rng.randint(0, 2**32, (T, K, 16), dtype=np.uint64).astype(np.uint32)
        sigma = rng.uniform(0.3, 1.0, K).astype(np.float32)
        args = (slots, [f"did:wr{w}:{i}" for i in range(K)], slots, sigma, bodies)
        if w == WAVES:
            for slot in FORCED_LIVE:
                side.set_state(slot, ACTIVE)
            before = _evictions(st)
            with pytest.raises(RuntimeError) as refused:
                st.run_governance_wave(*args, now=10.0 + w, omega=0.5)
            log.append(("refused", str(refused.value)))
            log.append(("refused:host", _evictions(st)))
            log.append(("refused:unchanged", _evictions(st) == before))
            return log
        st.run_governance_wave(*args, now=10.0 + w, omega=0.5)
        for s in slots:
            st.session_packed_bodies(int(s))
        log.append((f"wave{w}", _evictions(st)))
    return log


@pytest.fixture(scope="module")
def wrap_runs():
    ref, port, _ = _on_both(_run_wraps, _WrapRef, _WrapPort)
    return dict(ref), dict(port)


@pytest.mark.parametrize("step", [f"wave{w}" for w in range(WAVES)])
def test_wrap_evictions_match_reference(wrap_runs, step):
    ref, port = wrap_runs
    _assert_same(step, port[step], ref[step])
    w = int(step[4:])
    got = port[step]
    # The wave's own sessions keep every row, their frontier and their bodies.
    for s in range(K * w, K * (w + 1)):
        assert len(got["audit_rows"][s]) == T and s in got["frontier"]
        assert s in got["packed_bodies"]
    if w:
        # A wrap evicted something: some earlier session lost rows, and
        # with them its frontier and its cached bodies.
        cut = [s for s in range(K * w) if len(got["audit_rows"][s]) < T]
        assert cut and all(s not in got["frontier"] and s not in got["packed_bodies"]
                           for s in cut)


def test_live_wrap_refusal_names_the_recycled_live_slots(wrap_runs):
    ref, port = wrap_runs
    want = (f"delta log wrapped into live session slot(s) {REFUSED}; their audit trails "
            "would lose leaves. Raise config.capacity.delta_log_capacity or terminate "
            "sessions before their logs are overwritten.")
    assert port["refused"] == ref["refused"] == want
    _assert_same("refused:host", port["refused:host"], ref["refused:host"])
    assert port["refused:unchanged"] and ref["refused:unchanged"]
