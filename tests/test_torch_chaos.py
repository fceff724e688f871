"""Chaos runs on the port's saga scheduler against the reference's, on the CPU.

Counterparts of `tests/integration/test_chaos.py`: the port's
`SagaScheduler` over `HypervisorState(device="cpu")` (kernel B7's plain
version through its wrapper) under the port's `ChaosExecutorFactory`.
Each run is also made on the reference (unarmed, `HV_WAVE_PALLAS=0`)
with the same plan seed, and the outcomes must be equal: the saga and
step tables, the executors' completions in order, and the chaos report.
`testing/chaos.py` itself is held to the reference's text apart from the
one function that writes into the tables.
"""

from __future__ import annotations

import ast
import asyncio
import re
from pathlib import Path

import numpy as np
import pytest

import hypervisor_tpu.testing.chaos as jax_chaos
from hypervisor_tpu.models import SessionConfig as JaxSessionConfig
from hypervisor_tpu.runtime.saga_scheduler import SagaScheduler as JaxScheduler
from hypervisor_tpu.state import HypervisorState as JaxState
from hypervisor_tpu_torch.models import SessionConfig
from hypervisor_tpu_torch.ops import saga_ops
from hypervisor_tpu_torch.runtime.saga_scheduler import SagaScheduler
from hypervisor_tpu_torch.state import HypervisorState
from hypervisor_tpu_torch.testing import ChaosExecutorFactory, ChaosPlan
import hypervisor_tpu_torch.testing.chaos as port_chaos


@pytest.fixture(autouse=True)
def unarmed(monkeypatch):
    monkeypatch.setenv("HV_WAVE_PALLAS", "0")


def _run_fleet(seed, fail_rate: float, n_sagas: int = 8, n_steps: int = 4, ref: bool = False):
    if ref:
        st, cfg = JaxState(), JaxSessionConfig()
        chaos = jax_chaos.ChaosExecutorFactory(jax_chaos.ChaosPlan(seed=seed, fail_rate=fail_rate))
        sched = JaxScheduler(st, retry_backoff_seconds=0.0)
    else:
        st, cfg = HypervisorState(device="cpu"), SessionConfig()
        chaos = ChaosExecutorFactory(ChaosPlan(seed=seed, fail_rate=fail_rate))
        sched = SagaScheduler(st, retry_backoff_seconds=0.0)
    sess = st.create_session("session:chaos", cfg)
    completions: list[str] = []
    for g in range(n_sagas):
        slot = st.create_saga(f"saga:chaos{g}", sess,
                              [{"retries": 2, "has_undo": True, "timeout": 5.0}] * n_steps)
        for i in range(n_steps):
            async def work(g=g, i=i):
                completions.append(f"{g}.{i}")
                return "ok"

            async def undo(g=g, i=i):
                completions.append(f"undo:{g}.{i}")
                return "undone"

            sched.register(slot, i, chaos.wrap(work, key=f"{g}.{i}"), undo=undo)
    asyncio.run(sched.run_until_settled())
    return st, chaos, completions, n_sagas


def _tables(st, n: int) -> tuple:
    return np.asarray(st.sagas.saga_state)[:n].tolist(), np.asarray(st.sagas.step_state)[:n].tolist()


def _both(seed, fail_rate):
    """The fleet on the port, after checking it against the reference's."""
    port = _run_fleet(seed, fail_rate)
    ref = _run_fleet(seed, fail_rate, ref=True)
    n = port[3]
    assert _tables(port[0], n) == _tables(ref[0], n)
    assert port[2] == ref[2], "the executors ran in another order"
    assert port[1].report() == ref[1].report()
    return port


def test_every_saga_terminal_under_chaos():
    st, chaos, _, n = _both(seed=11, fail_rate=0.25)
    states = st.sagas.saga_state.numpy()[:n]
    terminal = {saga_ops.SAGA_COMPLETED, saga_ops.SAGA_ESCALATED, saga_ops.SAGA_FAILED}
    assert all(int(s) in terminal for s in states), states
    assert chaos.stats.failures > 0


def test_retry_budgets_absorb_low_fault_rate():
    st, _, _, n = _both(seed=3, fail_rate=0.10)
    states = st.sagas.saga_state.numpy()[:n]
    completed = int((states == saga_ops.SAGA_COMPLETED).sum())
    assert completed >= n - 1, (completed, states.tolist())


def test_exhausted_steps_compensate_committed_prefix():
    st, _, completions, n = _both(seed=1234, fail_rate=0.55)
    step_state = st.sagas.step_state.numpy()
    saga_state = st.sagas.saga_state.numpy()
    for g in range(n):
        if int(saga_state[g]) == saga_ops.SAGA_COMPLETED:
            continue
        assert not (step_state[g] == saga_ops.STEP_COMMITTED).any()
    assert any(c.startswith("undo:") for c in completions)


def test_chaos_replays_identically_from_seed():
    st1, chaos1, _, n = _both(seed=99, fail_rate=0.3)
    st2, chaos2, _, _ = _run_fleet(seed=99, fail_rate=0.3)
    assert _tables(st1, n) == _tables(st2, n)
    assert chaos1.report() == chaos2.report()


def _hang_run(ref: bool):
    if ref:
        st, cfg, mod, sched_cls = JaxState(), JaxSessionConfig(), jax_chaos, JaxScheduler
    else:
        st, cfg, mod, sched_cls = HypervisorState(device="cpu"), SessionConfig(), port_chaos, \
            SagaScheduler
    sess = st.create_session("session:hang", cfg)
    slot = st.create_saga("saga:hang", sess, [{"retries": 0, "has_undo": False, "timeout": 0.05}])
    chaos = mod.ChaosExecutorFactory(mod.ChaosPlan(seed=0, fail_rate=0.0, hang_rate=1.0,
                                                   hang_seconds=5.0))
    sched = sched_cls(st, retry_backoff_seconds=0.0)

    async def fine():
        return "ok"

    sched.register(slot, 0, chaos.wrap(fine, key="h"))
    asyncio.run(sched.run_until_settled())
    return st, chaos, slot


def test_hang_injection_hits_step_timeout():
    st, chaos, slot = _hang_run(ref=False)
    ref_st, ref_chaos, _ = _hang_run(ref=True)
    assert chaos.stats.hangs == 1 == ref_chaos.stats.hangs
    assert int(st.sagas.saga_state[slot]) in (saga_ops.SAGA_COMPLETED, saga_ops.SAGA_ESCALATED)
    assert int(st.sagas.step_state[slot, 0]) == saga_ops.STEP_FAILED
    assert _tables(st, 1) == _tables(ref_st, 1)


def _without_apply_one(path: Path) -> str:
    """A module's text with `WaveChaosInjector._apply_one` cut out."""
    text = path.read_text()
    tree = ast.parse(text)
    (fn,) = [n for n in ast.walk(tree)
             if isinstance(n, ast.FunctionDef) and n.name == "_apply_one"]
    lines = text.splitlines(keepends=True)
    return "".join(lines[:fn.lineno - 1] + lines[fn.end_lineno:])


def test_chaos_module_is_the_reference_text_but_its_table_writes():
    """Everything in `testing/chaos.py` but `_apply_one` (which writes its
    corruptions into the port's tensors) is the reference's text with the
    imports pointed at the port."""
    ref = re.sub(r"\bhypervisor_tpu\b", "hypervisor_tpu_torch",
                 _without_apply_one(Path(jax_chaos.__file__)))
    assert _without_apply_one(Path(port_chaos.__file__)) == ref
