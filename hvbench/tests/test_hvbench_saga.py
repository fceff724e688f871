"""The saga cell at a tiny size on the CPU: a sound run is correct, and a
run with the saga plane broken underneath is not, once for each fault
the cell is there to catch: one retry too many, a compensation out of
reverse order, a missing escalation."""

from __future__ import annotations

import json
import time

import pytest
import torch

from hvbench import harness
from hvbench.tests.conftest import SEED, make_tiny
from hypervisor_tpu_torch.ops import saga_ops
from hypervisor_tpu_torch.state import HypervisorState

SAGAS = 96


@pytest.fixture(scope="module")
def tiny_saga(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout_saga")
    bench = make_tiny(root)
    cfg = root / "hvbench/configs/saga10k.json"
    c = json.loads(cfg.read_text())
    c.update(actors=SAGAS)
    c["capacity"].update(max_agents=SAGAS + 64, max_sessions=SAGAS + 64, max_sagas=4096,
                         max_vouch_edges=256, max_elevations=64, delta_log_capacity=128,
                         event_log_capacity=256, trace_log_capacity=256)
    cfg.write_text(json.dumps(c))
    f = root / "hvbench/traffic/txn5.json"
    t = json.loads(f.read_text())
    t.update(sagas=SAGAS, warmup_calls=1, profile_calls=1, check_calls=2)
    f.write_text(json.dumps(t))
    return root, bench


def run(tiny_saga, trace=False):
    root, bench = tiny_saga
    return harness.run_cell(bench, "saga10k.txn5", SEED, 0.5, trace, "cpu",
                            time.perf_counter(), root)


def test_a_sound_run_is_correct_and_traced_reads_every_metric(tiny_saga):
    line, checks = run(tiny_saga)
    assert line["correct"], checks
    line, checks = run(tiny_saga, trace=True)
    assert line["correct"], checks
    assert {"saga_create_ms", "saga_reads_ms", "saga_book_ms", "saga_scheduler_ms",
            "call_ms_p95"} <= set(
        line["metrics"])


def one_retry_too_many(monkeypatch):
    create = HypervisorState.create_sagas

    def more(self, ids, sessions, steps):
        bumped = [[{**st, "retries": st.get("retries", 0) + 1} for st in sts] for sts in steps]
        return create(self, ids, sessions, bumped)
    monkeypatch.setattr(HypervisorState, "create_sagas", more)


def compensation_out_of_order(monkeypatch):
    work = HypervisorState.saga_work

    def lowest_first(self, comp_budget=None):
        execute, compensate = work(self, comp_budget)
        out = []
        for slot, _ in compensate:
            committed = (self.sagas.step_state[slot] == saga_ops.STEP_COMMITTED).nonzero()
            out.append((slot, int(committed[0])))
        return execute, out
    monkeypatch.setattr(HypervisorState, "saga_work", lowest_first)


def missing_escalation(monkeypatch):
    book = HypervisorState.saga_round

    def no_escalation(self, *args, **kwargs):
        book(self, *args, **kwargs)
        s = self.sagas.saga_state
        s.copy_(torch.where(s == saga_ops.SAGA_ESCALATED,
                            torch.full_like(s, saga_ops.SAGA_COMPLETED), s))
    monkeypatch.setattr(HypervisorState, "saga_round", no_escalation)


@pytest.mark.parametrize("fault", [one_retry_too_many, compensation_out_of_order,
                                   missing_escalation])
def test_a_broken_saga_plane_is_not_correct(tiny_saga, monkeypatch, fault):
    fault(monkeypatch)
    line, checks = run(tiny_saga)
    assert not line["correct"], checks
    assert line["failed"] >= 1
