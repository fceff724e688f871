"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have: a step that returns its state unchanged,
half of the batch left out (the sums scaled up from the rest), an answer
altered where it is produced, in the wave and in the host's audit
booking. The cells run on one device, so no exchange between chips can
be left out."""

from __future__ import annotations

import time

import pytest
import torch

from hvbench import harness
from hvbench.tests.conftest import SEED


def run(tiny, workload):
    root, bench = tiny
    line, checks = harness.run_cell(bench, workload, SEED, 0.5, False, "cpu",
                                    time.perf_counter(), root)
    return line, checks


def stale_wave(wave):
    """Every call returns the first call's result unchanged (the tables
    still move, so the state's bookkeeping runs on)."""
    first = []

    def call(*args, **kwargs):
        result = wave(*args, **kwargs)
        if not first:
            first.append(result)
        return first[0]
    return call


def half_wave(wave):
    """The wave admits only the first half of its lanes: the rest ride as
    duplicates, which the wave refuses and leaves out of its tallies."""
    def call(*args, **kwargs):
        args = list(args)
        dup = args[8].clone()
        dup[dup.shape[0] // 2:] = True
        args[8] = dup
        return wave(*args, **kwargs)
    return call


def altered_wave(wave):
    """One bit of the first session's Merkle root flipped as it is made."""
    def call(*args, **kwargs):
        result = wave(*args, **kwargs)
        root = result.merkle_root.clone()
        root[0, 0] ^= 1
        return result._replace(merkle_root=root)
    return call


@pytest.mark.parametrize("workload", ("gov10k.wave10k", "gov10k_2m.wave32"))
@pytest.mark.parametrize("fault", (stale_wave, half_wave, altered_wave))
def test_a_broken_wave_is_not_correct(tiny_unwrapped, monkeypatch, workload, fault):
    from hypervisor_tpu_torch import state as state_mod

    monkeypatch.setattr(state_mod, "_WAVE", fault(state_mod._WAVE))
    line, checks = run(tiny_unwrapped, workload)
    assert line["correct"] is False and line["failed"] >= 1, checks


def altered_booking(book):
    """One bit of the first session's first digest flipped in the host
    copy of the chain that the audit booking files."""
    def call(self, session_slots, chain, base_row):
        chain = chain.copy()
        chain[0, 0, 0] ^= 1
        return book(self, session_slots, chain, base_row)
    return call


def skipped_booking(book):
    """The audit booking files the first wave only; later waves leave no
    frontier and no audit rows."""
    done = []

    def call(self, *args):
        if not done:
            done.append(True)
            return book(self, *args)
    return call


@pytest.mark.parametrize("workload", ("gov10k.wave10k", "gov10k_2m.wave32"))
@pytest.mark.parametrize("fault", (altered_booking, skipped_booking))
def test_a_broken_audit_booking_is_not_correct(tiny_unwrapped, monkeypatch, workload, fault):
    from hypervisor_tpu_torch.state import HypervisorState

    monkeypatch.setattr(HypervisorState, "_book_wave_audit",
                        fault(HypervisorState._book_wave_audit))
    line, checks = run(tiny_unwrapped, workload)
    assert line["correct"] is False and line["failed"] >= 1, checks
    assert checks["frontier_roots"]["value"] + checks["audit_index"]["value"] > 0, checks


def stale_pipeline(fn):
    """Every call returns the first call's result unchanged."""
    first = []

    def call(**kw):
        result = fn(**kw)
        if not first:
            first.append(result)
        return first[0]
    return call


def half_pipeline(fn):
    """The first half of the lanes computed; the rest copied from it and
    the consensus sums doubled from the half's."""
    def call(delta_bodies, **kw):
        s = delta_bodies.shape[1]
        h = s // 2
        half = fn(delta_bodies=delta_bodies[:, :h], **{
            k: (v[:h] if isinstance(v, torch.Tensor) and v.dim() == 1 and v.shape[0] == s else v)
            for k, v in kw.items()})
        grow = lambda t: torch.cat([t, t[:s - h]])  # noqa: E731
        return half._replace(**{f: grow(getattr(half, f)) for f in half._fields
                                if f != "consensus"}, consensus=half.consensus * 2)
    return call


def altered_pipeline(fn):
    def call(**kw):
        result = fn(**kw)
        status = result.status.clone()
        status[0] = 1
        return result._replace(status=status)
    return call


@pytest.mark.parametrize("fault", (stale_pipeline, half_pipeline, altered_pipeline))
def test_a_broken_pipeline_is_not_correct(tiny, monkeypatch, fault):
    from hypervisor_tpu_torch.ops import pipeline

    monkeypatch.setattr(pipeline, "governance_pipeline", fault(pipeline.governance_pipeline))
    line, checks = run(tiny, "pipeline10k.headline")
    assert line["correct"] is False and line["failed"] >= 1, checks
