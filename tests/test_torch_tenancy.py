"""The port's tenant arena against the reference's, on the CPU.

Counterparts of `tests/unit/test_tenancy.py`'s arena cases on
`hypervisor_tpu_torch.tenancy.TenantArena(device="cpu")`: one seeded
sequence of batched session creates and batched governance waves runs on
the reference's arena (unarmed, `HV_WAVE_PALLAS=0`) and on the port's,
and every tenant's tables, DeltaLog, metrics table, chain heads, roots
and host indices are held equal (tolerance 0), and equal to the port's
own solo waves (`run_governance_wave(..., pad_to=(bucket, bucket))`).
Also: idle tenants, the lend/commit protocol with
its observable counts (`sync()`'s return, the `_dirty` sets), a tenant's
WAL replayed through the solo handlers, `recover_tenant` + `splice_tenant`,
the one-read drain fanned into per-tenant snapshots and a `tenant=`
labelled exposition, the stale-gauge refresh, footprints published
without lending a slice, and each kernel's tenant form: its plain version
against a loop of the solo plain version over per-tenant copies.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import hypervisor_tpu as REF
import hypervisor_tpu_torch as PORT
from hypervisor_tpu.runtime.checkpoint import state_arrays as ref_state_arrays
from hypervisor_tpu_torch.kernels import mtu, wave
from hypervisor_tpu_torch.ops import pipeline
from hypervisor_tpu_torch.runtime.checkpoint import state_arrays as port_state_arrays
from hypervisor_tpu_torch.tables import struct
from hypervisor_tpu_torch.tables.logs import DeltaLog
from hypervisor_tpu_torch.tables.state import AgentTable, SessionTable, VouchTable
from tests.test_torch_facade_api import assert_same
from tests.test_torch_metrics import masked, prom_masked
from tests.test_torch_serving import Pkg, deterministic

#: The reference's tenancy-test tables and shapes (`tests/unit/test_tenancy.py`).
SMALL = dict(max_agents=64, max_sessions=64, max_vouch_edges=64, max_sagas=16,
             max_steps_per_saga=4, max_elevations=16, delta_log_capacity=256,
             event_log_capacity=64, trace_log_capacity=64)
T, BUCKET, TURNS = 3, 4, 2
_METRICS = ("counters", "gauges", "hist", "hist_sum", "bounds")


def config(P: Pkg):
    cfg = P.mod("config")
    return cfg.HypervisorConfig(capacity=cfg.TableCapacity(**SMALL))


def arena_of(P: Pkg, n: int = T):
    tenancy = P.mod("tenancy")
    if P.is_ref:
        return tenancy.TenantArena(n, config(P))
    return tenancy.TenantArena(n, config(P), device="cpu")


def scfg(P: Pkg):
    return P.mod("models").SessionConfig(min_sigma_eff=0.0, max_participants=4)


def workload(t: int, r: int) -> dict:
    """The reference test's workload: 2, 1 and 3 lifecycles a round."""
    k = [2, 1, 3][t % 3]
    rg = np.random.RandomState(100 * t + r)
    return {
        "ids": [f"s:{t}:{r}:{i}" for i in range(k)],
        "dids": [f"did:{t}:{r}:{i}" for i in range(k)],
        "sigma": rg.uniform(0.4, 0.9, k).astype(np.float32),
        "bodies": rg.randint(0, 2**32, (TURNS, k, 16), dtype=np.uint64).astype(np.uint32),
    }


def vouch(st, slots, t: int) -> None:
    """One live edge toward each of the round's joiners but the last (the
    rows the wave claims next), from a voucher at the table's end."""
    for i in range(len(slots) - 1):
        st.add_vouch(SMALL["max_agents"] - 1 - i, st._next_agent_slot + i, int(slots[i]),
                     0.1 + 0.05 * t)


def drive_round(P: Pkg, arena, r: int, tenants=None, vouched: bool = False) -> dict:
    tenants = range(arena.num_tenants) if tenants is None else tenants
    w = {t: workload(t, r) for t in tenants}
    slots = arena.create_sessions_batch({t: w[t]["ids"] for t in w}, scfg(P), pad_to=BUCKET)
    if vouched:
        for t in w:
            vouch(arena.tenants[t], slots[t], t)
    return arena.governance_wave_batch(
        {t: {"session_slots": slots[t], "dids": w[t]["dids"],
             "agent_sessions": slots[t].copy(), "sigma_raw": w[t]["sigma"],
             "delta_bodies": w[t]["bodies"]} for t in w},
        BUCKET, now=float(r))


def drive_solo(P: Pkg, st, t: int, rounds, vouched: bool = False) -> list:
    roots = []
    for r in rounds:
        w = workload(t, r)
        slots = st.create_sessions_batch(w["ids"], scfg(P))
        if vouched:
            vouch(st, slots, t)
        res = st.run_governance_wave(slots, w["dids"], slots.copy(), w["sigma"], w["bodies"],
                                     now=float(r), pad_to=(BUCKET, BUCKET))
        roots.append(np.asarray(res.merkle_root).astype(np.uint32)
                     if P.is_ref else res.merkle_root.numpy().view(np.uint32))
    return roots


def tables(P: Pkg, st) -> dict:
    """A state's device tables and metrics table as numpy (u32 as uint32)."""
    if P.is_ref:
        out = ref_state_arrays(st)
        out.update({f"metrics.{c}": np.array(getattr(st.metrics.table, c)) for c in _METRICS})
        return out
    out = port_state_arrays(st)
    for c in _METRICS:
        a = getattr(st.metrics.table, c).numpy().copy()
        out[f"metrics.{c}"] = a.view(np.uint32) if c in ("counters", "hist") else a
    return out


def host(st) -> dict:
    return {
        "chain_seed": {int(s): np.asarray(v, np.uint32) for s, v in st._chain_seed.items()},
        "members": sorted(st._members), "turns": dict(st._turns),
        "audit_rows": {int(s): list(v) for s, v in st._audit_rows.items()},
        "free_agent_slots": list(st._free_agent_slots),
        "cursors": (st._next_agent_slot, st._next_session_slot, st._next_edge_slot),
    }


def outs_record(outs: dict) -> dict:
    return {t: {"status": np.asarray(o.status, np.int8),
                "merkle_root": np.asarray(o.merkle_root, np.uint32),
                "fsm_error": np.asarray(o.fsm_error, bool)} for t, o in outs.items()}


def both(drive):
    """`drive(Pkg)` on the reference, then on the port, unarmed and with
    the roofline off, under the serving tests' deterministic ids and
    clocks plus the tenant scheduler's clock."""
    from tests.test_torch_serving import FakeClock

    outs = []
    with pytest.MonkeyPatch.context() as env:
        env.setenv("HV_WAVE_PALLAS", "0")
        env.setenv("HV_ROOFLINE", "0")
        for name in ("HV_TRACE", "HV_TRACE_SAMPLE", "HV_INTEGRITY_EVERY", "HV_SCRUB_EVERY"):
            env.delenv(name, raising=False)
        for pkg in (REF, PORT):
            with pytest.MonkeyPatch.context() as mp:
                deterministic(mp, pkg)
                P = Pkg(pkg)
                mp.setattr(P.mod("tenancy.front_door"), "time", FakeClock())
                outs.append(drive(P))
    return outs[0], outs[1]


def same(drive):
    ref, port = both(drive)
    assert_same("record", port, ref)
    return port


# ── 1. the batched wave: the reference's arena and the port's solo waves ─


@pytest.mark.parametrize("vouched", [False, True], ids=["bare", "vouched"])
def test_batched_wave_matches_reference_arena_and_solo_waves(vouched):
    def drive(P):
        arena = arena_of(P)
        rounds = [outs_record(drive_round(P, arena, r, vouched=vouched)) for r in range(3)]
        return {"rounds": rounds,
                "tenants": [(tables(P, st), host(st)) for st in arena.tenants]}

    rec = same(drive)
    P = Pkg(PORT)
    for t in range(T):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("HV_TRACE", "0")  # the tenant wave stamps no trace ring
            solo = PORT.state.HypervisorState(config(P), device="cpu")
        roots = drive_solo(P, solo, t, range(3), vouched=vouched)
        assert_same(f"tenant {t} tables", rec["tenants"][t][0], tables(P, solo))
        assert_same(f"tenant {t} host", rec["tenants"][t][1], host(solo))
        for r in range(3):
            assert_same(f"tenant {t} round {r} roots", rec["rounds"][r][t]["merkle_root"],
                        roots[r])


def test_idle_tenants_ride_as_padding_untouched():
    def drive(P):
        arena = arena_of(P)
        before = tables(P, arena.tenants[2])
        out = drive_round(P, arena, 0, tenants=[0])
        after = tables(P, arena.tenants[2])
        for name in ("agents", "sessions", "vouches", "delta_log"):
            for k in before:
                if k.startswith(name + "."):
                    assert_same(k, after[k], before[k])
        return {"served": sorted(out), "idle_host": host(arena.tenants[2]),
                "tenants": [(tables(P, st), host(st)) for st in arena.tenants]}

    rec = same(drive)
    assert rec["served"] == [0] and rec["idle_host"]["members"] == []


def test_lend_commit_roundtrip_with_solo_ops_between_waves():
    """A slow-path op (a risk write) and a solo wave on one tenant between
    batched waves land in the stack; the `_dirty` sets and `sync()`'s
    counts are the reference's at every step, and the tenant stays equal
    to a solo twin running the same sequence."""

    def dirty(arena) -> dict:
        return {k: sorted(v) for k, v in arena._dirty.items()}

    def drive(P):
        arena = arena_of(P)
        log = []
        drive_round(P, arena, 0)
        log.append(("after wave", dirty(arena), arena.sync()))
        arena.tenants[1].set_agent_risk(0, 0.7)
        log.append(("after risk", dirty(arena)))
        log.append(("sync", arena.sync(), dirty(arena)))
        st = arena.tenants[1]
        w = workload(1, 7)
        slots = st.create_sessions_batch(w["ids"], scfg(P))
        st.run_governance_wave(slots, w["dids"], slots.copy(), w["sigma"], w["bodies"],
                               now=7.0, pad_to=(BUCKET, BUCKET))
        log.append(("after solo wave", dirty(arena)))
        for r in (1, 2):
            drive_round(P, arena, r)
        log.append(("end", dirty(arena), arena.sync()))
        return {"log": log, "tenant": (tables(P, arena.tenants[1]), host(arena.tenants[1]))}

    rec = same(drive)
    assert rec["log"][1] == ("after risk", {**{k: [] for k in rec["log"][1][1]}, "agents": [1]})
    assert rec["log"][2][1] == 1


def test_a_rebound_table_is_copied_back_and_lent_again():
    """The port's in-place tables: a lent slice is the stack's memory
    (a write needs no copy), a rebound table is copied back by `sync()`
    and the tenant is lent the stack's slice again."""
    P = Pkg(PORT)
    arena = arena_of(P)
    st = arena.tenants[2]
    lent = st.vouches
    lent.bond[3] = 0.25
    assert float(arena._stacked["vouches"].bond[2, 3]) == 0.25
    detached = struct.clone(st.sagas)
    detached.cursor[1] = 3
    st.sagas = detached
    assert int(arena._stacked["sagas"].cursor[2, 1]) == 0
    assert {k: sorted(v) for k, v in arena._dirty.items() if v} == {"vouches": [2], "sagas": [2]}
    assert arena.sync() == 2
    assert int(arena._stacked["sagas"].cursor[2, 1]) == 3
    assert st.sagas.cursor.data_ptr() == arena._stacked["sagas"].cursor[2].data_ptr()
    assert arena.sync() == 0


def test_a_raw_memory_write_is_dirty_once_its_wrapper_marks_it():
    """A kernel writes a lent table through its raw pointer, which moves no
    version counter; the wrapper's `_wrote` moves it, so the arena counts
    the tenant dirty as it counts a plain version's torch write."""
    P = Pkg(PORT)
    arena = arena_of(P)
    lent = arena.tenants[1].delta_log
    lent.cursor.numpy()[...] = 5  # a write that bypasses torch, as a kernel's does
    assert int(arena._stacked["delta_log"].cursor[1]) == 5
    assert arena._dirty["delta_log"] == set()
    mtu._wrote(lent.body, lent.cursor, None)
    assert {k: sorted(v) for k, v in arena._dirty.items() if v} == {"delta_log": [1]}
    assert arena.sync() == 1
    assert arena.sync() == 0


# ── 2. the WAL and the splice ────────────────────────────────────────


def test_tenant_wal_replays_to_identical_chain_heads_and_reference_bytes(tmp_path):
    """Tenant 1 of each package's arena journals through two batched
    rounds: both logs are byte-equal, and the port's recovery replays its
    log through the solo handlers to the tenant's chain heads."""

    def drive(P):
        d = tmp_path / ("ref" if P.is_ref else "port")
        arena = arena_of(P)
        tenant = arena.tenants[1]
        ckpt = P.mod("runtime.checkpoint")
        if P.is_ref:
            ckpt.save_state(tenant, d / "ckpt", step=0)
        else:
            ckpt.wait_durable(ckpt.save_state(tenant, d / "ckpt", step=0))
        tenant.journal = P.mod("resilience").WriteAheadLog(d / "wal.log", fsync=False)
        for r in range(2):
            drive_round(P, arena, r)
        tenant.journal.flush()
        return {"wal": (d / "wal.log").read_bytes(), "host": host(tenant)}

    ref, port = both(drive)
    assert port["wal"] == ref["wal"]
    recovery = PORT.resilience.recovery
    back, report = recovery.recover(tmp_path / "port" / "ckpt", tmp_path / "port" / "wal.log",
                                    config=config(Pkg(PORT)), device="cpu")
    assert report["wal_records_replayed"] > 0
    assert_same("chain heads", host(back)["chain_seed"], port["host"]["chain_seed"])
    assert sorted(back._members) == port["host"]["members"]


def test_recover_tenant_then_splice_equals_the_tenant_never_lost(tmp_path):
    P = Pkg(PORT)
    ckpt = PORT.runtime.checkpoint
    tdir = tmp_path / "bundle" / "tenant_1"
    arena = arena_of(P)
    tenant = arena.tenants[1]
    ckpt.wait_durable(ckpt.save_state(tenant, tdir, step=0))
    tenant.journal = PORT.resilience.WriteAheadLog(tdir / "wal.log", fsync=False)
    for r in range(2):
        drive_round(P, arena, r, vouched=True)
    tenant.journal.flush()
    tenant.journal = None
    back, report = PORT.resilience.recovery.recover_tenant(tmp_path / "bundle", 1,
                                                           config=config(P), device="cpu")
    assert report["tenant"] == 1 and report["wal_records_replayed"] > 0
    fresh = arena_of(P)
    fresh.splice_tenant(1, back)
    keys = ("agents.", "sessions.", "vouches.", "delta_log.")

    def slot(a):
        return ({k: v for k, v in tables(P, a.tenants[1]).items() if k.startswith(keys)},
                host(a.tenants[1]), a.tenants[1]._delta_cursor)

    assert_same("spliced", slot(fresh), slot(arena))
    drive_round(P, arena, 2, tenants=[1], vouched=True)
    drive_round(P, fresh, 2, tenants=[1], vouched=True)
    assert_same("one round later", slot(fresh), slot(arena))
    with pytest.raises(ValueError, match="capacity"):
        other = PORT.state.HypervisorState(PORT.config.HypervisorConfig(), device="cpu")
        fresh.splice_tenant(0, other)


# ── 3. the drain ─────────────────────────────────────────────────────


def test_one_stacked_read_fans_into_per_tenant_snapshots():
    def drive(P):
        arena = arena_of(P)
        for r in range(2):
            drive_round(P, arena, r)
        snaps = arena.metrics_snapshot()
        mp = P.mp
        return {"masked": [masked(snaps[t]) for t in range(T)],
                "admitted": [snaps[t].counter(mp.ADMITTED) for t in range(T)],
                "ticks": [snaps[t].counter(mp.WAVE_TICKS) for t in range(T)]}

    rec = same(drive)
    assert rec["admitted"] == [4, 2, 6] and rec["ticks"] == [2, 2, 2]


def test_prometheus_carries_tenant_labels_like_the_reference():
    def drive(P):
        arena = arena_of(P)
        front = P.mod("tenancy").TenantFrontDoor(
            arena, P.serving.ServingConfig(buckets=(4,), lifecycle_deadline_s=0.05))
        sched = P.mod("tenancy").TenantWaveScheduler(front)
        front.submit_lifecycle(1, "pl:a", "did:pl:a", 0.8, now=0.0)
        sched.lifecycle_round(0.0)
        return prom_masked(arena.metrics_prometheus())

    prom = same(drive)
    text = "\n".join(prom)
    assert 'hv_serving_latency_us_count{queue="lifecycle",tenant="1"} 1' in text
    assert 'hv_serving_latency_us_count{queue="lifecycle",tenant="0"} 0' in text
    assert 'tenant="arena"' in text
    assert text.count("# TYPE hv_admission_admitted_total counter") == 1


def test_stale_gauges_refresh_in_one_batched_call_into_a_copy():
    def drive(P):
        arena = arena_of(P)
        drive_round(P, arena, 0)
        arena.tenants[1].set_agent_risk(0, 0.5)
        stale = not arena.tenants[1]._gauges_fresh
        stacked = np.array(arena._stacked["metrics_table"].gauges, copy=True)
        snaps = arena.metrics_snapshot()
        return {"stale": stale, "gauges": [masked(snaps[t])["gauges"] for t in range(T)],
                "stack_untouched": np.array_equal(
                    np.array(arena._stacked["metrics_table"].gauges), stacked)}

    rec = same(drive)
    assert rec["stale"] and rec["stack_untouched"]


def test_footprints_publish_without_lending_a_slice():
    def drive(P):
        arena = arena_of(P)
        drive_round(P, arena, 0)
        arena.metrics_snapshot()
        lent = [sorted(st._tenant_local) for st in arena.tenants]
        fp = arena.tenants[0].health._footprints
        return {"lent": lent, "footprints": {k: dict(v) for k, v in sorted(fp.items())}}

    rec = same(drive)
    assert rec["footprints"]["agents"]["capacity_rows"] == 64
    assert rec["footprints"]["agents"]["bytes"] > 0


def test_tenant_arena_defaults_to_cuda():
    cfg = config(Pkg(PORT))
    if torch.cuda.is_available():
        assert PORT.tenancy.TenantArena(1, cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PORT.tenancy.TenantArena(1, cfg)


# ── 4. the tenant forms' plain versions ──────────────────────────────


def _stacked_tables(rng, n_t: int, n: int, s: int, e: int):
    """Random but valid stacked agent, session and vouch tables."""
    agents = struct.stack([AgentTable.create(n, "cpu") for _ in range(n_t)])
    sessions = struct.stack([SessionTable.create(s, "cpu") for _ in range(n_t)])
    vouches = struct.stack([VouchTable.create(e, "cpu") for _ in range(n_t)])
    sessions.i32[..., 0] = torch.arange(s, dtype=torch.int32)
    sessions.i32[..., 1] = torch.from_numpy(rng.randint(1, 4, (n_t, s)).astype(np.int32))
    sessions.i32[..., 2] = torch.from_numpy(rng.randint(0, 3, (n_t, s)).astype(np.int32))
    sessions.i32[..., 3] = torch.from_numpy(rng.randint(1, 3, (n_t, s)).astype(np.int32))
    agents.i32[..., 1] = torch.from_numpy(rng.randint(-1, s, (n_t, n)).astype(np.int32))
    agents.i32[..., 2] = torch.from_numpy(rng.randint(0, 2, (n_t, n)).astype(np.int32))
    vouches.vouchee.copy_(torch.from_numpy(rng.randint(-1, n, (n_t, e)).astype(np.int32)))
    vouches.voucher.copy_(torch.from_numpy(rng.randint(0, n, (n_t, e)).astype(np.int32)))
    vouches.session.copy_(torch.from_numpy(rng.randint(0, s, (n_t, e)).astype(np.int32)))
    vouches.active.copy_(torch.from_numpy(rng.rand(n_t, e) < 0.7))
    vouches.bond.copy_(torch.from_numpy(rng.uniform(0, 0.5, (n_t, e)).astype(np.float32)))
    vouches.expiry.copy_(torch.from_numpy(rng.uniform(0, 4, (n_t, e)).astype(np.float32)))
    return agents, sessions, vouches


def _form_inputs(form: str, seed: int):
    rng = np.random.RandomState(seed)
    n_t, n, s, e, b = 3, 16, 8, 24, 6
    agents, sessions, vouches = _stacked_tables(rng, n_t, n, s, e)
    if form == "contribution":
        target = torch.from_numpy(rng.randint(-2, s, (n_t, n)).astype(np.int32))
        return (vouches, target, 1.5)
    if form == "admission":
        slot = torch.from_numpy(np.stack([rng.permutation(n)[:b] for _ in range(n_t)])
                                .astype(np.int32))
        sess = torch.from_numpy(rng.randint(0, 3, (n_t, b)).astype(np.int32))  # shared sessions
        return (agents, sessions, slot,
                torch.from_numpy(rng.randint(0, 99, (n_t, b)).astype(np.int32)), sess,
                torch.from_numpy(rng.uniform(0, 1, (n_t, b)).astype(np.float32)),
                torch.from_numpy(rng.uniform(0, 1, (n_t, b)).astype(np.float32)), 0.5,
                torch.from_numpy(rng.rand(n_t, b) < 0.8), torch.from_numpy(rng.rand(n_t, b) < 0.2),
                2.0, None, PORT.config.DEFAULT_CONFIG.trust)
    if form == "fsm_saga":
        lo = [int(x) for x in rng.randint(0, 4, n_t)]
        k = 3
        ks = torch.tensor([list(range(x, x + k)) for x in lo], dtype=torch.int32)
        return (agents, sessions, vouches, ks, torch.from_numpy(rng.rand(n_t, b) < 0.5), 3.0,
                lo, [x + k for x in lo])
    turns, k, cap = 3, 4, 8
    ring = struct.stack([DeltaLog.create(cap, "cpu") for _ in range(n_t)])
    bodies = torch.from_numpy(rng.randint(-2**31, 2**31, (turns, n_t, k, 16)).astype(np.int32))
    seeds = torch.from_numpy(rng.randint(-2**31, 2**31, (n_t, k, 8)).astype(np.int32))
    wave_sessions = torch.from_numpy(rng.randint(0, s, (n_t, k)).astype(np.int32))
    cursors = [5, 0, 7]
    ring.cursor.copy_(torch.tensor(cursors, dtype=torch.int32))
    return (bodies, seeds, ring, wave_sessions, cursors, [8, 0, 5])


def _solo_loop(form: str, args):
    """The solo plain version over per-tenant COPIES of the inputs (not
    views of the stack), stacked; the tables are returned restacked."""
    n_t = 3
    copies = [[struct.clone(struct.tenant_view(a, t)) if dataclasses.is_dataclass(a)
               and isinstance(a, (AgentTable, SessionTable, VouchTable, DeltaLog))
               else (a[t].clone() if isinstance(a, torch.Tensor) and a.dim() and a.shape[0] == n_t
                     and form != "chain_ring" else a) for a in args] for t in range(n_t)]
    outs = []
    for t in range(n_t):
        c = copies[t]
        if form == "contribution":
            outs.append((PORT.ops.liability.contribution_toward(c[0], c[1], c[2]),))
        elif form == "admission":
            outs.append(wave.admission_block_plain(*c[:13], unique_sessions=False))
        elif form == "fsm_saga":
            outs.append(wave.fsm_saga_block_plain(*c[:6], (args[6][t], args[7][t])))
        else:
            bodies, seeds, ring, ws, cursors, n_live = args
            tbl = copies[t][2]
            outs.append((mtu.chain_digests_ring_plain(bodies[:, t], seeds[t], tbl, ws[t],
                                                     cursors[t], n_live[t]),))
    stacked_out = [torch.stack(col, dim=1 if form == "chain_ring" else 0) for col in zip(*outs)]
    stacked_tables = [struct.stack([copies[t][i] for t in range(n_t)])
                      for i, a in enumerate(args)
                      if isinstance(a, (AgentTable, SessionTable, VouchTable, DeltaLog))]
    return stacked_out, stacked_tables


@pytest.mark.parametrize("form", ["contribution", "admission", "fsm_saga", "chain_ring"])
@pytest.mark.parametrize("seed", [0, 1])
def test_tenant_form_plain_version_is_the_loop_of_solo_plain_versions(form, seed):
    """Each tenant form's plain version (and its wrapper, which routes a
    CPU tensor to it) equals the solo plain version looped over per-tenant
    copies: outputs and every table it writes, bit for bit."""
    want_out, want_tables = _solo_loop(form, _form_inputs(form, seed))
    for fn in (getattr(pipeline.TENANT_PLAIN_BLOCKS, form),
               getattr(pipeline.TENANT_KERNEL_BLOCKS, form)):
        args = _form_inputs(form, seed)
        out = fn(*args)
        out = [out] if isinstance(out, torch.Tensor) else list(out)
        assert len(out) == len(want_out)
        for got, want in zip(out, want_out):
            assert got.dtype == want.dtype and torch.equal(got, want), form
        got_tables = [a for a in args if isinstance(a, (AgentTable, SessionTable, VouchTable,
                                                        DeltaLog))]
        for g, w in zip(got_tables, want_tables):
            for k, v in struct.tensors(w).items():
                assert torch.equal(struct.tensors(g)[k], v), (form, k)


def test_tenant_forms_model_the_solo_forms_work_at_the_totals():
    from hypervisor_tpu_torch.kernels import work

    assert work.kernel_work("admission_block_tenants", lanes=96, admitted=40) == \
        work.kernel_work("admission_block", lanes=96, admitted=40)
    assert work.kernel_work("chain_digests_ring_tenants", turns=3, lanes=256, rows=600) == \
        work.kernel_work("chain_digests_ring", turns=3, lanes=256, rows=600)
    assert set(work.TENANT_FORMS) <= set(PORT.kernels.WRAPPERS)
