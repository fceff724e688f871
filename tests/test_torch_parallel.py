"""The port's multi-device plane against the reference's, on the CPU.

`hypervisor_tpu_torch.parallel` is a single-controller mesh over torch
devices: the counterpart of the reference's virtual 8-device CPU mesh is
a mesh of 8 CPU shards (`make_mesh(8, platform="cpu")`), whose parts are
views of one CPU tensor. Every case builds its inputs with the reference
test's own helpers (numpy seeds included), runs the reference's program
on its 8-device mesh and the port's on its 8-shard mesh, and holds every
output and every table column equal at tolerance 0.

This file: the mesh (`make_mesh`, `make_multislice_mesh`, hashing, the
refusal without enough CUDA devices), the collectives' order (psum adds
in rank order from zero, as XLA:CPU's all-reduce does over the virtual
devices; the admission's fused multiply-add), and the counterparts of
`tests/parity/test_sharded_admission.py` (9), `test_sharded_slash.py`
(3) and the mesh cases of `test_pipeline.py` (2), plus an f32 sum whose
partials are non-zero on several shards and a B2 part that is not
contiguous in its column. `test_torch_mesh_wave.py`,
`test_torch_sharded_gateway.py` and `test_torch_consistency.py` import
the harness here.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as Pspec

import hypervisor_tpu.parallel as REF_PAR
import hypervisor_tpu_torch.parallel as PORT_PAR
from hypervisor_tpu.ops import liability as ref_liability
from hypervisor_tpu.ops import merkle as ref_merkle
from hypervisor_tpu.ops import pipeline as ref_pipe
from hypervisor_tpu.parallel import collectives as RC
from hypervisor_tpu.tables.struct import replace as t_replace
from hypervisor_tpu_torch import u32
from hypervisor_tpu_torch.kernels import mtu
from hypervisor_tpu_torch.ops import liability as port_liability
from hypervisor_tpu_torch.parallel import collectives as PC
from hypervisor_tpu_torch.parallel import mesh as port_mesh
from hypervisor_tpu_torch.parallel import sharding as port_sharding
from hypervisor_tpu_torch.tables import state as port_state_tables
from tests.parity import test_sharded_admission as ref_adm
from tests.parity import test_sharded_slash as ref_slash

N_DEV = 8


# ── the two-package harness ──────────────────────────────────────────


def ref_mesh(n=N_DEV):
    return REF_PAR.make_mesh(n, platform="cpu")


def port_mesh_of(n=N_DEV):
    return PORT_PAR.make_mesh(n, platform="cpu")


def port_table(t):
    """A port table (CPU tensors) holding a reference table's columns."""
    cls = getattr(port_state_tables, type(t).__name__)
    return cls(**{f.name: torch.from_numpy(np.array(getattr(t, f.name)))
                  for f in dataclasses.fields(t)})


def put(a) -> torch.Tensor:
    """A numpy or jax array as a CPU tensor (u32 as int32 bits)."""
    a = np.array(a, copy=True)
    if a.dtype == np.uint32:
        return u32.from_numpy_u32(a, "cpu")
    return torch.from_numpy(a)


def np_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def flat(value, prefix="") -> dict[str, np.ndarray]:
    """Every array of a result (tuples, NamedTuples and table dataclasses
    recursively) by a dotted name."""
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        items = [(f, getattr(value, f)) for f in value._fields]
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        items = [(f.name, getattr(value, f.name)) for f in dataclasses.fields(value)]
    elif isinstance(value, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(value)]
    elif value is None:
        return {}
    else:
        return {prefix.rstrip("."): np_of(value)}
    out = {}
    for name, v in items:
        out.update(flat(v, f"{prefix}{name}."))
    return out


def assert_same(got, want, skip=()) -> None:
    """Tolerance 0: the same names, shapes, dtypes (u32 against its
    int32 bits) and bytes."""
    g, w = flat(got), flat(want)
    g = {k: v for k, v in g.items() if k not in skip}
    w = {k: v for k, v in w.items() if k not in skip}
    assert sorted(g) == sorted(w)
    for k, want_arr in w.items():
        got_arr = g[k]
        assert got_arr.shape == want_arr.shape, k
        if want_arr.dtype == np.uint32:
            assert got_arr.dtype in (np.int32, np.uint32), k
        else:
            assert got_arr.dtype == want_arr.dtype, k
        assert got_arr.tobytes() == want_arr.tobytes(), f"{k} diverged"


# ── the mesh ─────────────────────────────────────────────────────────


def test_meshes_have_the_reference_axes_and_shapes():
    for ref, port in ((ref_mesh(), port_mesh_of()),
                      (REF_PAR.make_multislice_mesh(2, 4, platform="cpu"),
                       PORT_PAR.make_multislice_mesh(2, 4, platform="cpu"))):
        assert port.axis_names == tuple(ref.axis_names)
        assert port.devices.shape == ref.devices.shape
        assert port.devices.size == ref.devices.size == N_DEV
        assert [d.type for d in port.devices.flat] == ["cpu"] * N_DEV
    assert PORT_PAR.AGENT_AXIS == REF_PAR.AGENT_AXIS and PORT_PAR.DCN_AXIS == REF_PAR.DCN_AXIS
    assert PORT_PAR.__all__ == REF_PAR.__all__


def test_make_mesh_raises_without_enough_cuda_devices(monkeypatch):
    """No fallback to the host: a CUDA mesh larger than the machine
    raises naming both counts, and a virtual mesh on one card exists only
    through an explicit `devices=`."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 8-device CUDA mesh but only 1 CUDA"):
        PORT_PAR.make_mesh(8)
    with pytest.raises(ValueError, match="requested 8-device CUDA mesh but only 1 CUDA"):
        PORT_PAR.make_multislice_mesh(2, 4)
    assert PORT_PAR.make_mesh().devices.size == 1  # all the CUDA devices there are
    virtual = PORT_PAR.make_mesh(devices=[torch.device("cuda:0")] * 8)
    assert virtual.devices.size == 8 and {str(d) for d in virtual.devices.flat} == {"cuda:0"}
    grid = PORT_PAR.make_multislice_mesh(2, 4, devices=np.full((2, 4), torch.device("cuda:0")))
    assert grid.axis_names == ("dcn", "agents") and grid.devices.shape == (2, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="only 0 CUDA"):
        PORT_PAR.make_mesh(8)


def test_mesh_compares_and_hashes_by_devices_and_axes():
    a, b = port_mesh_of(), port_mesh_of()
    assert a is not b and a == b and hash(a) == hash(b)
    assert len({a: 1, b: 2}) == 1
    assert a != port_mesh_of(4)
    assert a != PORT_PAR.make_multislice_mesh(2, 4, platform="cpu")
    assert PORT_PAR.make_multislice_mesh(2, 4, platform="cpu") != \
        PORT_PAR.make_multislice_mesh(4, 2, platform="cpu")


def test_shard_table_parts_are_views_and_sharding_specs_place_them():
    t = port_table(ref_adm.AgentTable.create(ref_adm.N_CAP))
    mesh = port_mesh_of()
    parts = PORT_PAR.shard_table(t, mesh)
    assert len(parts) == N_DEV
    parts[3].i32[0, 0] = 77
    assert int(t.i32[3 * ref_adm.ROWS_PER_SHARD, 0]) == 77  # a view of the column
    x = torch.arange(16)
    assert [p.tolist() for p in PORT_PAR.lane_sharding(mesh).split(x)] == \
        [[2 * i, 2 * i + 1] for i in range(8)]
    assert all(p is x for p in PORT_PAR.replicated(mesh).split(x))


# ── the collectives' order ───────────────────────────────────────────


def _wide_parts(seed, n=257):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((N_DEV, n))
            * 10.0 ** rng.randint(-8, 9, (N_DEV, n))).astype(np.float32)


@pytest.mark.parametrize("axes", ["agents", "dcn", "both", "1d"])
def test_psum_adds_in_the_reference_all_reduce_order(axes):
    """f32 parts of wide exponents: the port's psum equals the
    reference's `jax.lax.psum` under `shard_map` bit for bit, on the 1-D
    mesh and per axis group of the (2, 4) grid (ICI then DCN included)."""
    x = _wide_parts(3)
    x[:, 0] = -0.0  # all parts -0.0: the sum starts from +0.0
    if axes == "1d":
        rm, pm, names = ref_mesh(), port_mesh_of(), REF_PAR.AGENT_AXIS
        spec = Pspec(REF_PAR.AGENT_AXIS, None)
        body = lambda a: jax.lax.psum(a[0], names)  # noqa: E731
        out_spec = Pspec()
    else:
        rm = REF_PAR.make_multislice_mesh(2, 4, platform="cpu")
        pm = PORT_PAR.make_multislice_mesh(2, 4, platform="cpu")
        names = {"agents": "agents", "dcn": "dcn", "both": ("dcn", "agents")}[axes]
        spec = Pspec("dcn", "agents", None)
        body = lambda a: jax.lax.psum(a[0, 0], names)[None, None]  # noqa: E731
        out_spec = Pspec("dcn", "agents", None)
    fn = jax.jit(RC.shard_map(body, mesh=rm, in_specs=spec, out_specs=out_spec))
    want = np.asarray(fn(jnp.asarray(x if axes == "1d" else x.reshape(2, 4, -1))))
    got = PC.psum([torch.from_numpy(r) for r in x], pm, names)
    if axes == "1d":
        assert np_of(got[0]).tobytes() == want.tobytes()
    else:
        assert np.stack([np_of(g) for g in got]).tobytes() == want.reshape(8, -1).tobytes()
    if axes == "both":
        sequential = np.zeros_like(x[0])
        for row in x:
            sequential = sequential + row
        assert sequential.tobytes() == want[0, 0].tobytes()


def test_fma_helper_rounds_once():
    """`_fma_f32` equals a * b + c computed exactly and rounded once to
    f32, including inputs where double rounding through float64 would
    part (ties in f32 reached only after a float64 rounding)."""
    rng = np.random.RandomState(0)
    a = rng.uniform(0, 1, 4000).astype(np.float32)
    b = rng.uniform(0, 1, 4000).astype(np.float32)
    c = rng.uniform(0, 1, 4000).astype(np.float32)
    # Hard cases: a * b = 2^-24 (1 - 2^-46), just under half an ulp of
    # c = 1 + 2^-23, whose last bit is odd: float64 rounds the sum onto
    # the float32 tie, which then rounds to even (up), while the exact
    # sum rounds down.
    a[:3] = np.float32(2.0 ** -24 * (1 + 2.0 ** -23)) * np.float32([1, 2, 4])
    b[:3] = np.float32(1 - 2.0 ** -23) * np.float32([1, 0.5, 0.25])
    c[:3] = np.float32(1 + 2.0 ** -23)
    got = np_of(PC._fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)))

    def exact(x, y, z):
        v = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(v))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda f: (abs(Fraction(float(f)) - v),
                                         int(np.array(f).view(np.int32)) & 1))
        return np.float32(best)

    want = np.array([exact(*t) for t in zip(a, b, c)], np.float32)
    assert got.tobytes() == want.tobytes()
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive != want).any()  # the inputs do exercise double rounding


# ── counterparts of tests/parity/test_sharded_admission.py ───────────


def _admission_both(sigmas, trusts, capacity, min_sigma, vouch_rows=(), omega=0.5,
                    slots=None, vouches=None):
    """The reference's `TestShardedAdmission._run` inputs through both
    packages' sharded admission; returns (ref outputs, port outputs,
    slots)."""
    b = len(sigmas)
    b_local = b // N_DEV
    agents = ref_adm.AgentTable.create(ref_adm.N_CAP)
    sessions = ref_adm._session_table(capacity, min_sigma)
    if vouches is None:
        vouches = ref_adm.VouchTable.create(ref_adm.E_CAP)
        for row, (vouchee_slot, bond) in enumerate(vouch_rows):
            vouches = t_replace(
                vouches,
                voucher=vouches.voucher.at[row].set(ref_adm.N_CAP - 1),
                vouchee=vouches.vouchee.at[row].set(vouchee_slot),
                session=vouches.session.at[row].set(0),
                bond=vouches.bond.at[row].set(bond),
                active=vouches.active.at[row].set(True),
            )
    if slots is None:
        slots = np.array([(i // b_local) * ref_adm.ROWS_PER_SHARD + (i % b_local)
                          for i in range(b)], np.int32)
    lanes = (slots, np.arange(b, dtype=np.int32), np.zeros(b, np.int32),
             np.asarray(sigmas, np.float32), np.asarray(trusts, bool), np.zeros(b, bool))
    ref = RC.sharded_admission(ref_mesh())(agents, sessions, vouches,
                                           *map(jnp.asarray, lanes), 0.0, omega)
    port = PC.sharded_admission(port_mesh_of())(
        port_table(agents), port_table(sessions), port_table(vouches), *map(put, lanes),
        0.0, omega)
    return ref, port, slots


class TestShardedAdmission:
    def test_session_spanning_all_shards_respects_capacity(self):
        ref, port, _ = _admission_both([0.8] * 16, [True] * 16, capacity=5, min_sigma=0.6)
        assert_same(port, ref)
        want_status, want_ring = ref_adm._host_expected(
            [0.8] * 16, [True] * 16, np.zeros(16, np.float32), 0.5, 5, 0.6)
        np.testing.assert_array_equal(np_of(port[2]), want_status)
        np.testing.assert_array_equal(np_of(port[3]), want_ring)
        assert int(port[1].n_participants[0]) == 5

    def test_mixed_rejections_match_host_engine(self):
        sigmas = [0.8, 0.4, 0.9, 0.3, 0.7, 0.95, 0.2, 0.8] * 2
        trusts = [True, True, True, False, True, True, True, True] * 2
        ref, port, _ = _admission_both(sigmas, trusts, capacity=16, min_sigma=0.6)
        assert_same(port, ref)
        want_status, want_ring = ref_adm._host_expected(
            sigmas, trusts, np.zeros(16, np.float32), 0.5, 16, 0.6)
        np.testing.assert_array_equal(np_of(port[2]), want_status)
        np.testing.assert_array_equal(np_of(port[3]), want_ring)

    def test_vouched_sigma_crosses_shards(self):
        b, lifted = 16, 13
        sigmas = [0.8] * b
        sigmas[lifted] = 0.45
        slot_of_lifted = (lifted // 2) * ref_adm.ROWS_PER_SHARD + lifted % 2
        ref, port, _ = _admission_both(sigmas, [True] * b, capacity=16, min_sigma=0.6,
                                       vouch_rows=[(slot_of_lifted, 0.40)])
        assert_same(port, ref)
        assert int(port[2][lifted]) == 0 and int(port[3][lifted]) == 2
        assert float(port[4][lifted]) == pytest.approx(0.45 + 0.5 * 0.40)
        ref2, port2, _ = _admission_both(list(sigmas), [True] * b, capacity=16, min_sigma=0.6)
        assert_same(port2, ref2)
        assert int(port2[3][lifted]) == 3

    def test_replicated_session_table_identical_on_all_shards(self):
        ref, port, _ = _admission_both([0.8] * 16, [True] * 16, capacity=7, min_sigma=0.6)
        assert_same(port, ref)
        assert int(port[1].n_participants[0]) == 7
        assert int((port[0].did >= 0).sum()) == 7


def test_contribution_summed_over_several_shards_in_rank_order():
    """Every vouchee has live scoped edges on several shards, two a shard
    (16 edges each over 8 shards), with bonds of wide exponents and
    omega 0.37: each shard sums its edges in edge order, the psum adds
    the shards' partials in rank order, and sigma_eff is one fused
    multiply-add. The port equals the reference's mesh bit for bit, and
    the input is one where that order parts from a sequential edge-order
    sum (so the test would see a wrong order)."""
    b = 16
    rng = np.random.RandomState(29)
    slots = np.array([(i // 2) * ref_adm.ROWS_PER_SHARD + i % 2 for i in range(b)], np.int32)
    e_cap = 256
    per = e_cap // N_DEV
    vouches = ref_adm.VouchTable.create(e_cap)
    rows = np.arange(e_cap)
    # Each shard: two consecutive edges for each of the 16 vouchees.
    vouchee = slots[(rows // 2 + rows // per) % b]
    bond = (rng.uniform(0.5, 1.0, e_cap) * 10.0 ** rng.randint(-7, 0, e_cap)).astype(np.float32)
    vouches = t_replace(
        vouches, voucher=jnp.full(e_cap, ref_adm.N_CAP - 1, jnp.int32),
        vouchee=jnp.asarray(vouchee.astype(np.int32)), session=jnp.zeros(e_cap, jnp.int32),
        bond=jnp.asarray(bond), active=jnp.ones(e_cap, bool))
    sigmas = rng.uniform(0.3, 0.9, b).astype(np.float32)
    ref, port, _ = _admission_both(list(sigmas), [True] * b, capacity=64, min_sigma=0.0,
                                   omega=0.37, slots=slots, vouches=vouches)
    assert_same(port, ref)
    shards_per_vouchee = [len({int(r) // per for r in np.flatnonzero(vouchee == s)})
                          for s in slots]
    assert min(shards_per_vouchee) >= 2
    # The sequential edge-order sum parts from the mesh's on this input.
    seq = np.zeros(ref_adm.N_CAP, np.float32)
    for e in range(e_cap):
        seq[vouchee[e]] = np.float32(seq[vouchee[e]] + bond[e])
    fused = (sigmas.astype(np.float64) + np.float64(np.float32(0.37)) * seq[slots]).astype(
        np.float32)
    assert (np.minimum(fused, 1.0) != np_of(port[4])).any()


class TestEventualReconcile:
    def test_session_table_deltas_merge_across_shards(self):
        sessions = ref_adm._session_table(max_participants=64, min_sigma=0.0)
        count_deltas = np.zeros((N_DEV, ref_adm.S_CAP), np.int32)
        sigma_deltas = np.zeros((N_DEV, ref_adm.S_CAP), np.float32)
        for d in range(N_DEV):
            count_deltas[d, 0] = d % 3
            count_deltas[d, 1] = 1
            sigma_deltas[d, 0] = 0.1 * (d % 3)
        ref = RC.reconcile_sessions(ref_mesh())(sessions, jnp.asarray(count_deltas),
                                                jnp.asarray(sigma_deltas))
        port = PC.reconcile_sessions(port_mesh_of())(port_table(sessions), put(count_deltas),
                                                     put(sigma_deltas))
        assert_same(port, ref)
        assert int(port[1][0]) == sum(d % 3 for d in range(N_DEV))
        assert int(port[0].n_participants[1]) == N_DEV


class TestShardedChain:
    @pytest.mark.parametrize("seed,per_shard,lanes,zero_seed", [(0, 4, 8, False),
                                                               (1, 2, 4, True)])
    def test_pipelined_chain_matches_single_device(self, seed, per_shard, lanes, zero_seed):
        """The reference's two cases (a random seed; a zero seed): the
        turn-sharded chain equals the reference's sharded chain, its
        single-device chain and hashlib's (one lane)."""
        rng = np.random.RandomState(seed)
        bodies = rng.randint(0, 2**32, size=(N_DEV * per_shard, lanes, 16),
                             dtype=np.uint64).astype(np.uint32)
        seed_words = (np.zeros((lanes, 8), np.uint32) if zero_seed else
                      rng.randint(0, 2**32, size=(lanes, 8), dtype=np.uint64).astype(np.uint32))
        want = np.asarray(RC.sharded_chain(ref_mesh())(jnp.asarray(bodies),
                                                       jnp.asarray(seed_words)))
        single = np.asarray(ref_merkle.chain_digests(jnp.asarray(bodies),
                                                     jnp.asarray(seed_words)))
        got = u32.to_numpy_u32(PC.sharded_chain(port_mesh_of())(put(bodies), put(seed_words)))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, single)
        import hashlib

        parent = seed_words[0].astype(">u4").tobytes()
        for turn in range(bodies.shape[0]):
            parent = hashlib.sha256(bodies[turn, 0].astype(">u4").tobytes() + parent).digest()
        assert got[-1, 0].astype(">u4").tobytes() == parent


class TestMultisliceReconcile:
    def test_dcn_axis_folds_slice_deltas(self):
        n_slices, per_slice = 2, 4
        sessions = ref_adm._session_table(max_participants=64, min_sigma=0.0)
        deltas = np.zeros((n_slices, per_slice, ref_adm.S_CAP), np.int32)
        for sl in range(n_slices):
            for d in range(per_slice):
                deltas[sl, d, 0] = sl + 1
                deltas[sl, d, 2] = d % 2
        ref = RC.multislice_reconcile(REF_PAR.make_multislice_mesh(n_slices, per_slice))(
            sessions, jnp.asarray(deltas))
        port = PC.multislice_reconcile(
            PORT_PAR.make_multislice_mesh(n_slices, per_slice, platform="cpu"))(
            port_table(sessions), put(deltas))
        assert_same(port, ref)
        assert int(port[1][0]) == per_slice * 3 and int(port[0].n_participants[0]) == 12


class TestVouchedStrongTick:
    def test_contribution_lifts_rings_across_mesh(self):
        s, t = N_DEV * 4, 2
        rng = np.random.RandomState(0)
        bodies = rng.randint(0, 2**32, size=(t, s, 16), dtype=np.uint64).astype(np.uint32)
        sigma = np.full(s, 0.5, np.float32)
        contribution = np.zeros(s, np.float32)
        contribution[::N_DEV] = 0.4
        args = (sigma, np.ones(s, bool), np.zeros(s, np.float32), bodies, np.ones(s, bool),
                contribution)
        ref = RC.strong_tick(ref_mesh(), with_vouching=True)(*map(jnp.asarray, args))
        port = PC.strong_tick(port_mesh_of(), with_vouching=True)(*map(put, args))
        assert_same(port, ref)
        rings = np_of(port.ring)
        assert (rings[::N_DEV] == 2).all()
        assert (np.delete(rings, slice(None, None, N_DEV)) == 3).all()


# ── counterparts of tests/parity/test_pipeline.py's TestMultiChip ────


def _tick_args(s, t, bodies_seed):
    if bodies_seed is None:
        bodies = np.zeros((t, s, 16), np.uint32)
    else:
        bodies = np.random.RandomState(bodies_seed).randint(
            0, 2**32, size=(t, s, 16), dtype=np.uint64).astype(np.uint32)
    return (np.full(s, 0.8, np.float32), np.ones(s, bool), np.full(s, 0.6, np.float32),
            bodies, np.ones(s, bool))


class TestMultiChip:
    def test_strong_tick_on_8_device_mesh(self):
        args = _tick_args(64, 3, 1)
        ref = RC.strong_tick(ref_mesh())(*map(jnp.asarray, args))
        port = PC.strong_tick(port_mesh_of())(*map(put, args))
        assert_same(port, ref)
        single = ref_pipe.governance_pipeline(*map(jnp.asarray, args))
        np.testing.assert_array_equal(u32.to_numpy_u32(port.merkle_root),
                                      np.asarray(single.merkle_root))
        np.testing.assert_allclose(np_of(port.consensus), np.asarray(single.consensus),
                                   rtol=1e-6)

    def test_eventual_then_reconcile_equals_strong(self):
        args = _tick_args(32, 3, None)
        ref_ev = RC.eventual_tick(ref_mesh())(*map(jnp.asarray, args))
        port_ev = PC.eventual_tick(port_mesh_of())(*map(put, args))
        assert_same(port_ev, ref_ev)
        ref_rec = RC.reconcile(ref_mesh())(ref_ev.consensus)
        port_rec = PC.reconcile(port_mesh_of())(port_ev.consensus)
        assert np_of(port_rec).tobytes() == np.asarray(ref_rec).tobytes()
        strong = PC.strong_tick(port_mesh_of())(*map(put, args))
        np.testing.assert_allclose(np_of(port_ev.consensus).reshape(8, 4).sum(axis=0),
                                   np_of(strong.consensus), rtol=1e-6)


def test_sigma_allreduce_stats_matches_reference():
    sigma = np.random.RandomState(4).uniform(0, 1, 1001).astype(np.float32)
    for n in (1001, 999, 7):
        want = np.asarray(RC.sigma_allreduce_stats(jnp.asarray(sigma), n))
        got = np_of(PC.sigma_allreduce_stats(put(sigma), n))
        assert got.tobytes() == want.tobytes(), n


# ── counterparts of tests/parity/test_sharded_slash.py ───────────────


def _slash_both(edges, sigma_host, seeds_idx, omega):
    vouch = ref_slash._vouch_table(edges)
    sigma = np.asarray(sigma_host, np.float32)
    seeds = np.zeros(ref_slash.N_AGENTS, bool)
    seeds[list(seeds_idx)] = True
    ref = RC.sharded_slash(ref_mesh())(vouch, jnp.asarray(sigma), jnp.asarray(seeds),
                                       ref_slash.SESSION, omega, 0.0)
    single = ref_liability.slash_cascade(vouch, jnp.asarray(sigma), jnp.asarray(seeds),
                                         ref_slash.SESSION, omega, now=0.0)
    pv = port_table(vouch)
    port = PC.sharded_slash(port_mesh_of())(pv, put(sigma), put(seeds), ref_slash.SESSION,
                                            omega, 0.0)
    assert_same(port, ref, skip=("metrics", "trace"))
    assert_same(port, single, skip=("metrics", "trace"))
    # The input table is not written, and the single-device port cascade
    # (B8's plain version) agrees.
    assert np_of(pv.active).tobytes() == np.asarray(vouch.active).tobytes()
    solo = port_liability.slash_cascade(pv, put(sigma), put(seeds), ref_slash.SESSION, omega, 0.0)
    assert_same(port, solo, skip=("metrics", "trace"))
    return port


def test_voucher_with_vouchees_on_different_shards():
    port = _slash_both([(0, 1, 0.2), (0, 2, 0.2)], np.full(ref_slash.N_AGENTS, 0.9), [1, 2], 0.5)
    assert float(port.sigma[0]) == pytest.approx(0.225)


def test_cascade_crosses_shards():
    sigma = np.full(ref_slash.N_AGENTS, 0.9, np.float32)
    sigma[10] = 0.052
    port = _slash_both([(10, 5, 0.3), (20, 10, 0.3)], sigma, [5], 0.99)
    out = np_of(port.sigma)
    assert bool(port.slashed[5]) and out[10] == 0.0 and int(port.wave_of[10]) == 1
    assert out[20] < 0.9


def test_random_graphs_match(seed=0):
    rng = np.random.RandomState(seed)
    ran = 0
    for _ in range(4):
        n_edges = rng.randint(3, 16)
        edges, seen = [], set()
        for _ in range(n_edges):
            a, b = rng.randint(0, ref_slash.N_AGENTS, 2)
            if a == b or (a, b) in seen or (b, a) in seen:
                continue
            seen.add((a, b))
            edges.append((int(a), int(b), float(rng.uniform(0.05, 0.4))))
        if not edges:
            continue
        sigma = rng.uniform(0.05, 1.0, ref_slash.N_AGENTS).astype(np.float32)
        seeds = rng.choice(ref_slash.N_AGENTS, size=rng.randint(1, 4), replace=False)
        _slash_both(edges, sigma, list(map(int, seeds)), float(rng.uniform(0.3, 0.99)))
        ran += 1
    assert ran


# ── the design's own checks ──────────────────────────────────────────


def test_b2_parts_along_the_session_axis_reach_it_contiguous(monkeypatch):
    """The wave's delta bodies [T, K, 16] shard on K, so a shard's part is
    not contiguous in its column; it is made contiguous before B2's
    wrapper reads it (the CUDA route refuses a strided operand). Every
    B2 call of a sharded wave sees a contiguous part, and the parts equal
    the column's slices."""
    bodies = put(np.random.RandomState(2).randint(0, 2**32, (3, 16, 16), dtype=np.uint64)
                 .astype(np.uint32))
    parts = port_sharding.split_rows(bodies, port_mesh_of(), dim=1)
    assert not bodies[:, 0:2].is_contiguous()
    assert all(p.is_contiguous() for p in parts)
    assert all(torch.equal(p, bodies[:, 2 * i:2 * i + 2]) for i, p in enumerate(parts))
    seen = []
    real = mtu.chain_digests

    def spy(b, seeds):
        seen.append((b.is_contiguous(), seeds.is_contiguous(), tuple(b.shape)))
        return real(b, seeds)

    monkeypatch.setattr(mtu, "chain_digests", spy)
    args = _tick_args(16, 3, 5)
    PC.strong_tick(port_mesh_of())(*map(put, args))
    assert len(seen) == N_DEV and all(c and s for c, s, _ in seen)
    assert {shape for _, _, shape in seen} == {(3, 2, 16)}


def test_collectives_reach_every_shard():
    mesh = PORT_PAR.make_multislice_mesh(2, 4, platform="cpu")
    parts = [torch.tensor([float(i)]) for i in range(N_DEV)]
    assert [float(p) for p in PC.psum(parts, mesh, "agents")] == [6.0] * 4 + [22.0] * 4
    assert [float(p) for p in PC.psum(parts, mesh, "dcn")] == [4.0, 6.0, 8.0, 10.0] * 2
    gathered = PC.all_gather(parts, mesh, "agents")
    assert gathered[5].tolist() == [4.0, 5.0, 6.0, 7.0]
    with pytest.raises(ValueError, match="needs 2 axis names"):
        port_mesh.Mesh(np.array([torch.device("cpu")] * 8).reshape(2, 4), ("agents",))


def test_state_and_facade_have_every_reference_method():
    """An AST diff of the classes: the port's `HypervisorState` has all of
    the reference's methods (the mesh helpers included, 108), and
    `core.Hypervisor` and `ManagedSession` all of theirs."""
    import ast
    from pathlib import Path

    import hypervisor_tpu
    import hypervisor_tpu_torch

    def methods(pkg, rel, cls):
        tree = ast.parse((Path(pkg.__file__).parent / rel).read_text())
        (node,) = [n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == cls]
        return {m.name for m in node.body if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}

    for rel, cls in (("state.py", "HypervisorState"), ("core.py", "Hypervisor"),
                     ("core.py", "ManagedSession")):
        want = methods(hypervisor_tpu, rel, cls)
        assert want <= methods(hypervisor_tpu_torch, rel, cls), (cls, sorted(
            want - methods(hypervisor_tpu_torch, rel, cls)))
    assert len(methods(hypervisor_tpu, "state.py", "HypervisorState")) == 108
