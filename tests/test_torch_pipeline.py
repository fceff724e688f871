"""The port's `governance_pipeline` against the reference's, on the CPU.

Counterparts of the four single-device tests of
`tests/parity/test_pipeline.py` (the happy path, an untrustworthy lane
sandboxed, sigma below the session floor, the root against `hashlib`)
on `hypervisor_tpu_torch.ops.pipeline.governance_pipeline`; its two mesh
tests (`TestMultiChip`) have their counterparts in
`tests/test_torch_parallel.py`, over `parallel.strong_tick`,
`eventual_tick` and `reconcile`.

Then the port held against the reference's function called as its own
tests call it (eagerly, the XLA path on the CPU) on seeded numpy inputs,
every field of `PipelineResult` at tolerance 0, the four f32 consensus
sums included: at (S, T) = (8, 3), (37, 5), (64, 1) and (2,048, 3),
lanes mixing untrustworthy, below-floor and inactive ones, with and
without `contribution`, and at the reference's headline row (S =
10,000, T = 3). The reference's `jax.jit` of the same
function contracts `sigma_raw + omega * contribution` into one fused
multiply-add, which rounds once; the port follows the source and rounds
the multiply and the add apart, so under `jit` only `sigma_eff` (and the
sums over it) can part, held by
`test_jitted_reference_fuses_the_vouched_sigma`.
"""

from __future__ import annotations

import hashlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervisor_tpu.ops import pipeline as ref_pipe
from hypervisor_tpu_torch import kernels, u32
from hypervisor_tpu_torch.ops import pipeline as pipe

FIELDS = ("ring", "sigma_eff", "session_state", "saga_step_state", "merkle_root", "status",
          "consensus")


def run_pipeline(s=8, t=3, sigma=0.8, trustworthy=True):
    rng = np.random.RandomState(0)
    bodies = rng.randint(0, 2**32, size=(t, s, 16), dtype=np.uint64).astype(np.uint32)
    return pipe.governance_pipeline(
        torch.full((s,), sigma, dtype=torch.float32),
        torch.full((s,), trustworthy, dtype=torch.bool),
        torch.full((s,), 0.60, dtype=torch.float32),
        u32.from_numpy_u32(bodies, "cpu"),
        torch.ones((s,), dtype=torch.bool),
    ), bodies


class TestPipelineSemantics:
    def test_happy_path(self):
        result, _ = run_pipeline()
        assert (result.status == pipe.PIPE_OK).all()
        assert (result.ring == 2).all()  # sigma 0.8 -> Ring 2
        assert (result.session_state == pipe.S_ARCHIVED).all()
        assert (result.saga_step_state == 2).all()  # COMMITTED
        # consensus: [n_ok, sum sigma, ring mass, checksum]
        c = result.consensus.numpy()
        assert c[0] == 8 and abs(c[1] - 8 * 0.8) < 1e-3

    def test_untrustworthy_sandboxed(self):
        result, _ = run_pipeline(trustworthy=False)
        assert (result.ring == 3).all()
        # sandbox agents are exempt from the sigma floor -> still OK
        assert (result.status == pipe.PIPE_OK).all()

    def test_sigma_below_min_rejected(self):
        # sigma 0.7 -> ring 2, but session floor 0.75 -> rejected
        s = 4
        result = pipe.governance_pipeline(
            torch.full((s,), 0.7, dtype=torch.float32),
            torch.ones((s,), dtype=torch.bool),
            torch.full((s,), 0.75, dtype=torch.float32),
            torch.zeros((3, s, 16), dtype=torch.int32),
            torch.ones((s,), dtype=torch.bool),
        )
        assert (result.status == pipe.PIPE_SIGMA_BELOW_MIN).all()
        assert (result.session_state == pipe.S_CREATED).all()

    def test_merkle_root_matches_hashlib(self):
        result, bodies = run_pipeline(s=2, t=3)
        # lane 0 by hand: the chain, then a 3-leaf tree with the hex-pair
        # combine and the odd leaf duplicated
        parent = b"\x00" * 32
        hexes = []
        for turn in range(3):
            msg = b"".join(struct.pack(">I", x) for x in bodies[turn, 0]) + parent
            parent = hashlib.sha256(msg).digest()
            hexes.append(parent.hex())
        l01 = hashlib.sha256((hexes[0] + hexes[1]).encode()).hexdigest()
        l22 = hashlib.sha256((hexes[2] + hexes[2]).encode()).hexdigest()
        want = hashlib.sha256((l01 + l22).encode()).hexdigest()
        got = "".join(f"{int(w):08x}" for w in result.merkle_root.numpy().view(np.uint32)[0])
        assert got == want


# ── the port against the reference ───────────────────────────────────


def inputs(s: int, t: int, seed: int, contribution: bool) -> dict:
    """Seeded lanes mixing untrustworthy, below-floor and inactive ones."""
    rng = np.random.RandomState(seed)
    out = {
        "sigma_raw": rng.uniform(0, 1, s).astype(np.float32),
        "trustworthy": rng.uniform(size=s) > 0.2,
        "min_sigma_eff": rng.choice(np.float32([0.0, 0.6, 0.75]), s),
        "delta_bodies": rng.randint(0, 2**32, (t, s, 16), dtype=np.uint64).astype(np.uint32),
        "active": rng.uniform(size=s) > 0.1,
    }
    if contribution:
        out["contribution"] = rng.uniform(0, 0.6, s).astype(np.float32)
        out["omega"] = np.float32(rng.uniform(0.1, 0.9))
    return out


def reference(args: dict, fn=ref_pipe.governance_pipeline) -> dict:
    kw = {k: (jnp.float32(v) if k == "omega" else jnp.asarray(v)) for k, v in args.items()}
    r = fn(**kw)
    return {k: np.asarray(getattr(r, k)) for k in FIELDS}


def port(args: dict) -> dict:
    kw = {k: (float(v) if k == "omega" else torch.from_numpy(v)) for k, v in args.items()}
    kw["delta_bodies"] = u32.from_numpy_u32(args["delta_bodies"], "cpu")
    r = pipe.governance_pipeline(**kw)
    out = {k: getattr(r, k).numpy() for k in FIELDS}
    out["merkle_root"] = out["merkle_root"].view(np.uint32)
    return out


def differing(got: dict, want: dict) -> list:
    return [k for k in FIELDS if not (got[k].dtype == want[k].dtype
                                      and got[k].shape == want[k].shape
                                      and got[k].tobytes() == want[k].tobytes())]


@pytest.mark.parametrize("contribution", [False, True], ids=["raw", "vouched"])
@pytest.mark.parametrize("s,t", [(8, 3), (37, 5), (64, 1), (2048, 3)])
def test_every_field_equals_the_reference(s, t, contribution):
    args = inputs(s, t, 1000 * s + t, contribution)
    got, want = port(args), reference(args)
    assert differing(got, want) == []
    # the inputs reach every status, and a vouched lane can clear a floor
    # its raw sigma misses
    assert set(np.unique(want["status"]).tolist()) <= {0, 1, 2}
    if s >= 2048:
        assert set(np.unique(want["status"]).tolist()) == {0, 1, 2}


def test_the_bench_row_equals_the_reference_and_counts_no_launch():
    """`full_governance_pipeline`'s arguments (S = 10,000, T = 3, sigma 0.8,
    all trustworthy, floor 0.60, all active): every field equal, and on
    the CPU the chain and the roots take the plain versions."""
    rng = np.random.RandomState(20)
    s, t = 10_000, 3
    args = {"sigma_raw": np.full(s, 0.8, np.float32), "trustworthy": np.ones(s, bool),
            "min_sigma_eff": np.full(s, 0.6, np.float32),
            "delta_bodies": rng.randint(0, 2**32, (t, s, 16), dtype=np.uint64).astype(np.uint32),
            "active": np.ones(s, bool)}
    kernels.reset_launch_counts()
    got = port(args)
    assert not any(kernels.launch_counts().values())
    want = reference(args)
    assert differing(got, want) == []
    assert want["consensus"][0] == s


def test_one_turn_pads_to_one_leaf():
    """T = 1: `p = 1`, and the root is the chain's one digest (a tree of
    one leaf returns it)."""
    args = inputs(64, 1, 7, False)
    got = port(args)
    chain = pipe.merkle_ops.chain_digests(u32.from_numpy_u32(args["delta_bodies"], "cpu"))
    assert np.array_equal(got["merkle_root"], chain[0].numpy().view(np.uint32))


def test_checksum_word_widens_before_rounding():
    """Root word 0 is u32 stored as int32: a word at or above 2^31 counts
    as its unsigned value (widened and masked, then rounded to f32)."""
    args = inputs(2048, 3, 3, False)
    got = port(args)
    words = got["merkle_root"][:, 0]
    assert (words >= 2**31).any()
    ok = (got["status"] == pipe.PIPE_OK).astype(np.float32)
    signed = np.float32(np.sum(words.view(np.int32).astype(np.float32) * ok, dtype=np.float64))
    assert got["consensus"][3] > 0 and got["consensus"][3] != signed
    assert differing(got, reference(args)) == []


def test_use_pallas_is_accepted_and_not_read():
    args = inputs(37, 3, 5, True)
    kw = {k: (float(v) if k == "omega" else torch.from_numpy(v)) for k, v in args.items()}
    kw["delta_bodies"] = u32.from_numpy_u32(args["delta_bodies"], "cpu")
    a = pipe.governance_pipeline(**kw, use_pallas=True)
    b = pipe.governance_pipeline(**kw, use_pallas=False)
    for k in FIELDS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_jitted_reference_fuses_the_vouched_sigma():
    """Under `jax.jit`, XLA:CPU contracts the vouched sigma into one fused
    multiply-add: only `sigma_eff` and the sums over it part from the
    port, and the port equals the eager reference, which rounds the
    multiply and the add apart as the source does."""
    jitted = jax.jit(ref_pipe.governance_pipeline)
    vouched = inputs(2048, 3, 11, True)
    got = port(vouched)
    parted = differing(got, reference(vouched, jitted))
    assert "sigma_eff" in parted and set(parted) <= {"sigma_eff", "consensus"}
    assert differing(got, reference(vouched)) == []
    fma = np.float32(np.float64(vouched["sigma_raw"])
                     + np.float64(vouched["omega"]) * np.float64(vouched["contribution"]))
    jit_sigma = reference(vouched, jitted)["sigma_eff"]
    moved = got["sigma_eff"] != jit_sigma
    assert np.array_equal(jit_sigma[moved], np.minimum(fma, np.float32(1.0))[moved])
