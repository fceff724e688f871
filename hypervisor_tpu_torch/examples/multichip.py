"""Multi-device governance: mesh setup, sharded admission, cross-shard slash.

The reference's walkthrough (`examples/multichip.py`) on the port's
single-controller mesh. The reference scales its mesh down to the
devices it finds; the port's `parallel.make_mesh` never falls back, so
this example asks for an explicit virtual mesh: `SHARDS` (8) shards of
one device (`cuda:0` by default), the analog of the reference's 8
virtual CPU devices, and says so when it runs:

    python -m hypervisor_tpu_torch.examples.multichip [--device cpu]

Walkthrough:
  1. build a Mesh over the agent axis (`parallel.make_mesh(devices=)`),
  2. run STRONG-mode sharded admission for one session whose joining
     agents land on different shards — the global seat budget and
     vouched sigma_eff contributions are computed with psum/all_gather,
  3. slash a vouchee whose liability edges live on different shards —
     the cascade combines per-shard partials so the voucher is clipped
     with the correct global k,
  4. chain an audit log sharded over the TURN axis (sequence
     parallelism) and verify it matches the single-device chain bit for
     bit,
  5. reconcile EVENTUAL-mode partials between ticks,
  6. run the fused sharded governance wave and hold its Merkle roots to
     the single-device wave's.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

#: Shards of the virtual mesh: the reference's virtual CPU device count.
SHARDS = 8


def main(argv=None) -> int:
    from hypervisor_tpu_torch import resolve_device, u32
    from hypervisor_tpu_torch.models import SessionState
    from hypervisor_tpu_torch.ops import liability as liability_ops
    from hypervisor_tpu_torch.ops import merkle as merkle_ops
    from hypervisor_tpu_torch.ops.pipeline import governance_wave
    from hypervisor_tpu_torch.parallel import make_mesh
    from hypervisor_tpu_torch.parallel.collectives import (
        reconcile,
        sharded_admission,
        sharded_chain,
        sharded_governance_wave,
        sharded_slash,
    )
    from hypervisor_tpu_torch.tables.state import (
        SF32_MIN_SIGMA,
        SI32_MAX_PARTICIPANTS,
        SI32_STATE,
        AgentTable,
        SessionTable,
        VouchTable,
    )

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="the one device the virtual mesh repeats (cpu without a card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = SHARDS
    mesh = make_mesh(devices=[dev] * n)
    print(f"mesh: {n} x {dev.type} over axis 'agents'")
    print(f"  (a virtual mesh: {n} shards of {dev}; the port's make_mesh never "
          f"scales down to the devices it finds)")

    def host(t) -> np.ndarray:
        return t.cpu().numpy()

    # ── 1+2. one session, joiners spread over every shard ─────────────
    rows_per_shard = 4
    b = n * 2                       # two joiners per shard
    seats = b - 3                   # force capacity rejections
    agents = AgentTable.create(n * rows_per_shard, dev)
    sessions = SessionTable.create(4, dev)
    sessions.i32[0, SI32_STATE] = 1              # HANDSHAKING
    sessions.i32[0, SI32_MAX_PARTICIPANTS] = seats
    sessions.f32[0, SF32_MIN_SIGMA] = 0.0
    # Wave element i targets a row on shard i // 2 (slot contract).
    slots = np.array(
        [(i // 2) * rows_per_shard + (i % 2) for i in range(b)], np.int32
    )
    admit = sharded_admission(mesh)
    agents, sessions, status, ring, sig = admit(
        agents,
        sessions,
        VouchTable.create(n * 4, dev),
        torch.from_numpy(slots).to(dev),
        torch.arange(b, dtype=torch.int32, device=dev),
        torch.zeros(b, dtype=torch.int32, device=dev),
        torch.full((b,), 0.8, dtype=torch.float32, device=dev),
        torch.ones(b, dtype=torch.bool, device=dev),
        torch.zeros(b, dtype=torch.bool, device=dev),
        0.0,
        0.5,
    )
    st = host(status)
    print(
        f"sharded admission: {int((st == 0).sum())}/{b} admitted "
        f"({int((st == 3).sum())} capacity-rejected by the GLOBAL seat "
        f"budget of {seats}); session count = "
        f"{int(host(sessions.n_participants)[0])}"
    )

    # ── 3. slash with liability edges on different shards ─────────────
    e_cap = n * 4
    vt = VouchTable.create(e_cap, dev)
    rows = torch.tensor([0, e_cap - 1], device=dev)    # first and last shard
    vt.voucher[rows] = 0
    vt.vouchee[rows] = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    vt.session[rows] = 0
    vt.bond[rows] = 0.2
    vt.active[rows] = True
    vt.expiry[rows] = 1e9
    sigma = torch.full((agents.did.shape[0],), 0.9, dtype=torch.float32, device=dev)
    seeds = torch.zeros_like(sigma, dtype=torch.bool)
    seeds[torch.tensor([1, 2], device=dev)] = True
    out = sharded_slash(mesh)(vt, sigma, seeds, 0, 0.5, 0.0)
    single = liability_ops.slash_cascade(vt, sigma, seeds, 0, 0.5, 0.0)
    assert (host(out.sigma) == host(single.sigma)).all()
    print(
        f"cross-shard slash: voucher clipped 0.9 -> "
        f"{float(host(out.sigma)[0]):.4f} with global k=2 "
        f"(edges on shards 0 and {n - 1}); bit-identical to single-device"
    )

    # ── 4. sequence-parallel audit chain ──────────────────────────────
    t_total, lanes = n * 2, 4
    rng = np.random.RandomState(0)
    bodies = rng.randint(
        0, 2**32, size=(t_total, lanes, merkle_ops.BODY_WORDS), dtype=np.uint64
    ).astype(np.uint32)
    bodies_t = u32.from_numpy_u32(bodies, dev)
    got = host(sharded_chain(mesh)(bodies_t, torch.zeros((lanes, 8), dtype=torch.int32,
                                                           device=dev)))
    want = host(merkle_ops.chain_digests(bodies_t))
    assert (got == want).all()
    print(
        f"sequence-parallel chain: {t_total} turns x {lanes} lanes sharded "
        f"over {n} devices, bit-exact vs the single-chip scan"
    )

    # ── 5. EVENTUAL mode: local partials, reconcile between ticks ─────
    partials = np.arange(n * 4, dtype=np.float32).reshape(n * 4)
    merged = host(reconcile(mesh)(torch.from_numpy(partials).to(dev)))
    assert merged[0] == partials.reshape(n, 4).sum(axis=0)[0]
    print(
        f"EVENTUAL reconcile: {n} shards' local partials allreduced "
        f"between ticks (zero in-tick communication)"
    )

    # ── 6. the FUSED sharded governance wave ──────────────────────────
    # Admission + FSM + audit chain/Merkle + saga step + terminate as one
    # sharded wave on the real tables, bit-par with the single-device
    # wave. Both update their tables in place, so each gets its own.
    b_w, k_w, t_w = n * 2, n, 3

    def tables():
        agents_w = AgentTable.create(n * rows_per_shard, dev)
        sessions_w = SessionTable.create(2 * k_w, dev)
        sessions_w.i32[:k_w, SI32_STATE] = 1
        sessions_w.i32[:k_w, SI32_MAX_PARTICIPANTS] = 10
        sessions_w.f32[:k_w, SF32_MIN_SIGMA] = 0.0
        return agents_w, sessions_w, VouchTable.create(n * 4, dev)

    slots_w = np.array(
        [(i // 2) * rows_per_shard + (i % 2) for i in range(b_w)], np.int32
    )
    bodies_w = rng.randint(
        0, 2**32, size=(t_w, k_w, merkle_ops.BODY_WORDS), dtype=np.uint64
    ).astype(np.uint32)
    wave_args = (
        torch.from_numpy(slots_w).to(dev),
        torch.arange(b_w, dtype=torch.int32, device=dev),
        torch.from_numpy(np.array([i // 2 for i in range(b_w)], np.int32)).to(dev),
        torch.full((b_w,), 0.8, dtype=torch.float32, device=dev),
        torch.ones((b_w,), dtype=torch.bool, device=dev),
        torch.zeros((b_w,), dtype=torch.bool, device=dev),
        torch.arange(k_w, dtype=torch.int32, device=dev),
        u32.from_numpy_u32(bodies_w, dev),
        3.0,
        0.5,
    )
    fused = sharded_governance_wave(mesh)(*tables(), *wave_args)
    single = governance_wave(*tables(), *wave_args)
    assert (host(fused.merkle_root) == host(single.merkle_root)).all()
    arch = host(fused.sessions.state)[:k_w]
    assert (arch == SessionState.ARCHIVED.code).all()
    print(
        f"fused sharded wave: {b_w} joins into {k_w} sessions, full "
        f"pipeline in one sharded wave, Merkle roots bit-identical "
        f"to the single-device wave, all sessions archived"
    )
    print("multichip walkthrough complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
