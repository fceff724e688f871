#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's governance wave on one NVIDIA GPU.

    python3 chip_smoke.py      # from the repository root, one CUDA GPU

Phases, one JSON line each:

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: every CUDA kernel of the wave built from `hypervisor_tpu_torch/
   csrc/` (one nvcc per source, in parallel), with ptxas' report;
3. parity: each kernel against its plain PyTorch version on the same
   inputs on the card, bit-exact (tolerance 0), at the wave's shapes —
   the vouched contribution at the wave's edges, and on 65,536 edges
   with many vouchers per vouchee against the plain version on the CPU
   (which sums in edge order, as the reference does); B2 chains at T=3
   x 10,000 lanes; B3 roots at 10,000 sessions x 4 leaves plus count
   sweeps at 8, 64 and 4096 leaves; B4 admission on the unique-sessions
   wave and on a crowded wave with duplicates and full sessions; B5 at
   the wave's sessions, lanes, edges and agents;
4. wave: bench.py's configuration (10,000 sessions, 1,000 vouched
   lanes at sigma 0.5 with bond 0.30, 3 deltas, tables of 16,384 agents,
   16,384 sessions and 65,536 edges, random data from one seed) through
   `HypervisorState.governance_wave`, with the launch counts set to 0
   just before and read just after; bench.py's gates; a hashlib check of
   lanes 0 and K-1; then the same wave through the plain versions on the
   card, which must give identical tables, outputs and counters;
5. timing: the wave's p50/p95 (host clock, synchronised) and device
   time; one wave under torch's sync debug mode "error" (no host
   synchronisation inside the wave); one profiled wave (device time by
   kernel, the device's idle share); each kernel's time, its plain
   version's time, its bound and, where one PyTorch call computes the
   same function, that call's time.

Then the kernels summary, the nvidia-smi line, and a last line
`{"ok": true, "device": {...}}`. Any failed check exits non-zero before
that line. Exits 2 without printing a result when CUDA is absent.
"""

from __future__ import annotations

import hashlib
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

N_SESSIONS = 10_000
N_VOUCHED = 1_000
N_DELTAS = 3
OMEGA = 0.5
SEED = 42
WARMUP = 3
ITERS = 30
KERNEL_REPS = 20
PLAIN_REPS = 5

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth,
# and the 32-bit integer instruction rate — the 67 TFLOP/s FP32 figure
# counts an FMA as two operations on 128 lanes per SM; the integer pipe
# issues one instruction per lane on 64 lanes per SM.
HBM_BYTES_PER_S = 3.35e12
INT32_INSTRUCTIONS_PER_S = 67e12 / 2 / 2


def sha256_instructions(var_words, var_state) -> int:
    """Integer instructions one SHA-256 compression needs on sm_90, given
    which of its 16 message words and 8 state words vary with the data;
    work on constants alone folds at compile time and counts nothing.
    A rotate is one funnel shift (SHF), a 3-input logic function one
    LOP3 (each Sigma's XOR, Ch, Maj), a 3-input add one IADD3, and a
    constant operand (K_i + W_i where W_i is constant) one immediate."""
    def add(*terms):  # (instructions, varies)
        n_var = sum(terms)
        n = n_var + (n_var < len(terms))  # the constants fold into one
        return (n // 2 if n_var else 0), n_var > 0

    w, st, cost = list(var_words), list(var_state), 0
    a, b, c, d, e, f, g, h = st
    for i in range(64):
        if i < 16:
            wi = w[i]
        else:
            s0, s1 = w[(i - 15) & 15], w[(i - 2) & 15]    # 2 SHF + SHR + LOP3 each
            n, wi = add(w[i & 15], s0, w[(i - 7) & 15], s1)
            cost += 4 * s0 + 4 * s1 + n
            w[i & 15] = wi
        n1, t1 = add(h, e, e or f or g, False, wi)        # h + S1 + Ch + K + W
        n2, e_new = add(d, t1)
        n3, a_new = add(t1, a, a or b or c)               # t1 + S0 + Maj
        cost += 4 * e + (e or f or g) + 4 * a + (a or b or c) + n1 + n2 + n3
        h, g, f, e, d, c, b, a = g, f, e, e_new, c, b, a, a_new
    return cost + sum(add(x, y)[0] for x, y in zip(st, (a, b, c, d, e, f, g, h)))


V, C = True, False
#: sha256(body || parent): the first block from the constant initial
#: state, then 8 parent words and 8 constant padding words.
INSTR_PER_CHAIN_LINK = (sha256_instructions([V] * 16, [C] * 8)
                        + sha256_instructions([V] * 8 + [C] * 8, [V] * 8))
#: One digest as 16 ASCII hex words, 8 instructions a word in a SWAR form:
#: PRMT spreads two bytes, SHF + LOP3 split the nibbles, IADD + LOP3 + SHF
#: find the nibbles above 9, IADD + IMAD add '0' and the 0x27 letter gap.
INSTR_PER_HEX_DIGEST = 16 * 8
#: sha256(hex(l) || hex(r)): two data blocks, then a constant padding
#: block whose schedule folds away. An odd tail's pair (r := l) hexes once.
INSTR_PER_PAIR = (sha256_instructions([V] * 16, [C] * 8) + sha256_instructions([V] * 16, [V] * 8)
                  + sha256_instructions([C] * 16, [V] * 8) + 2 * INSTR_PER_HEX_DIGEST)
INSTR_PER_DUP_PAIR = INSTR_PER_PAIR - INSTR_PER_HEX_DIGEST

TPU_KERNELS = {
    "contribution_toward": "hypervisor_tpu/ops/liability.py:93",  # an XLA scatter, not Pallas
    "chain_digests": "hypervisor_tpu/kernels/mtu_pallas.py:319",
    "tree_roots": "hypervisor_tpu/kernels/mtu_pallas.py:237",
    "admission_block": "hypervisor_tpu/kernels/wave_pallas.py:1318",
    "fsm_saga_block": "hypervisor_tpu/kernels/wave_pallas.py:1441",
}
SOURCES = {
    "contribution_toward": "hypervisor_tpu_torch/csrc/wave.cu",
    "chain_digests": "hypervisor_tpu_torch/csrc/mtu.cu",
    "tree_roots": "hypervisor_tpu_torch/csrc/mtu.cu",
    "admission_block": "hypervisor_tpu_torch/csrc/wave.cu",
    "fsm_saga_block": "hypervisor_tpu_torch/csrc/wave.cu",
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2

    from hypervisor_tpu_torch import kernels, u32
    from hypervisor_tpu_torch.config import DEFAULT_CONFIG, HypervisorConfig, TableCapacity
    from hypervisor_tpu_torch.kernels import _build, mtu, wave
    from hypervisor_tpu_torch.models import SessionConfig
    from hypervisor_tpu_torch.ops import liability, merkle, pipeline
    from hypervisor_tpu_torch.ops.admission import ADMIT_OK, f32_scalar
    from hypervisor_tpu_torch.ops.sha256 import digests_to_hex
    from hypervisor_tpu_torch.state import HypervisorState
    from hypervisor_tpu_torch.tables.state import VouchTable
    from hypervisor_tpu_torch.tables.struct import clone, copy_into, tensors

    dev = torch.device("cuda", 0)

    # ── 1. device ────────────────────────────────────────────────────
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, torch_name=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    # ── 2. build ─────────────────────────────────────────────────────
    t0 = time.perf_counter()
    reports = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {
        name: re.findall(r"(?:Compiling entry function '(\w+)'|(Used \d+ registers[^\n]*))", log)
        for name, log in reports.items()
    }
    emit("build", seconds=round(build_s, 3),
         ptxas={k: [a or b for a, b in v] for k, v in ptxas.items()})

    # ── helpers ──────────────────────────────────────────────────────
    def bits(t):
        if t.dtype == torch.float32:
            return t.view(torch.int32)
        if t.dtype == torch.bool:
            return t.to(torch.uint8)
        return t

    def same(a, b) -> bool:
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(bits(a), bits(b))

    def max_abs_err(pairs, words=()) -> float:
        """Largest |kernel - plain| over named tensor pairs; u32 words
        (the names in `words`) compare as unsigned values."""
        err = 0.0
        for name, (a, b) in pairs.items():
            if name in words:
                d = (u32.widen(a) - u32.widen(b)).abs()
            elif a.dtype == torch.float32:
                d = (a.double() - b.double()).abs()
            else:
                d = (a.long() - b.long()).abs()
            if d.numel():
                err = max(err, float(d.max()))
        return err

    def check_pairs(name: str, pairs: dict, words=()) -> float:
        for col, (a, b) in pairs.items():
            require(same(a, b), f"{name}: kernel and plain version differ in {col}")
        return max_abs_err(pairs, words)

    def table_pairs(prefix: str, a, b) -> dict:
        ta, tb = tensors(a), tensors(b)
        return {f"{prefix}.{k}": (ta[k], tb[k]) for k in ta}

    def time_device(fn, reset=None, reps=KERNEL_REPS, warmup=2, sleep_cycles=2_000_000):
        """Median device milliseconds of one call, from CUDA events. A
        busy-wait kernel queued first keeps the card busy while the host
        enqueues the call, so the events bracket device work, not host
        launch overhead; `reset` restores in-place inputs, untimed."""
        pairs = []
        for i in range(warmup + reps):
            if reset is not None:
                reset()
            torch.cuda._sleep(sleep_cycles)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            if i >= warmup:
                pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    # ── bench.py's state ─────────────────────────────────────────────
    config = HypervisorConfig(capacity=TableCapacity(
        max_agents=max(DEFAULT_CONFIG.capacity.max_agents, N_SESSIONS + N_VOUCHED + 64),
        max_sessions=max(16_384, N_SESSIONS + 64),
        max_vouch_edges=DEFAULT_CONFIG.capacity.max_vouch_edges,
    ))
    state = HypervisorState(config, device=dev)
    session_slots = state.create_sessions_batch(
        [f"bench:s{i}" for i in range(N_SESSIONS)], SessionConfig(min_sigma_eff=0.0)
    )
    dids = [f"did:bench:{i}" for i in range(N_SESSIONS)]
    agent_slots = np.arange(N_SESSIONS, dtype=np.int32)
    v = state.vouches
    v.voucher[:N_VOUCHED] = torch.arange(N_SESSIONS, N_SESSIONS + N_VOUCHED, device=dev)
    v.vouchee[:N_VOUCHED] = torch.from_numpy(agent_slots[:N_VOUCHED]).to(dev)
    v.session[:N_VOUCHED] = torch.from_numpy(session_slots[:N_VOUCHED]).to(dev)
    v.bond[:N_VOUCHED] = 0.30
    v.active[:N_VOUCHED] = True
    rng = np.random.RandomState(SEED)
    sigma = np.full(N_SESSIONS, 0.8, np.float32)
    sigma[:N_VOUCHED] = 0.50
    bodies = rng.randint(0, 2**32, (N_DELTAS, N_SESSIONS, 16), dtype=np.uint64).astype(np.uint32)
    lanes = state.stage_wave(agent_slots, dids, session_slots, sigma, bodies)
    require(lanes["unique_sessions"] and lanes["wave_range"] == (0, N_SESSIONS),
            "bench staging must take the unique-sessions, wave-range layout")
    pristine = {k: clone(getattr(state, k)) for k in ("agents", "sessions", "vouches", "metrics")}

    def restore(dst: dict, src: dict) -> None:
        for k, t in src.items():
            copy_into(dst[k], t)

    live = {k: getattr(state, k) for k in pristine}
    n_cap = state.agents.i32.shape[0]
    slot_t, sess_t = lanes["slot"], lanes["session_slot"]
    target = torch.full((n_cap,), -2, dtype=torch.int32, device=dev)
    target[slot_t.long()] = sess_t
    contribution = liability.contribution_toward(
        state.vouches, target, f32_scalar(0.0, dev))[slot_t.long()]
    kernel_rows = {}

    # ── 3. parity, kernel against plain, on the card ─────────────────
    # The vouched contribution: the wave's edges (one per vouchee), then
    # many vouchers per vouchee against the CPU's edge-order sum.
    now0 = f32_scalar(0.0, dev)
    err_c0 = check_pairs("contribution_toward", {"contribution": (
        wave.contribution_toward(state.vouches, target, now0),
        liability.contribution_toward(state.vouches, target, now0))})
    n_edges = state.vouches.session.shape[0]
    multi = VouchTable.create(n_edges, dev)
    multi.voucher.copy_(torch.from_numpy(rng.randint(0, n_cap, n_edges).astype(np.int32)))
    multi.vouchee.copy_(torch.from_numpy(rng.randint(-1, 2000, n_edges).astype(np.int32)))
    multi.session.copy_(torch.from_numpy(rng.randint(0, 8, n_edges).astype(np.int32)))
    multi.bond.copy_(torch.from_numpy(rng.uniform(0, 0.4, n_edges).astype(np.float32)))
    multi.active.copy_(torch.from_numpy(rng.uniform(size=n_edges) > 0.1))
    multi.expiry.copy_(torch.from_numpy(
        rng.choice([-1.0, 5.0, np.inf], n_edges).astype(np.float32)))
    m_target = torch.from_numpy(rng.randint(-2, 8, n_cap).astype(np.int32)).to(dev)
    got_c = wave.contribution_toward(multi, m_target, now0)
    again_c = wave.contribution_toward(multi, m_target, now0)
    cpu_v = VouchTable(**{k: t.cpu() for k, t in tensors(multi).items()})
    want_c = liability.contribution_toward(cpu_v, m_target.cpu(), f32_scalar(0.0, "cpu"))
    err_c1 = check_pairs("contribution_toward, several vouchers", {
        "contribution": (got_c.cpu(), want_c), "repeat": (again_c, got_c)})
    keys, _ = liability.contribution_runs(multi, m_target, now0)
    per_vouchee = torch.bincount(keys[keys < n_cap].long())
    require(int(per_vouchee.max()) >= 3, "the multi-edge case needs several edges per vouchee")
    plain_card = liability.contribution_toward(multi, m_target, now0)
    emit("parity", kernel="contribution_toward", edges=n_edges, bit_exact=True,
         max_abs_err=max(err_c0, err_c1), scoped_edges=int(per_vouchee.sum()),
         max_edges_per_vouchee=int(per_vouchee.max()),
         index_add_on_card_equal_to_cpu=same(plain_card.cpu(), want_c))

    # B2: chains.
    seeds0 = torch.zeros((N_SESSIONS, 8), dtype=torch.int32, device=dev)
    seeds_r = u32.from_numpy_u32(
        rng.randint(0, 2**32, (N_SESSIONS, 8), dtype=np.uint64).astype(np.uint32), dev)
    body_t = lanes["delta_bodies"]
    err_b2 = 0.0
    for seeds in (seeds0, seeds_r):
        got = mtu.chain_digests(body_t, seeds)
        want = mtu.chain_digests_plain(body_t, seeds)
        err_b2 = max(err_b2, check_pairs("chain_digests", {"chain": (got, want)}, ("chain",)))
    emit("parity", kernel="chain_digests", shape=[N_DELTAS, N_SESSIONS, 16],
         bit_exact=True, max_abs_err=err_b2)

    # B3: roots at the wave's shape, then count sweeps.
    chain0 = mtu.chain_digests_plain(body_t, seeds0)
    leaves = torch.zeros((N_SESSIONS, 4, 8), dtype=torch.int32, device=dev)
    leaves[:, :N_DELTAS] = chain0.transpose(0, 1)
    counts3 = torch.full((N_SESSIONS,), N_DELTAS, dtype=torch.int32, device=dev)
    err_b3 = check_pairs("tree_roots", {"roots": (
        mtu.tree_roots(leaves, counts3), mtu.tree_roots_plain(leaves, counts3))}, ("roots",))
    sweeps = {8: list(range(9)), 64: list(range(65)),
              4096: [0, 1, 2, 3, 5, 1000, 2049, 4095, 4096]}
    for p, cnts in sweeps.items():
        lv = u32.from_numpy_u32(
            rng.randint(0, 2**32, (len(cnts), p, 8), dtype=np.uint64).astype(np.uint32), dev)
        ct = torch.tensor(cnts, dtype=torch.int32, device=dev)
        err_b3 = max(err_b3, check_pairs(f"tree_roots P={p}", {"roots": (
            mtu.tree_roots(lv, ct), mtu.tree_roots_plain(lv, ct))}, ("roots",)))
    emit("parity", kernel="tree_roots", shape=[N_SESSIONS, 4, 8], sweeps=sorted(sweeps),
         bit_exact=True, max_abs_err=err_b3)

    # B4: admission, the wave's unique lanes and a crowded wave.
    adm_args = (slot_t, lanes["did"], sess_t, lanes["sigma_raw"], contribution, OMEGA,
                lanes["trustworthy"], lanes["duplicate"], 0.0,
                DEFAULT_CONFIG.rate_limit.ring_bursts, DEFAULT_CONFIG.trust)

    def admission_parity(tag, args, unique, sessions_src):
        ka, ks = clone(pristine["agents"]), clone(sessions_src)
        pa, ps = clone(pristine["agents"]), clone(sessions_src)
        got = wave.admission_block(ka, ks, *args, unique)
        want = wave.admission_block_plain(pa, ps, *args, unique)
        pairs = {"status": (got[0], want[0]), "ring": (got[1], want[1]),
                 "sigma_eff": (got[2], want[2])}
        pairs.update(table_pairs("agents", ka, pa))
        pairs.update(table_pairs("sessions", ks, ps))
        return check_pairs(f"admission_block {tag}", pairs), got[0]

    err_b4, status_u = admission_parity("unique", adm_args, True, pristine["sessions"])
    require(bool((status_u == ADMIT_OK).all()), "the bench lanes must all be admitted")
    crowded = clone(pristine["sessions"])
    crowded.f32[:2000:7, 0] = 0.7          # a sigma floor on some sessions
    crowded.i32[1990:2000, 3] = 0          # some sessions not open yet
    c_sess = np.where(rng.uniform(size=N_SESSIONS) < 0.5,
                      rng.randint(0, 2000, N_SESSIONS), rng.randint(0, 10, N_SESSIONS))
    c_args = (slot_t, lanes["did"], torch.from_numpy(c_sess.astype(np.int32)).to(dev),
              torch.from_numpy(rng.uniform(0.2, 1.0, N_SESSIONS).astype(np.float32)).to(dev),
              contribution, OMEGA,
              torch.from_numpy(rng.uniform(size=N_SESSIONS) > 0.1).to(dev),
              torch.from_numpy(rng.uniform(size=N_SESSIONS) > 0.9).to(dev), 3.0,
              DEFAULT_CONFIG.rate_limit.ring_bursts, DEFAULT_CONFIG.trust)
    err_c, status_c = admission_parity("crowded", c_args, False, crowded)
    codes = sorted(set(status_c.tolist()))
    require({0, 1, 2, 3, 4} <= set(codes), f"the crowded wave must hit every status, got {codes}")
    emit("parity", kernel="admission_block", lanes=N_SESSIONS, unique=True, crowded_codes=codes,
         bit_exact=True, max_abs_err=max(err_b4, err_c))

    # B5: fsm/saga/terminate on the post-admission tables.
    post = {"agents": clone(pristine["agents"]), "sessions": clone(pristine["sessions"]),
            "vouches": clone(pristine["vouches"])}
    status_m, _, _ = wave.admission_block(post["agents"], post["sessions"], *adm_args, True)
    ok_m = status_m == ADMIT_OK
    ks_t = lanes["wave_sessions"]
    kt = {k: clone(t) for k, t in post.items()}
    pt = {k: clone(t) for k, t in post.items()}
    got = wave.fsm_saga_block(kt["agents"], kt["sessions"], kt["vouches"], ks_t, ok_m, 0.0,
                              (0, N_SESSIONS))
    want = wave.fsm_saga_block_plain(pt["agents"], pt["sessions"], pt["vouches"], ks_t, ok_m,
                                     0.0, (0, N_SESSIONS))
    pairs = {"step": (got[0], want[0]), "wave_state": (got[1], want[1]),
             "fsm_error": (got[2], want[2]), "released": (got[3], want[3])}
    for k in kt:
        pairs.update(table_pairs(k, kt[k], pt[k]))
    err_b5 = check_pairs("fsm_saga_block", pairs)
    emit("parity", kernel="fsm_saga_block", sessions=N_SESSIONS, lanes=N_SESSIONS,
         edges=int(state.vouches.active.shape[0]), agents=n_cap, bit_exact=True,
         max_abs_err=err_b5)
    errs = {"contribution_toward": max(err_c0, err_c1), "chain_digests": err_b2, "tree_roots": err_b3,
            "admission_block": max(err_b4, err_c), "fsm_saga_block": err_b5}

    # ── 4. the full-width wave through the entry point ───────────────
    restore(live, pristine)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    result = state.governance_wave(agent_slots, dids, session_slots, sigma, bodies)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    require(all(n >= 1 for n in launches.values()), f"a kernel was not launched: {launches}")

    status = result.status.cpu().numpy()
    require((status == 0).all(), f"wave lanes failed: {np.unique(status)}")
    require(not bool(result.fsm_error.any()), "illegal session FSM walk")
    rings = result.ring.cpu().numpy()
    sig_eff = result.sigma_eff.cpu().numpy()
    require((rings == 2).all(), "vouched lanes not lifted / plain lanes not ring 2")
    require(np.allclose(sig_eff[:N_VOUCHED], 0.65, atol=1e-6), "vouched sigma_eff != 0.65")
    require(int(result.released) == N_VOUCHED, "bonds not released")
    chain_np = u32.to_numpy_u32(result.chain)
    roots_np = u32.to_numpy_u32(result.merkle_root)
    for lane in (0, N_SESSIONS - 1):
        parent, hexes = b"\x00" * 32, []
        for body in bodies[:, lane]:
            parent = hashlib.sha256(body.astype(">u4").tobytes() + parent).digest()
            hexes.append(parent.hex())
        require(digests_to_hex(chain_np[:, lane]) == hexes, f"chain mismatch on lane {lane}")
        require(digests_to_hex(roots_np[lane][None])[0] == merkle.merkle_root_host(hexes),
                f"root mismatch on lane {lane}")
    counters = u32.to_numpy_u32(result.metrics.counters)

    plain_tables = {k: clone(t) for k, t in pristine.items()}
    plain = pipeline.run_wave(pipeline.PLAIN_BLOCKS, **{**lanes, **plain_tables})
    torch.cuda.synchronize()
    pairs = {f: (getattr(result, f), getattr(plain, f)) for f in (
        "status", "ring", "sigma_eff", "saga_step_state", "merkle_root", "chain",
        "fsm_error", "released")}
    for k in plain_tables:
        pairs.update(table_pairs(k, live[k], plain_tables[k]))
    check_pairs("governance_wave", pairs)
    emit("wave", sessions=N_SESSIONS, vouched=N_VOUCHED, deltas=N_DELTAS, launches=launches,
         gates="passed", hashlib_lanes=[0, N_SESSIONS - 1], plain_on_card="identical",
         counters={"wave_ticks": int(counters[0]), "admitted": int(counters[1]),
                   "refused": int(counters[2]), "archived": int(counters[3]),
                   "bonds_released": int(counters[4]), "saga_committed": int(counters[5]),
                   "saga_failed": int(counters[6])})

    # ── 5. timing ────────────────────────────────────────────────────
    samples = []
    for i in range(WARMUP + ITERS):
        restore(live, pristine)
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        pipeline.governance_wave(**lanes)
        torch.cuda.synchronize()
        if i >= WARMUP:
            samples.append((time.perf_counter_ns() - t0) / 1e6)
    wave_device_ms = time_device(lambda: pipeline.governance_wave(**lanes),
                                 reset=lambda: restore(live, pristine), reps=10,
                                 sleep_cycles=40_000_000)
    p50, p95 = float(np.percentile(samples, 50)), float(np.percentile(samples, 95))
    emit("timing", wave_ms_p50=p50, wave_ms_p95=p95,
         per_session_us_p50=p50 * 1e3 / N_SESSIONS, per_session_us_p95=p95 * 1e3 / N_SESSIONS,
         wave_device_ms=wave_device_ms, iters=ITERS, clock="host, synchronised")

    # No host synchronisation inside the wave: torch raises on any
    # synchronising CUDA call while this mode is on.
    restore(live, pristine)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    pipeline.governance_wave(**lanes)
    torch.cuda.set_sync_debug_mode("default")

    # Where one wave's device time goes (torch.profiler, CUPTI).
    from torch.profiler import ProfilerActivity, profile

    restore(live, pristine)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter_ns()
        pipeline.governance_wave(**lanes)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter_ns() - t0) / 1e6
    from torch.autograd import DeviceType

    by_name = []  # device-side events only (kernels, copies, fills)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            by_name.append((e.self_device_time_total, e.key, e.count))
    by_name.sort(reverse=True)
    busy_ms = sum(us for us, _, _ in by_name) / 1e3
    emit("profile", wall_ms=prof_wall_ms, device_busy_ms=busy_ms,
         device_idle_share=(1 - busy_ms / prof_wall_ms) if prof_wall_ms else None,
         top=[{"name": k[:80], "device_us": us, "count": n} for us, k, n in by_name[:15]],
         n_device_ops=sum(n for _, _, n in by_name))

    # Each kernel at the wave's inputs; in-place kernels restore first.
    def restore_post(dst):
        for k, t in post.items():
            copy_into(dst[k], t)

    def restore_pre(dst):
        copy_into(dst["agents"], pristine["agents"])
        copy_into(dst["sessions"], pristine["sessions"])

    scratch = {k: clone(t) for k, t in post.items()}
    calls = {
        "contribution_toward": (
            lambda: wave.contribution_toward(pristine["vouches"], target, now0),
            lambda: liability.contribution_toward(pristine["vouches"], target, now0), None),
        "chain_digests": (lambda: mtu.chain_digests(body_t, seeds0),
                          lambda: mtu.chain_digests_plain(body_t, seeds0), None),
        "tree_roots": (lambda: mtu.tree_roots(leaves, counts3),
                       lambda: mtu.tree_roots_plain(leaves, counts3), None),
        "admission_block": (
            lambda: wave.admission_block(scratch["agents"], scratch["sessions"], *adm_args, True),
            lambda: wave.admission_block_plain(scratch["agents"], scratch["sessions"],
                                               *adm_args, True),
            lambda: restore_pre(scratch)),
        "fsm_saga_block": (
            lambda: wave.fsm_saga_block(scratch["agents"], scratch["sessions"],
                                        scratch["vouches"], ks_t, ok_m, 0.0, (0, N_SESSIONS)),
            lambda: wave.fsm_saga_block_plain(scratch["agents"], scratch["sessions"],
                                              scratch["vouches"], ks_t, ok_m, 0.0,
                                              (0, N_SESSIONS)),
            lambda: restore_post(scratch)),
    }

    # The one PyTorch call that computes the same function, where there
    # is one: the contribution's scatter-add, on the masked bonds.
    vee_l, scoped_l = liability.scoped_edges(pristine["vouches"], target, now0)
    bond_l = pristine["vouches"].bond
    vals_l = torch.where(scoped_l, bond_l, torch.zeros_like(bond_l))
    lib_out = torch.zeros((n_cap,), dtype=torch.float32, device=dev)
    library = {"contribution_toward": lambda: lib_out.index_add_(0, vee_l, vals_l)}

    # Bounds: the bytes each function must move (inputs read once, outputs
    # written once, counting what this run's data needs) over HBM
    # bandwidth, against its 32-bit integer instructions (counted as the
    # work needs them, see sha256_instructions) over the integer rate.
    l_, t_ = N_SESSIONS, N_DELTAS
    pairs = dup_pairs = 0
    for c in counts3.tolist():
        m = leaves.shape[1]
        while m > 1 and c > 1:
            pairs += (c + 1) // 2
            dup_pairs += c % 2
            c, m = (c + 1) // 2, m // 2
    n_ok = int(ok_m.sum())
    agent_hits = int(((post["agents"].i32[:, 1] >= 0)
                      & (post["agents"].i32[:, 1] < N_SESSIONS)).sum())
    edges = int(state.vouches.session.shape[0])
    work = {
        "contribution_toward": (edges * (4 + 4 + 1 + 4 + 4) + n_cap * 4 + n_cap * 4, edges * 8),
        "chain_digests": (t_ * l_ * 64 + l_ * 32 + t_ * l_ * 32, t_ * l_ * INSTR_PER_CHAIN_LINK),
        "tree_roots": (l_ * min(N_DELTAS, 4) * 32 + l_ * 4 + l_ * 32,
                       (pairs - dup_pairs) * INSTR_PER_PAIR + dup_pairs * INSTR_PER_DUP_PAIR),
        "admission_block": (l_ * 22 + l_ * 16 + l_ * 6 + n_ok * (117 + 4), l_ * 40),
        "fsm_saga_block": (N_SESSIONS * (4 + 8 + 8 + 2) + l_ * 2 + edges * 5
                           + N_VOUCHED * 1 + n_cap * 4 + agent_hits * 8 + 4,
                           N_SESSIONS * 30 + l_ * 2 + edges * 4 + n_cap * 3),
    }
    rows = []
    for name, (kfn, pfn, reset) in calls.items():
        k_ms = time_device(kfn, reset)
        p_ms = time_device(pfn, reset, reps=PLAIN_REPS, warmup=1)
        lib = library.get(name)
        lib_ms = time_device(lib, reps=PLAIN_REPS, warmup=1) if lib else None
        nbytes, nops = work[name]
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT32_INSTRUCTIONS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": lib_ms, "bytes": nbytes, "int_instructions": nops,
        })
        emit("kernel_timing", **rows[-1])
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    emit("card_after_timing", clocks_power_limit_temp=clocks,
         note="library_ms: index_add_ for the contribution; no PyTorch call computes "
              "SHA-256 or the admission and fsm/saga blocks, so theirs is null")

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
