"""The work model of the chain and root kernels, and the card's peaks.

A frozen copy of `hypervisor_tpu_torch/kernels/work.py` at commit
c365212, lines 26-196 (the peaks, the SHA-256 instruction counts,
`tree_pairs`, `TENANT_FORMS` and `kernel_work`), so that
the roofline shares this benchmark reports keep one yardstick while the
program's own copy changes. `kernel_work(name, **shapes)` gives the bytes
a kernel must move (each input read once, each output written once) and
the 32-bit integer instructions it must issue at those shapes.
"""

from __future__ import annotations


#: Published H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM3
#: bandwidth; the float32 rate outside the tensor cores (67 TFLOP/s
#: counts an FMA as two operations on 128 lanes per SM); the 32-bit
#: integer instruction rate (one instruction per lane on 64 lanes per
#: SM, and no FMA: a quarter of the float figure).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT32_INSTRUCTIONS_PER_S = 67e12 / 2 / 2

PEAKS: dict[str, dict] = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_s": HBM_BYTES_PER_S,
        "f32_ops_s": F32_FLOP_PER_S,
        "int32_ops_s": INT32_INSTRUCTIONS_PER_S,
    },
}


# ── SHA-256 instruction counts ───────────────────────────────────────


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


def instr_per_message(n_blocks: int) -> int:
    """One pre-padded n-block message through the batched hash (B1): the
    kernel cannot tell padding from data, so every word varies."""
    return (sha256_instructions([V] * 16, [C] * 8)
            + (n_blocks - 1) * sha256_instructions([V] * 16, [V] * 8))


def tree_pairs(counts, max_leaves: int) -> tuple[int, int]:
    """(pairs, duplicated pairs) B3 hashes for trees of `counts` leaves
    each in lanes of `max_leaves`: every level halves the count, rounding
    up, and an odd count duplicates its tail."""
    pairs = dup_pairs = 0
    for c in counts:
        m = max_leaves
        while m > 1 and c > 1:
            pairs += (c + 1) // 2
            dup_pairs += c % 2
            c, m = (c + 1) // 2, m // 2
    return pairs, dup_pairs


# ── the model ────────────────────────────────────────────────────────

#: The tenant forms and the solo kernel whose work each does at T x the shapes.
TENANT_FORMS = {
    "contribution_toward_tenants": "contribution_toward",
    "admission_block_tenants": "admission_block",
    "fsm_saga_block_tenants": "fsm_saga_block",
    "chain_digests_ring_tenants": "chain_digests_ring",
}


def kernel_work(name: str, **s) -> tuple[int, int]:
    """(bytes, int32 instructions) of one launch of kernel `name`.

    The shapes each kernel takes:
      contribution_toward  edges, agents
      chain_digests        turns, lanes
      chain_digests_ring   turns, lanes, rows (ring rows written)
      tree_roots           lanes, leaves (read, in all lanes), pairs,
                           dup_pairs
      admission_block      lanes, admitted; contribution=False (the join
                           queue's form) also takes sessions (distinct)
      fsm_saga_block       sessions, lanes, edges, vouched (edges
                           released), agents, agent_hits (agent rows
                           written)
      sha256_words         messages, blocks
      saga_tick_block      sagas, steps
      slash_cascade        edges, agents, depths

    A tenant form (`<kernel>_tenants`) does its solo form's work over
    all T tenants: its shapes are the totals over the tenants.
    """
    if name in TENANT_FORMS:
        return kernel_work(TENANT_FORMS[name], **s)
    if name == "contribution_toward":
        e, n = s["edges"], s["agents"]
        return e * (4 + 4 + 1 + 4 + 4) + n * 4 + n * 4, e * 8
    if name == "chain_digests":
        t, l_ = s["turns"], s["lanes"]
        return t * l_ * 64 + l_ * 32 + t * l_ * 32, t * l_ * INSTR_PER_CHAIN_LINK
    if name == "chain_digests_ring":
        # B2's work, plus the append: the ring rows written (body, digest,
        # session, turn), the wave's sessions read and the cursor written.
        t, l_, rows = s["turns"], s["lanes"], s["rows"]
        return (t * l_ * 64 + l_ * 32 + t * l_ * 32 + rows * (64 + 32 + 4 + 4) + l_ * 4 + 4,
                t * l_ * INSTR_PER_CHAIN_LINK)
    if name == "tree_roots":
        l_, pairs, dup = s["lanes"], s["pairs"], s["dup_pairs"]
        return (s["leaves"] * 32 + l_ * 4 + l_ * 32,
                (pairs - dup) * INSTR_PER_PAIR + dup * INSTR_PER_DUP_PAIR)
    if name == "admission_block":
        l_, ok = s["lanes"], s["admitted"]
        if not s.get("contribution", True):
            # 18 B read and 6 B written a lane, 16 B read and 4 B written
            # per distinct session, 117 B per admitted row.
            return l_ * (18 + 6) + s["sessions"] * (16 + 4) + ok * 117, l_ * 40
        return l_ * 22 + l_ * 16 + l_ * 6 + ok * (117 + 4), l_ * 40
    if name == "fsm_saga_block":
        k, l_, e, n = s["sessions"], s["lanes"], s["edges"], s["agents"]
        return (k * (4 + 8 + 8 + 2) + l_ * 2 + e * 5 + s["vouched"] * 1 + n * 4
                + s["agent_hits"] * 8 + 4,
                k * 30 + l_ * 2 + e * 4 + n * 3)
    if name == "sha256_words":
        b, nb = s["messages"], s["blocks"]
        return b * (nb * 64 + 32), b * instr_per_message(nb)
    if name == "saga_tick_block":
        # Read step, retry and undo rows, saga state, n_steps, cursor, the
        # outcome byte; write step and retry rows, saga state, cursor,
        # committed and exhausted; read and write the two tally counters.
        # About 2M + 20 integer operations a saga for the two row scans.
        g, m = s["sagas"], s["steps"]
        return (g * (3 * m + 1 + 4 + 4 + 1) + g * (2 * m + 1 + 4 + 1 + 1) + 2 * 8,
                g * (2 * m + 20))
    if name == "slash_cascade":
        # Read voucher, vouchee, session, active, expiry per edge and sigma
        # and the first wave per agent; write sigma, slashed, clipped and
        # wave_of per agent and active per edge; read and write the two
        # tally counters. Per depth about ten operations an edge and
        # twenty an agent.
        e, n, d = s["edges"], s["agents"], s["depths"]
        return e * (4 + 4 + 4 + 1 + 4 + 1) + n * (5 + 7) + 2 * 8, d * (e * 10 + n * 20)
    raise KeyError(f"no work model for kernel {name!r}")
