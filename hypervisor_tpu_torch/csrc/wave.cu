// Governance-wave kernels for Hopper (sm_90a): admission (B4), the
// FSM + saga + terminate walk (B5) and the vouched contribution (B6, the
// DeltaLog ring append, is B2's ring form in mtu.cu). Plain
// C entry points, bound with ctypes by hypervisor_tpu_torch/kernels/
// wave.py. Tables are updated in place on the caller's stream; each
// entry returns cudaGetLastError().
//
// Compiled with --fmad=false: sigma_eff = min(sigma + omega * c, 1) must
// round the multiply and the add separately, as the reference does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Column layout of hypervisor_tpu_torch/tables/state.py (pinned by the
// port's tests against that module).
constexpr int AF32_WIDTH = 8;
constexpr int AF32_SIGMA_RAW = 0;
constexpr int AF32_SIGMA_EFF = 1;
constexpr int AF32_JOINED_AT = 2;
constexpr int AF32_RL_TOKENS = 4;
constexpr int AF32_RL_STAMP = 5;
constexpr int AI32_WIDTH = 21;
constexpr int AI32_DID = 0;
constexpr int AI32_SESSION = 1;
constexpr int AI32_FLAGS = 2;
constexpr int SI32_WIDTH = 5;
constexpr int SI32_MAX_PARTICIPANTS = 1;
constexpr int SI32_NPART = 2;
constexpr int SI32_STATE = 3;
constexpr int SF32_WIDTH = 4;
constexpr int SF32_MIN_SIGMA = 0;
constexpr int SF32_TERMINATED_AT = 2;
constexpr int FLAG_ACTIVE = 1;

// Session states and status codes (models.SessionState, ops.admission,
// ops.saga_ops).
constexpr int S_HANDSHAKING = 1;
constexpr int S_ACTIVE = 2;
constexpr int ADMIT_OK = 0;
constexpr int ADMIT_BAD_STATE = 1;
constexpr int ADMIT_DUPLICATE = 2;
constexpr int ADMIT_CAPACITY = 3;
constexpr int ADMIT_SIGMA_LOW = 4;
constexpr int STEP_COMMITTED = 2;
constexpr int STEP_FAILED = 6;

struct AdmissionArgs {
  float* af32; int* ai32; int8_t* aring; int* si32; const float* sf32;
  const int* slot; const int* did; const int* sess; const float* sigma_raw;
  const float* contrib;  // null: no contribution, sigma_eff = sigma_raw
  const uint8_t* trust; const uint8_t* dup;
  float omega, now, ring2_threshold;
  float bursts[4];
  int B;
  int8_t* status; int8_t* ring; float* sigma_eff;
  // Scratch of the two-pass form: [B] the lane's session if it passed
  // every check but capacity, else -1; [2B] the participant counts and
  // maxima, read before any write.
  int* key;
  int* seats;
  // The tenant form: B = T * lanes_t lanes over T stacked tables of
  // agents_t agent and sessions_t session rows each; lane i belongs to
  // tenant i / lanes_t, and its key is the flat session row.
  int lanes_t, agents_t, sessions_t;
};

constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
// B4's block sizes, the fastest of 32-256 on the H100 (PERF.md): small
// blocks spread the one-launch form's 10,000 lanes over more SMs; the
// ranked pass's tile is its block.
constexpr int ADMIT_UNIQUE_THREADS = 64;
constexpr int ADMIT_RANKED_THREADS = 256;
constexpr int RANK_LOADS = 16;

// B4 replaces hypervisor_tpu/kernels/wave_pallas.py admission_block_pallas:
// the session-row gathers, sigma_eff (min(sigma + omega * c, 1), or
// sigma itself when no contribution rides: the join queue's wave), the
// ring, the status ladder, the capacity rank, the packed agent-row
// writes (every column, so the breach window resets) and the
// participant counts. Bound by bytes (~30
// bytes of lane inputs, a gathered session row and a 117-byte row
// written at a random slot a lane: 0.5 us at 10,000 lanes), so its time
// is launches and latency. Two forms:
//   unique sessions (the host checked that no two seat-consuming lanes
//     share a session): one launch. Each lane reads its session row once,
//     checks capacity against its own read and writes the count back.
//     No other lane writes that count, and duplicate and pad lanes never
//     read it: their status is settled (bad state, duplicate) before the
//     capacity check, so no status depends on another lane's write.
//   otherwise: two launches, keeping every capacity check on pre-wave
//     counts. admission_lanes settles each lane up to the capacity check
//     and snapshots the seats; admission_ranked gives each lane its rank,
//     the number of earlier lanes (in lane order) that passed every other
//     check and target its session. A block takes a tile of lanes, puts
//     its sessions in a shared-memory hash table, counts every earlier
//     tile's requests into it (B / blockDim keys a thread) and adds the
//     earlier requests of its own tile.
// Each admitted lane writes its own row, the f32 row as two 16-byte
// stores. (A warp writing its admitted rows together, one row a step,
// measured slower: PERF.md.)
__device__ __forceinline__ int lane_ladder(const AdmissionArgs& a, int i, int s, int8_t* ring_out,
                                           float* se_out) {
  const int state = a.si32[(size_t)s * SI32_WIDTH + SI32_STATE];
  const float min_sigma = a.sf32[(size_t)s * SF32_WIDTH + SF32_MIN_SIGMA];
  float se = a.sigma_raw[i];  // no contribution (contrib null): sigma_raw bit for bit
  if (a.contrib != nullptr) {
    const float x = __fadd_rn(se, __fmul_rn(a.omega, a.contrib[i]));
    se = x > 1.0f ? 1.0f : x;  // NaN passes through, like minimum
  }
  int8_t ring = se > a.ring2_threshold ? 2 : 3;
  if (!a.trust[i]) ring = 3;
  int st = ADMIT_OK;
  if (state != S_HANDSHAKING && state != S_ACTIVE) st = ADMIT_BAD_STATE;
  else if (a.dup[i]) st = ADMIT_DUPLICATE;
  else if (se < min_sigma && ring != 3) st = ADMIT_SIGMA_LOW;
  *ring_out = ring;
  *se_out = se;
  return st;
}

__device__ __forceinline__ float burst(const AdmissionArgs& a, int ring) {
  return a.bursts[ring < 0 ? 0 : (ring > 3 ? 3 : ring)];
}

// An admitted lane writes its agent row r: the f32 row as two 16-byte
// stores, the i32 row (session s, the tenant's own slot) and the ring
// byte.
__device__ __forceinline__ void write_row(const AdmissionArgs& a, int i, size_t r, int s,
                                          int8_t ring, float se) {
  static_assert(AF32_WIDTH == 8 && AF32_SIGMA_RAW == 0 && AF32_SIGMA_EFF == 1 &&
                AF32_JOINED_AT == 2 && AF32_RL_TOKENS == 4 && AF32_RL_STAMP == 5,
                "the two 16-byte stores below spell the f32 row");
  float4* f = reinterpret_cast<float4*>(a.af32 + r * AF32_WIDTH);
  f[0] = make_float4(a.sigma_raw[i], se, a.now, 0.0f);
  f[1] = make_float4(burst(a, ring), a.now, 0.0f, 0.0f);
  int* w = a.ai32 + r * AI32_WIDTH;
  const int did = a.did[i];
#pragma unroll
  for (int c = 0; c < AI32_WIDTH; ++c) {
    w[c] = c == AI32_DID ? did : c == AI32_SESSION ? s : c == AI32_FLAGS ? FLAG_ACTIVE : 0;
  }
  a.aring[r] = ring;
}

__global__ void __launch_bounds__(ADMIT_UNIQUE_THREADS) admission_unique(AdmissionArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.B) return;
  const int s = a.sess[i];
  int8_t ring;
  float se;
  int st = lane_ladder(a, i, s, &ring, &se);
  if (st == ADMIT_OK) {
    int* row = a.si32 + (size_t)s * SI32_WIDTH;
    const int seats = row[SI32_NPART];
    if (seats >= row[SI32_MAX_PARTICIPANTS]) st = ADMIT_CAPACITY;
    else row[SI32_NPART] = seats + 1;
  }
  a.status[i] = static_cast<int8_t>(st);
  a.ring[i] = ring;
  a.sigma_eff[i] = se;
  if (st == ADMIT_OK) write_row(a, i, static_cast<size_t>(a.slot[i]), s, ring, se);
}

// Two-pass form, pass 1: every read of the participant counts happens
// here, before pass 2 writes any. A lane's status is final here unless
// pass 2 refuses it for capacity. kTenants: the lane's session row is
// its tenant's, so keys are flat rows and never match across tenants.
template <bool kTenants>
__global__ void admission_lanes(AdmissionArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.B) return;
  int s = a.sess[i];
  if constexpr (kTenants) s += (i / a.lanes_t) * a.sessions_t;
  int8_t ring;
  float se;
  const int st = lane_ladder(a, i, s, &ring, &se);
  const int* row = a.si32 + (size_t)s * SI32_WIDTH;
  a.status[i] = static_cast<int8_t>(st);
  a.key[i] = st == ADMIT_OK ? s : -1;
  a.seats[i] = row[SI32_NPART];
  a.seats[a.B + i] = row[SI32_MAX_PARTICIPANTS];
  a.ring[i] = ring;
  a.sigma_eff[i] = se;
}

__device__ __forceinline__ unsigned rank_hash(int key) {
  return (static_cast<unsigned>(key) * 2654435761u) >> 20;
}

// Two-pass form, pass 2: the capacity rank, the row writes and an atomic
// participant-count increment for each admitted lane. The hash table has
// twice as many slots as the tile has lanes. A thread reads B / n keys of
// earlier tiles, so the pass's loads grow as B^2 / n: 39 a thread at
// 10,000 lanes. kTenants: lane i writes row slot[i] of its tenant's
// agents, with the tenant's own session slot.
template <bool kTenants>
__global__ void __launch_bounds__(ADMIT_RANKED_THREADS) admission_ranked(AdmissionArgs a) {
  constexpr int n = ADMIT_RANKED_THREADS;
  constexpr unsigned mask = 2 * n - 1;
  __shared__ __align__(16) int tile_key[n];
  __shared__ int hash_key[2 * n];
  __shared__ int hash_count[2 * n];
  const int t = threadIdx.x;
  const int i0 = blockIdx.x * n, i = i0 + t;
  const int key = i < a.B ? a.key[i] : -1;
  tile_key[t] = key;
  for (int h = t; h < 2 * n; h += n) {
    hash_key[h] = -1;
    hash_count[h] = 0;
  }
  __syncthreads();
  unsigned slot = 0;
  if (key >= 0) {  // the tile's sessions, one slot each
    slot = rank_hash(key) & mask;
    for (int prev; (prev = atomicCAS(&hash_key[slot], -1, key)) != -1 && prev != key;) {
      slot = (slot + 1) & mask;
    }
  }
  __syncthreads();
  // Every earlier tile's requests, counted per session of this tile;
  // RANK_LOADS keys a thread in flight at once.
  for (int j0 = t; j0 < i0; j0 += RANK_LOADS * n) {
    int kj[RANK_LOADS];
#pragma unroll
    for (int u = 0; u < RANK_LOADS; ++u) {
      const int j = j0 + u * n;
      kj[u] = j < i0 ? a.key[j] : -1;
    }
#pragma unroll
    for (int u = 0; u < RANK_LOADS; ++u) {
      if (kj[u] < 0) continue;
      unsigned h = rank_hash(kj[u]) & mask;
      int found;
      while ((found = hash_key[h]) != kj[u] && found != -1) h = (h + 1) & mask;
      if (found == kj[u]) atomicAdd(&hash_count[h], 1);
    }
  }
  __syncthreads();
  if (key >= 0) {
    int rank = hash_count[slot];  // then the earlier requests of this tile, four a load
    const int4* quad = reinterpret_cast<const int4*>(tile_key);
    int q = 0;
    for (; q + 4 <= t; q += 4) {
      const int4 k4 = quad[q >> 2];
      rank += (k4.x == key) + (k4.y == key) + (k4.z == key) + (k4.w == key);
    }
    for (; q < t; ++q) rank += tile_key[q] == key;
    if (a.seats[i] + rank < a.seats[a.B + i]) {
      atomicAdd(a.si32 + (size_t)key * SI32_WIDTH + SI32_NPART, 1);
      size_t r = static_cast<size_t>(a.slot[i]);
      int s = key;
      if constexpr (kTenants) {
        const int tn = i / a.lanes_t;
        r += static_cast<size_t>(tn) * a.agents_t;
        s -= tn * a.sessions_t;
      }
      write_row(a, i, r, s, a.ring[i], a.sigma_eff[i]);
    } else {
      a.status[i] = ADMIT_CAPACITY;
    }
  }
}

struct FsmSagaArgs {
  int* ai32; int* si32; float* sf32; const int* vsess; uint8_t* vact;
  const int* ksess; const uint8_t* ok;
  float now; int lo, hi; int use_mask, s_cap;
  uint32_t bits_lo, bits_hi; int n_rows, n_cols;
  int active, terminating, archived;
  int K, B, E, N;
  int walk_blocks, step_blocks, edge_blocks;
  int8_t* step; int8_t* wstate; uint8_t* err; int* released;
  // The tenant form: T tenants, each with K, B, E and N above and s_cap
  // session rows, its wave the range [lo_t[t], hi_t[t]); released [T].
  int T; const int* lo_t; const int* hi_t;
};

constexpr int FSM_THREADS = 512;
constexpr int FSM_EDGES_PER_THREAD = 4;
constexpr int FSM_MASK_LOADS = 8;

__device__ __forceinline__ bool transition_valid(const FsmSagaArgs& a, int frm, int to) {
  if (frm < 0 || frm >= a.n_rows || to < 0 || to >= a.n_cols) return false;
  const uint32_t idx = static_cast<uint32_t>(frm * a.n_cols + to);
  const uint32_t word = idx < 32 ? a.bits_lo : a.bits_hi;
  return (word >> (idx & 31u)) & 1u;
}

// Adds session ks (a negative one marks slot 0) to the bitmap: into the
// pending (word, bits) when it shares that word, else flushing them first.
__device__ __forceinline__ void mark(unsigned* member, int s_cap, int ks, unsigned& word,
                                     unsigned& bits) {
  const int s = ks < 0 ? 0 : ks;
  if (s >= s_cap) return;
  const unsigned w = static_cast<unsigned>(s) >> 5, b = 1u << (s & 31);
  if (bits && w != word) atomicOr(&member[word], bits);
  bits = (bits && w == word ? bits : 0u) | b;
  word = w;
}

__device__ __forceinline__ bool in_wave(const FsmSagaArgs& a, const unsigned* member, int s) {
  if (!a.use_mask) return s >= a.lo && s < a.hi;
  return s >= 0 && s < a.s_cap && ((member[s >> 5] >> (s & 31)) & 1u);
}

// B5 replaces hypervisor_tpu/kernels/wave_pallas.py fsm_saga_block_pallas:
//   walk:  the session walk ACTIVE -> TERMINATING -> ARCHIVED on
//          populated sessions (legality from the packed transition bits,
//          the state narrowed to int8 as in the reference), the state and
//          terminated_at writes;
//   step:  one saga step a lane, COMMITTED where admitted, else FAILED;
//   edges: bond release on live edges of the wave's sessions, counted
//          with one atomic a warp;
//   agents: FLAG_ACTIVE cleared on agents of the wave's sessions.
// Bound by bytes (it streams the edges and the agents' session column
// once: 0.2 us at the wave's size), so its time is one launch and the
// latency of its longest chain. One launch; each block takes one role,
// so the walk's dependent gathers (k_sessions, then the session row,
// then the writes) run beside the edge and agent streams instead of
// ahead of them in the same thread. It runs after admission on the same
// stream, so the walk reads the counts admission wrote.
// Membership: the range [lo, hi) when the host has checked that
// k_sessions is arange(lo, hi); otherwise (use_mask) each edge and agent
// block first builds the wave's sessions as a bitmap of the session table
// in shared memory (s_cap bits) with atomicOr, so any layout runs in the
// same single launch with no scratch. A negative k_sessions entry marks
// slot 0, as the reference's unarmed path clips it (the facade never
// passes one), and the walk indexes it from the table's end, as torch
// and the reference index.
// The tenant form (kTenants) runs T tenants' waves in one launch: the grid
// gains a y dimension, one row of blocks a tenant, each block offsetting
// every pointer by its tenant's table, lanes and edges and taking the
// tenant's range [lo_t[t], hi_t[t]) (a tenant wave's sessions are one
// block, so there is no mask form); released is per tenant, [T].
template <bool kTenants>
__global__ void __launch_bounds__(FSM_THREADS) fsm_saga_kernel(FsmSagaArgs a) {
  extern __shared__ unsigned member[];
  if constexpr (kTenants) {
    const int tn = blockIdx.y;
    a.ai32 += static_cast<size_t>(tn) * a.N * AI32_WIDTH;
    a.si32 += static_cast<size_t>(tn) * a.s_cap * SI32_WIDTH;
    a.sf32 += static_cast<size_t>(tn) * a.s_cap * SF32_WIDTH;
    a.vsess += static_cast<size_t>(tn) * a.E;
    a.vact += static_cast<size_t>(tn) * a.E;
    a.ksess += static_cast<size_t>(tn) * a.K;
    a.wstate += static_cast<size_t>(tn) * a.K;
    a.err += static_cast<size_t>(tn) * a.K;
    a.ok += static_cast<size_t>(tn) * a.B;
    a.step += static_cast<size_t>(tn) * a.B;
    a.released += tn;
    a.lo = a.lo_t[tn];
    a.hi = a.hi_t[tn];
  }
  int blk = blockIdx.x;
  if (blk < a.walk_blocks) {
    const int idx = blk * blockDim.x + threadIdx.x;
    if (idx >= a.K) return;
    const int ks = a.ksess[idx];
    const size_t s = static_cast<size_t>(ks < 0 ? ks + a.s_cap : ks);
    int* row = a.si32 + s * SI32_WIDTH;
    const bool has_members = row[SI32_NPART] > 0;
    int state = static_cast<int8_t>(row[SI32_STATE]);
    bool err = false;
    const int targets[3] = {a.active, a.terminating, a.archived};
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const bool ok = transition_valid(a, state, targets[t]);
      if (has_members && ok) state = static_cast<int8_t>(targets[t]);
      err |= has_members && !ok;
    }
    row[SI32_STATE] = state;
    if (has_members) a.sf32[s * SF32_WIDTH + SF32_TERMINATED_AT] = a.now;
    a.wstate[idx] = static_cast<int8_t>(state);
    a.err[idx] = err;
    return;
  }
  blk -= a.walk_blocks;
  if (blk < a.step_blocks) {
    const int b = blk * blockDim.x + threadIdx.x;
    if (b < a.B) a.step[b] = a.ok[b] ? STEP_COMMITTED : STEP_FAILED;
    return;
  }
  blk -= a.step_blocks;
  // This block's edge or agent loads go out before the membership build,
  // so their latency overlaps it.
  const bool edge_role = blk < a.edge_blocks;  // block-uniform
  const int e0 = blk * blockDim.x * FSM_EDGES_PER_THREAD + threadIdx.x;
  uint8_t act[FSM_EDGES_PER_THREAD];
  int vs[FSM_EDGES_PER_THREAD];
  int* agent_row = nullptr;
  int agent_session = -1;
  if (edge_role) {
#pragma unroll
    for (int q = 0; q < FSM_EDGES_PER_THREAD; ++q) {
      const int e = e0 + q * blockDim.x;
      act[q] = e < a.E ? a.vact[e] : 0;
      vs[q] = e < a.E ? a.vsess[e] : -1;
    }
  } else {
    const int n = (blk - a.edge_blocks) * blockDim.x + threadIdx.x;
    if (n < a.N) {
      agent_row = a.ai32 + static_cast<size_t>(n) * AI32_WIDTH;
      agent_session = agent_row[AI32_SESSION];
    }
  }
  if (a.use_mask) {  // block-uniform
    const int words = (a.s_cap + 31) >> 5;
    for (int w = threadIdx.x; w < words; w += blockDim.x) member[w] = 0u;
    __syncthreads();
    // Every block reads all K sessions, so the loads go as 16-byte
    // vectors, FSM_MASK_LOADS of them a thread in flight at once; each
    // thread ORs the bits of its neighbouring sessions that share a word
    // before the shared atomic. An unaligned head and the tail (at most
    // three sessions each) go one by one.
    const int head = min(a.K, static_cast<int>(
        ((16 - (reinterpret_cast<uintptr_t>(a.ksess) & 15)) & 15) >> 2));
    const int n4 = (a.K - head) >> 2;
    const int4* body = reinterpret_cast<const int4*>(a.ksess + head);
    for (int base = 0; base < n4; base += FSM_MASK_LOADS * blockDim.x) {  // block-uniform
      int4 v[FSM_MASK_LOADS];
#pragma unroll
      for (int u = 0; u < FSM_MASK_LOADS; ++u) {
        const int q = base + u * blockDim.x + threadIdx.x;
        v[u] = q < n4 ? body[q] : make_int4(a.s_cap, a.s_cap, a.s_cap, a.s_cap);  // marks nothing
      }
#pragma unroll
      for (int u = 0; u < FSM_MASK_LOADS; ++u) {
        unsigned word = 0, bits = 0;
        mark(member, a.s_cap, v[u].x, word, bits);
        mark(member, a.s_cap, v[u].y, word, bits);
        mark(member, a.s_cap, v[u].z, word, bits);
        mark(member, a.s_cap, v[u].w, word, bits);
        if (bits) atomicOr(&member[word], bits);
      }
    }
    const int rest = head + 4 * n4;
    unsigned word = 0, bits = 0;
    const int t = threadIdx.x;
    if (t < head) mark(member, a.s_cap, a.ksess[t], word, bits);
    if (t < a.K - rest) mark(member, a.s_cap, a.ksess[rest + t], word, bits);
    if (bits) atomicOr(&member[word], bits);
    __syncthreads();
  }
  if (edge_role) {
    int hits = 0;
#pragma unroll
    for (int q = 0; q < FSM_EDGES_PER_THREAD; ++q) {
      if (act[q] && in_wave(a, member, vs[q])) {
        a.vact[e0 + q * blockDim.x] = 0;
        ++hits;
      }
    }
    hits = __reduce_add_sync(FULL_MASK, hits);  // every lane reaches this
    if ((threadIdx.x & 31) == 0 && hits) atomicAdd(a.released, hits);
  } else if (agent_row != nullptr && in_wave(a, member, agent_session)) {
    agent_row[AI32_FLAGS] &= ~FLAG_ACTIVE;
  }
}

// The vouched contribution toward each agent slot. Replaces the XLA
// scatter-add of hypervisor_tpu/ops/liability.py:93 contribution_toward
// (`.at[vee].add`, which the reference sums in edge order): slot k gets
// the bonds of the live scoped edges whose vouchee is k, added in f32 in
// edge order. f32 addition is not associative, so each vouchee's fold
// stays one sequential chain; what the H100 can do in parallel is
// everything around it. Bound by bytes (about 17 an edge and 8 a slot:
// 0.37 us at 65,536 edges at an H100 SXM's 3.35 TB/s, 700 W), so the
// cost is launches and latency, not traffic. Five launches, no sort of
// the whole table and no host sync:
//   scope: one thread an edge runs the scoped test (active, now <= expiry
//          with `now` read on the device, vouchee >= 0, session ==
//          target[vouchee]) and takes a place in its vouchee's bucket
//          with an integer atomic (exact in any order);
//   scan:  one block turns the counts into bucket offsets (N <= 32,768
//          on the paths; any N works) and lists the buckets of more
//          than CONTRIB_SMALL edges;
//   fill:  each scoped edge writes its index into its bucket place, in
//          no fixed order within the bucket;
//   fold:  one thread a slot walks its bucket (at most CONTRIB_SMALL
//          edges; one on the wave) in increasing edge index, by repeated
//          minimum, adding with __fadd_rn from +0.0f; an empty bucket
//          writes +0.0f, so an edge that adds nothing never reaches the
//          output;
//   large: a fixed grid of blocks takes the listed buckets, sorts each
//          (bitonic, in shared memory up to CONTRIB_SMEM edges, in place
//          in the bucket beyond), and one thread folds it in that order.
// Edge indices are unique, so any sort gives edge order, and the sums
// equal the reference's bit for bit.
// The tenant form (kTenants) runs T tenants' tables stacked [T, E] and
// [T, N] as one table of T*E edges and T*N slots: edge e's vouchee is
// slot vouchee[e] of tenant e / E_t, so its key is that plus the
// tenant's N_t offset. Flat edge order is each tenant's edge order, so
// every fold is its tenant's; the five launches serve all T.
constexpr int CONTRIB_THREADS = 256;
constexpr int CONTRIB_SMALL = 32;
constexpr int CONTRIB_BLOCK = 1024;
constexpr int CONTRIB_SCAN_ITEMS = 16;
constexpr int CONTRIB_SMEM = 8192;
constexpr int CONTRIB_LARGE_BLOCKS = 16;

template <bool kTenants>
__global__ void contrib_scope_kernel(const int* __restrict__ vouchee,   // [E]
                                     const int* __restrict__ session,   // [E]
                                     const uint8_t* __restrict__ active,  // [E] bool
                                     const float* __restrict__ expiry,  // [E]
                                     const int* __restrict__ target,    // [N]
                                     const float* __restrict__ now,     // []
                                     int* __restrict__ count,           // [N], zeroed
                                     int* __restrict__ place,           // [E] out: -1 unscoped
                                     int E, int E_t, int N_t) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const int vee = vouchee[e];
  int key = vee;
  if constexpr (kTenants) key += (e / E_t) * N_t;
  int p = -1;
  if (active[e] && __ldg(now) <= expiry[e] && vee >= 0 && session[e] == target[key]) {
    p = atomicAdd(&count[key], 1);
  }
  place[e] = p;
}

// One block scans the counts in tiles of CONTRIB_BLOCK x CONTRIB_SCAN_ITEMS
// (one tile at N = 16,384). Warp w owns the tile's w-th run of 32 x
// CONTRIB_SCAN_ITEMS counts and loads it coalesced, 32 neighbours at a
// time, into registers; it scans the run with shuffles, the block scans
// the 32 warps' totals, and each warp writes its offsets, coalesced. A
// single SM moves the whole array, so the access pattern, not the
// arithmetic, sets the time.
__global__ void __launch_bounds__(CONTRIB_BLOCK) contrib_scan_kernel(
    const int* __restrict__ count,  // [N]
    int* __restrict__ offset,       // [N] out: exclusive prefix sum of count
    int* __restrict__ large,        // [1 + N] out: how many, then the large buckets' slots
    int N) {
  __shared__ int warp_sum[CONTRIB_BLOCK / 32];
  __shared__ int n_large;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) n_large = 0;
  int carry = 0;
  for (int base = 0; base < N; base += CONTRIB_BLOCK * CONTRIB_SCAN_ITEMS) {  // block-uniform
    const int run_base = base + warp * 32 * CONTRIB_SCAN_ITEMS + lane;
    int v[CONTRIB_SCAN_ITEMS], inc[CONTRIB_SCAN_ITEMS];
#pragma unroll
    for (int i = 0; i < CONTRIB_SCAN_ITEMS; ++i) {
      const int k = run_base + 32 * i;
      v[i] = k < N ? count[k] : 0;
    }
    int total = 0;  // the warp's run so far, the same on every lane
#pragma unroll
    for (int i = 0; i < CONTRIB_SCAN_ITEMS; ++i) {
      int x = v[i];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
        if (lane >= d) x += y;
      }
      inc[i] = total + x;
      total += __shfl_sync(0xFFFFFFFFu, x, 31);
    }
    if (lane == 0) warp_sum[warp] = total;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, w, d);
        if (lane >= d) w += y;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    const int pre = carry + (warp > 0 ? warp_sum[warp - 1] : 0);
#pragma unroll
    for (int i = 0; i < CONTRIB_SCAN_ITEMS; ++i) {
      const int k = run_base + 32 * i;
      if (k < N) {
        offset[k] = pre + inc[i] - v[i];
        if (v[i] > CONTRIB_SMALL) large[1 + atomicAdd(&n_large, 1)] = k;
      }
    }
    carry += warp_sum[CONTRIB_BLOCK / 32 - 1];
    __syncthreads();  // every thread has read warp_sum before the next tile writes it
  }
  if (threadIdx.x == 0) large[0] = n_large;
}

template <bool kTenants>
__global__ void contrib_fill_kernel(const int* __restrict__ vouchee,  // [E]
                                    const int* __restrict__ place,    // [E]
                                    const int* __restrict__ offset,   // [N]
                                    int* __restrict__ bucket,         // [E]
                                    int E, int E_t, int N_t) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const int p = place[e];
  int key = vouchee[e];
  if constexpr (kTenants) key += (e / E_t) * N_t;
  if (p >= 0) bucket[offset[key] + p] = e;
}

__global__ void contrib_fold_kernel(const int* __restrict__ count,   // [N]
                                    const int* __restrict__ offset,  // [N]
                                    const int* __restrict__ bucket,  // [E]
                                    const float* __restrict__ bond,  // [E]
                                    float* __restrict__ out,         // [N]
                                    int N) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= N) return;
  const int c = count[k];
  if (c > CONTRIB_SMALL) return;  // contrib_large_kernel folds it
  const int* b = bucket + (c > 0 ? offset[k] : 0);
  float acc = 0.0f;
  int prev = -1;
  for (int i = 0; i < c; ++i) {  // the next edge in edge order: the least index above prev
    int next = 0x7FFFFFFF;
    for (int q = 0; q < c; ++q) {
      const int e = b[q];
      if (e > prev && e < next) next = e;
    }
    acc = __fadd_rn(acc, bond[next]);
    prev = next;
  }
  out[k] = acc;
}

// Sorts a[0..n) ascending with the whole block: a bitonic network in the
// form whose comparators all put the smaller value first (each merge
// opens by comparing i with its mirror in the block), over the next
// power of two. Places at n and beyond count as +inf, which never move,
// so their comparisons are skipped. `a` may be shared or global memory;
// __syncthreads orders both within the block.
__device__ void block_bitonic_sort(int* a, int n) {
  int size = 1;
  while (size < n) size <<= 1;
  for (int k = 2; k <= size; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < size / 2; t += blockDim.x) {
        const int i = (t / j) * 2 * j + (t % j);
        const int p = j == (k >> 1) ? (i ^ (k - 1)) : i + j;
        if (p < n) {
          const int x = a[i], y = a[p];
          if (x > y) { a[i] = y; a[p] = x; }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(CONTRIB_BLOCK) contrib_large_kernel(
    const int* __restrict__ count,   // [N]
    const int* __restrict__ offset,  // [N]
    int* __restrict__ bucket,        // [E], sorted in place beyond CONTRIB_SMEM
    const int* __restrict__ large,   // [1 + N]
    const float* __restrict__ bond,  // [E]
    float* __restrict__ out) {       // [N]
  __shared__ int keys[CONTRIB_SMEM];
  __shared__ float vals[CONTRIB_BLOCK];
  const int n_large = large[0];
  for (int i = blockIdx.x; i < n_large; i += gridDim.x) {  // block-uniform
    const int k = large[1 + i], c = count[k];
    int* b = bucket + offset[k];
    int* a = b;
    if (c <= CONTRIB_SMEM) {
      for (int q = threadIdx.x; q < c; q += blockDim.x) keys[q] = b[q];
      a = keys;
      __syncthreads();
    }
    block_bitonic_sort(a, c);
    float acc = 0.0f;  // thread 0's
    for (int base = 0; base < c; base += blockDim.x) {
      const int q = base + threadIdx.x;
      if (q < c) vals[threadIdx.x] = bond[a[q]];
      __syncthreads();
      if (threadIdx.x == 0) {
        const int m = min(static_cast<int>(blockDim.x), c - base);
        for (int u = 0; u < m; ++u) acc = __fadd_rn(acc, vals[u]);
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) out[k] = acc;
  }
}

}  // namespace

extern "C" const char* hv_wave_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace {

// The arguments both forms of B4 share; the tenant form adds its strides.
AdmissionArgs admission_args(
    void* af32, void* ai32, void* aring, void* si32, const void* sf32,
    const void* slot, const void* did, const void* sess, const void* sigma_raw,
    const void* contrib, const void* trust, const void* dup,
    float omega, float now, float ring2_threshold,
    float burst0, float burst1, float burst2, float burst3, int B,
    void* status, void* ring, void* sigma_eff, void* key, void* seats) {
  AdmissionArgs a{};
  a.af32 = static_cast<float*>(af32); a.ai32 = static_cast<int*>(ai32);
  a.aring = static_cast<int8_t*>(aring); a.si32 = static_cast<int*>(si32);
  a.sf32 = static_cast<const float*>(sf32); a.slot = static_cast<const int*>(slot);
  a.did = static_cast<const int*>(did); a.sess = static_cast<const int*>(sess);
  a.sigma_raw = static_cast<const float*>(sigma_raw);
  a.contrib = static_cast<const float*>(contrib);
  a.trust = static_cast<const uint8_t*>(trust); a.dup = static_cast<const uint8_t*>(dup);
  a.omega = omega; a.now = now; a.ring2_threshold = ring2_threshold;
  a.bursts[0] = burst0; a.bursts[1] = burst1; a.bursts[2] = burst2; a.bursts[3] = burst3;
  a.B = B;
  a.status = static_cast<int8_t*>(status); a.ring = static_cast<int8_t*>(ring);
  a.sigma_eff = static_cast<float*>(sigma_eff);
  a.key = static_cast<int*>(key); a.seats = static_cast<int*>(seats);
  return a;
}

// B4's two-pass (ranked) form: two launches over the B lanes.
template <bool kTenants>
void launch_admission_ranked(const AdmissionArgs& a, cudaStream_t st) {
  const int blocks = (a.B + ADMIT_RANKED_THREADS - 1) / ADMIT_RANKED_THREADS;
  admission_lanes<kTenants><<<blocks, ADMIT_RANKED_THREADS, 0, st>>>(a);
  admission_ranked<kTenants><<<blocks, ADMIT_RANKED_THREADS, 0, st>>>(a);
}

// The arguments both forms of B5 share, and its grid: the blocks of one
// wave (a tenant's, in the tenant form), walk, step, edge and agent.
FsmSagaArgs fsm_saga_args(
    void* ai32, void* si32, void* sf32, const void* vsess, void* vact,
    const void* ksess, const void* ok, float now, int s_cap,
    unsigned int bits_lo, unsigned int bits_hi, int n_rows, int n_cols,
    int active, int terminating, int archived, int K, int B, int E, int N,
    void* step, void* wstate, void* err, void* released, int* blocks) {
  FsmSagaArgs a{};
  a.ai32 = static_cast<int*>(ai32); a.si32 = static_cast<int*>(si32);
  a.sf32 = static_cast<float*>(sf32); a.vsess = static_cast<const int*>(vsess);
  a.vact = static_cast<uint8_t*>(vact); a.ksess = static_cast<const int*>(ksess);
  a.ok = static_cast<const uint8_t*>(ok);
  a.now = now; a.s_cap = s_cap;
  a.bits_lo = bits_lo; a.bits_hi = bits_hi; a.n_rows = n_rows; a.n_cols = n_cols;
  a.active = active; a.terminating = terminating; a.archived = archived;
  a.K = K; a.B = B; a.E = E; a.N = N;
  a.step = static_cast<int8_t*>(step); a.wstate = static_cast<int8_t*>(wstate);
  a.err = static_cast<uint8_t*>(err); a.released = static_cast<int*>(released);
  a.walk_blocks = (K + FSM_THREADS - 1) / FSM_THREADS;
  a.step_blocks = (B + FSM_THREADS - 1) / FSM_THREADS;
  const int edges_per_block = FSM_THREADS * FSM_EDGES_PER_THREAD;
  a.edge_blocks = (E + edges_per_block - 1) / edges_per_block;
  const int agent_blocks = (N + FSM_THREADS - 1) / FSM_THREADS;
  *blocks = a.walk_blocks + a.step_blocks + a.edge_blocks + agent_blocks;
  return a;
}

}  // namespace

extern "C" int hv_admission_block(
    void* af32, void* ai32, void* aring, void* si32, const void* sf32,
    const void* slot, const void* did, const void* sess, const void* sigma_raw,
    const void* contrib, const void* trust, const void* dup,
    float omega, float now, float ring2_threshold,
    float burst0, float burst1, float burst2, float burst3,
    int unique, int B,
    void* status, void* ring, void* sigma_eff, void* key, void* seats, void* stream) {
  if (B > 0) {
    const AdmissionArgs a = admission_args(
        af32, ai32, aring, si32, sf32, slot, did, sess, sigma_raw, contrib, trust, dup,
        omega, now, ring2_threshold, burst0, burst1, burst2, burst3, B,
        status, ring, sigma_eff, key, seats);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (unique) {
      const int blocks = (B + ADMIT_UNIQUE_THREADS - 1) / ADMIT_UNIQUE_THREADS;
      admission_unique<<<blocks, ADMIT_UNIQUE_THREADS, 0, st>>>(a);
    } else {
      launch_admission_ranked<false>(a, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The tenant form of B4: T tenants' waves of B_t lanes each over agent
// and session tables stacked [T, N_t] and [T, S_t], always the two-pass
// (ranked) form.
extern "C" int hv_admission_block_tenants(
    void* af32, void* ai32, void* aring, void* si32, const void* sf32,
    const void* slot, const void* did, const void* sess, const void* sigma_raw,
    const void* contrib, const void* trust, const void* dup,
    float omega, float now, float ring2_threshold,
    float burst0, float burst1, float burst2, float burst3,
    int T, int B_t, int N_t, int S_t,
    void* status, void* ring, void* sigma_eff, void* key, void* seats, void* stream) {
  const int B = T * B_t;
  if (B > 0) {
    AdmissionArgs a = admission_args(
        af32, ai32, aring, si32, sf32, slot, did, sess, sigma_raw, contrib, trust, dup,
        omega, now, ring2_threshold, burst0, burst1, burst2, burst3, B,
        status, ring, sigma_eff, key, seats);
    a.lanes_t = B_t; a.agents_t = N_t; a.sessions_t = S_t;
    launch_admission_ranked<true>(a, static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hv_fsm_saga_block(
    void* ai32, void* si32, void* sf32, const void* vsess, void* vact,
    const void* ksess, const void* ok,
    float now, int lo, int hi, int use_mask, int s_cap,
    unsigned int bits_lo, unsigned int bits_hi, int n_rows, int n_cols,
    int active, int terminating, int archived,
    int K, int B, int E, int N,
    void* step, void* wstate, void* err, void* released, void* stream) {
  int blocks = 0;
  FsmSagaArgs a = fsm_saga_args(
      ai32, si32, sf32, vsess, vact, ksess, ok, now, s_cap, bits_lo, bits_hi, n_rows, n_cols,
      active, terminating, archived, K, B, E, N, step, wstate, err, released, &blocks);
  a.lo = lo; a.hi = hi; a.use_mask = use_mask;
  const size_t smem = use_mask ? ((static_cast<size_t>(s_cap) + 31) / 32) * 4 : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fsm_saga_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (blocks > 0) {
    fsm_saga_kernel<false><<<blocks, FSM_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tenant form of B5: T tenants, each with K sessions, B lanes, E
// edges, N agents and S session rows, its wave the range [lo[t], hi[t]).
// released is i32[T], zeroed by the caller.
extern "C" int hv_fsm_saga_block_tenants(
    void* ai32, void* si32, void* sf32, const void* vsess, void* vact,
    const void* ksess, const void* ok, const void* lo, const void* hi,
    float now, unsigned int bits_lo, unsigned int bits_hi, int n_rows, int n_cols,
    int active, int terminating, int archived,
    int T, int K, int B, int E, int N, int S,
    void* step, void* wstate, void* err, void* released, void* stream) {
  int blocks = 0;
  FsmSagaArgs a = fsm_saga_args(
      ai32, si32, sf32, vsess, vact, ksess, ok, now, S, bits_lo, bits_hi, n_rows, n_cols,
      active, terminating, archived, K, B, E, N, step, wstate, err, released, &blocks);
  a.T = T; a.lo_t = static_cast<const int*>(lo); a.hi_t = static_cast<const int*>(hi);
  if (blocks > 0 && T > 0) {
    fsm_saga_kernel<true><<<dim3(blocks, T), FSM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// scratch: int32 [N] count, which must arrive zeroed, then [N] offset,
// [1 + N] large, [E] place and [E] bucket, which need no initial value.
// out needs no zeroing either: every slot is written.
namespace {

cudaError_t launch_contribution(bool tenants, const void* vouchee, const void* session,
                                const void* active, const void* expiry, const void* bond,
                                const void* target, const void* now, void* scratch, void* out,
                                int E, int N, int E_t, int N_t, cudaStream_t st) {
  if (N > 0) {
    int* count = static_cast<int*>(scratch);
    int* offset = count + N;
    int* large = offset + N;
    int* place = large + 1 + N;
    int* bucket = place + E;
    const int* vee = static_cast<const int*>(vouchee);
    const float* b = static_cast<const float*>(bond);
    float* o = static_cast<float*>(out);
    const int edge_blocks = (E + CONTRIB_THREADS - 1) / CONTRIB_THREADS;
    auto scope = tenants ? contrib_scope_kernel<true> : contrib_scope_kernel<false>;
    auto fill = tenants ? contrib_fill_kernel<true> : contrib_fill_kernel<false>;
    if (E > 0) {
      scope<<<edge_blocks, CONTRIB_THREADS, 0, st>>>(
          vee, static_cast<const int*>(session), static_cast<const uint8_t*>(active),
          static_cast<const float*>(expiry), static_cast<const int*>(target),
          static_cast<const float*>(now), count, place, E, E_t, N_t);
    }
    contrib_scan_kernel<<<1, CONTRIB_BLOCK, 0, st>>>(count, offset, large, N);
    if (E > 0) {
      fill<<<edge_blocks, CONTRIB_THREADS, 0, st>>>(vee, place, offset, bucket, E, E_t, N_t);
    }
    contrib_fold_kernel<<<(N + CONTRIB_THREADS - 1) / CONTRIB_THREADS, CONTRIB_THREADS, 0, st>>>(
        count, offset, bucket, b, o, N);
    contrib_large_kernel<<<CONTRIB_LARGE_BLOCKS, CONTRIB_BLOCK, 0, st>>>(
        count, offset, bucket, large, b, o);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int hv_contribution(const void* vouchee, const void* session, const void* active,
                               const void* expiry, const void* bond, const void* target,
                               const void* now, void* scratch, void* out, int E, int N,
                               void* stream) {
  return static_cast<int>(launch_contribution(false, vouchee, session, active, expiry, bond,
                                              target, now, scratch, out, E, N, E, N,
                                              static_cast<cudaStream_t>(stream)));
}

// The tenant form: T tenants' edges [T, E_t] toward their slots [T, N_t],
// the same five launches over T*E_t edges and T*N_t slots (scratch as
// above at E = T*E_t, N = T*N_t).
extern "C" int hv_contribution_tenants(const void* vouchee, const void* session,
                                       const void* active, const void* expiry, const void* bond,
                                       const void* target, const void* now, void* scratch,
                                       void* out, int T, int E_t, int N_t, void* stream) {
  return static_cast<int>(launch_contribution(true, vouchee, session, active, expiry, bond,
                                              target, now, scratch, out, T * E_t, T * N_t, E_t,
                                              N_t, static_cast<cudaStream_t>(stream)));
}
