// Audit-phase kernels for Hopper (sm_90a): the delta chain (B2) and the
// per-session Merkle roots (B3). Plain C entry points, bound with ctypes
// by hypervisor_tpu_torch/kernels/mtu.py; u32 words arrive as the int32
// tensors of the port's u32 convention and are read here as uint32_t.
// Each entry launches on the caller's stream and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256.cuh"

namespace {

constexpr int kChainLanes = 128;    // lanes a block, at most: its chain threads
constexpr int kChainThreads = 512;  // threads a block, all of them computing midstates

// B2. Replaces hypervisor_tpu/kernels/mtu_pallas.py chain_digests_mtu:
// d_t = sha256(body_t || d_{t-1}), d_{-1} = seed, per lane. The TPU's
// sequential grid axis and its VMEM carry become a loop in one thread
// per lane, the parent digest in registers.
//
// A link is two compressions, and only the second depends on the
// parent: the first compresses body_t alone from the initial value. At
// the paths' shapes an SMSP holds about one warp, so the time is the
// lane's serial depth; splitting the link at the block boundary cuts it
// from 2T compressions to about T + 1, and takes the body loads off the
// chain, which reads only shared memory. The entry spreads the lanes
// over every SM, `per_block` = ceil(L / SMs) (76 at 10,000 lanes, 1 for
// the flush's 13) up to kChainLanes, so each SMSP holds at most one
// chain warp. A block walks T in tiles of k = kChainThreads / lanes
// turns (6 at 76 lanes, 512 for one lane). Per tile, every thread
// compresses one (turn, lane) body into a midstate, 8 words into shared
// memory; after a __syncthreads, thread l (< lanes) runs its lane's
// parent blocks in order from those midstates. Two buffers: while the
// chain threads run tile j, the other threads already fill tile j + 1,
// and the chain threads join them after.
//
// The ring form (kRing) also does B6's work. It replaces
// hypervisor_tpu/kernels/wave_pallas.py ring_append_pallas, the DeltaLog
// live-prefix append (DeltaLog.append_batch_prefix), as this kernel's
// epilogue: row i = lane * T + t of the wave's lane-major order, if i <
// n_live, lands at (cursor + i) % C. The thread that fills a tile already
// holds the row's body, and stores its four 16-byte vectors (a whole
// 64-byte row, so every sector is used at any stride); the chain thread
// already holds the digest, and stores it with the row's session
// (wave_sessions[lane]) and turn. Thread 0 of block 0 writes the device
// cursor cursor + n_live, which nothing reads. B6's own launch and its
// second read of bodies and digests are gone; the stores add 104 bytes a
// row to a kernel bound by its serial chain. kRing = false is the plain
// chain, for the flush and the chain checks.
//
// The tenant ring form (kTenants) serves T tenants' waves in the same
// launch: L = T * lanes_t lanes, lane g belonging to tenant g / lanes_t,
// whose records go to its own ring, rows [t * C, (t + 1) * C) of the
// stacked DeltaLog, at its own cursor cursors[t] (the host mirrors) and
// with its own live prefix n_lives[t], in its own lane-major order. The
// chain itself is lane-independent, so only the ring arithmetic changes.
struct RingArgs {
  uint4* body;                // [C, 16] as 4 x uint4 ([T, C, 16] for tenants)
  uint4* digest;              // [C, 8] as 2 x uint4
  int* session;               // [C]
  int* turn;                  // [C]
  int* cursor_out;            // [] ([T] for tenants)
  const int* wave_sessions;   // [L]
  int cursor, n_live, C;
  const int* cursors;         // [T] tenants only
  const int* n_lives;         // [T] tenants only
  int lanes_t, T;             // tenants only
};

// The ring row of live lane-major row i (< n_live <= C) of a ring at
// `cursor`: cursor and i are both below 2^31, so 32-bit unsigned
// arithmetic holds their sum.
__device__ __forceinline__ unsigned ring_row(int cursor, int C, long long i) {
  return (static_cast<unsigned>(cursor) + static_cast<unsigned>(i)) % static_cast<unsigned>(C);
}

// Lane g's ring: its tenant's cursor, live prefix, row base and its lane
// within the tenant (the whole ring and lane g itself without tenants).
struct LaneRing {
  int cursor, n_live, lane;
  size_t base;
};

template <bool kTenants>
__device__ __forceinline__ LaneRing lane_ring(const RingArgs& r, int g) {
  if constexpr (kTenants) {
    const int tn = g / r.lanes_t;
    return LaneRing{r.cursors[tn], r.n_lives[tn], g - tn * r.lanes_t,
                    static_cast<size_t>(tn) * r.C};
  } else {
    return LaneRing{r.cursor, r.n_live, g, 0};
  }
}

template <bool kRing, bool kTenants = false>
__global__ void __launch_bounds__(kChainThreads) chain_kernel(
    const uint4* __restrict__ bodies,  // [T, L, 16] as 4 x uint4
    const uint4* __restrict__ seeds,   // [L, 8] as 2 x uint4
    uint4* __restrict__ out,           // [T, L, 8] as 2 x uint4
    int T, int L, int per_block, RingArgs ring) {
  __shared__ uint32_t mid[2][8][kChainThreads];  // [buffer][word][turn-major (turn, lane)]
  const int lane0 = blockIdx.x * per_block;
  const int lanes = min(per_block, L - lane0);
  const int k = kChainThreads / lanes;
  const int tid = threadIdx.x;
  const int my_turn = tid / lanes, my_lane = lane0 + tid % lanes;  // in the tile
  uint32_t parent[8];
  // The chain thread's lane: its session, its first lane-major row and
  // that row's ring row; turn t of the lane is row + t, and its ring row
  // one conditional subtraction from lane_dst + t, so no division sits
  // on the serial chain.
  int my_session = 0;
  long long lane_row = 0;
  int lane_live = 0;
  size_t lane_base = 0;
  unsigned lane_dst = 0;
  if (tid < lanes) {
    const uint4 s0 = seeds[2 * (size_t)(lane0 + tid)], s1 = seeds[2 * (size_t)(lane0 + tid) + 1];
    parent[0] = s0.x; parent[1] = s0.y; parent[2] = s0.z; parent[3] = s0.w;
    parent[4] = s1.x; parent[5] = s1.y; parent[6] = s1.z; parent[7] = s1.w;
    if (kRing) {
      const LaneRing lr = lane_ring<kTenants>(ring, lane0 + tid);
      my_session = ring.wave_sessions[lane0 + tid];
      lane_row = static_cast<long long>(lr.lane) * T;
      lane_live = lr.n_live;
      lane_base = lr.base;
      if (lane_row < lr.n_live) lane_dst = ring_row(lr.cursor, ring.C, lane_row);
    }
  }
  if (kRing && blockIdx.x == 0) {
    if constexpr (kTenants) {
      for (int tn = tid; tn < ring.T; tn += blockDim.x) {
        ring.cursor_out[tn] =
            static_cast<int>(static_cast<unsigned>(ring.cursors[tn]) + ring.n_lives[tn]);
      }
    } else if (tid == 0) {
      *ring.cursor_out = static_cast<int>(static_cast<unsigned>(ring.cursor) + ring.n_live);
    }
  }
  for (int t0 = 0, buf = 0; t0 < T; t0 += k, buf ^= 1) {  // block-uniform
    const int t = t0 + my_turn;
    if (my_turn < k && t < T) {
      const size_t row = (size_t)t * L + my_lane;
      bool live = false;
      size_t dst = 0;
      if (kRing) {
        const LaneRing lr = lane_ring<kTenants>(ring, my_lane);
        const long long ring_i = static_cast<long long>(lr.lane) * T + t;
        live = ring_i < lr.n_live;
        if (live) dst = lr.base + ring_row(lr.cursor, ring.C, ring_i);
      }
      uint32_t body[16], st[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 v = bodies[4 * row + q];
        if (live) ring.body[4 * dst + q] = v;
        body[4 * q] = v.x; body[4 * q + 1] = v.y; body[4 * q + 2] = v.z; body[4 * q + 3] = v.w;
      }
      hv::sha256_body_midstate(body, st);
#pragma unroll
      for (int j = 0; j < 8; ++j) mid[buf][j][tid] = st[j];
    }
    // Buffer buf is full; the other one is free, since its chain ran
    // before its readers reached this barrier.
    __syncthreads();
    if (tid < lanes) {
      const int turns = min(k, T - t0);
      for (int i = 0; i < turns; ++i) {
        uint32_t st[8], d[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) st[j] = mid[buf][j][i * lanes + tid];
        hv::sha256_chain_tail(st, parent, d);
        const size_t row = (size_t)(t0 + i) * L + lane0 + tid;
        const uint4 d0 = make_uint4(d[0], d[1], d[2], d[3]), d1 = make_uint4(d[4], d[5], d[6], d[7]);
        out[2 * row] = d0;
        out[2 * row + 1] = d1;
        if (kRing && lane_row + t0 + i < lane_live) {
          // A live row's turn is below n_live <= C, so one subtraction wraps it.
          unsigned d = lane_dst + static_cast<unsigned>(t0 + i);
          if (d >= static_cast<unsigned>(ring.C)) d -= static_cast<unsigned>(ring.C);
          const size_t dst = lane_base + d;
          ring.digest[2 * dst] = d0;
          ring.digest[2 * dst + 1] = d1;
          ring.session[dst] = my_session;
          ring.turn[dst] = t0 + i;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) parent[j] = d[j];
      }
    }
  }
}

// Eight words of a node from two 16-byte vectors, or zeros.
__device__ __forceinline__ void load_node(const uint4* p, bool load, uint32_t n[8]) {
  uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
  if (load) {
    a = p[0];
    b = p[1];
  }
  n[0] = a.x; n[1] = a.y; n[2] = a.z; n[3] = a.w; n[4] = b.x; n[5] = b.y; n[6] = b.z; n[7] = b.w;
}

// B3, the Merkle roots. Replaces hypervisor_tpu/kernels/mtu_pallas.py
// tree_roots. Bound on the H100 by integer operations: one pair is three
// SHA-256 compressions (sha256_hex_pair, ~3,900 instructions) against 64
// bytes of leaves. Both forms hash pairs (2j, 2j+1) in natural order
// (right := left where 2j+1 >= count), hash only the ceil(count/2) pairs
// the root depends on, and return leaf 0 for a count <= 1. The TPU
// kernel's bit-reversed node order and its 128-lane padding were layout
// tricks for its vector unit and are gone.
//
// Small trees (P <= 64, the main path's P = 4): sessions packed into
// warps. A session takes `lanes` = P/2 consecutive lanes (1 for P = 1),
// so a warp serves 32/lanes sessions (16 at P = 4) and the grid covers
// S x lanes threads, instead of a one-warp block per session in which
// two lanes of 32 hash. Lane j hashes leaves 2j and 2j+1 (16-byte
// loads), then at each level takes nodes 2j and 2j+1 from its
// neighbours with __shfl_sync: no shared memory, no __syncthreads. The
// level loop runs log2 P times on every lane, so each shuffle is warp-
// uniform with the full mask; a per-session predicate decides who
// hashes, and a lane past its session's count (or its session past S)
// carries its left node, which no live lane reads. What remains is
// latency: about 5 warps per SM at S = 10,000, each lane two dependent
// pair hashes deep.
__global__ void __launch_bounds__(64) tree_packed_kernel(
    const uint4* __restrict__ leaves,  // [S, P, 8] as 2 x uint4 a leaf
    const int* __restrict__ counts,    // [S]
    uint4* __restrict__ roots,         // [S, 8] as 2 x uint4
    int S, int P, int lanes) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int s = static_cast<int>(tid / lanes), j = static_cast<int>(tid % lanes);
  const bool live = s < S;
  int cnt = live ? counts[s] : 0;
  const int need = cnt < 1 ? 1 : (cnt > P ? P : cnt);
  uint32_t l[8], r[8], node[8];
  const size_t leaf = (size_t)s * P + 2 * j;
  load_node(leaves + 2 * leaf, live && 2 * j < need, l);
  load_node(leaves + 2 * leaf + 2, live && 2 * j + 1 < need, r);
#pragma unroll
  for (int k = 0; k < 8; ++k) node[k] = l[k];
  for (int m = P; m > 1; m >>= 1) {  // warp-uniform: P is the same for every lane
    if (m != P) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        l[k] = __shfl_sync(0xFFFFFFFFu, node[k], 2 * j, lanes);
        r[k] = __shfl_sync(0xFFFFFFFFu, node[k], 2 * j + 1, lanes);
      }
    }
    const int pairs = min((cnt + 1) >> 1, m >> 1);
    if (live && cnt > 1 && j < pairs) {
      if (2 * j + 1 >= cnt) {
#pragma unroll
        for (int k = 0; k < 8; ++k) r[k] = l[k];
      }
      hv::sha256_hex_pair(l, r, node);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) node[k] = l[k];
    }
    if (cnt > 1) cnt = (cnt + 1) >> 1;
  }
  if (live && j == 0) {
    roots[2 * (size_t)s] = make_uint4(node[0], node[1], node[2], node[3]);
    roots[2 * (size_t)s + 1] = make_uint4(node[4], node[5], node[6], node[7]);
  }
}

// Large trees (64 < P <= 4096): one block per session; the level lives
// in shared memory (P x 8 words, 128 KB at 4096) and is reduced in place.
// At each level the threads hash pairs chunk by chunk: every thread
// hashes into registers, the block syncs, then writes node j, so a chunk
// never overwrites a node a later chunk still reads.
__global__ void tree_kernel(const uint32_t* __restrict__ leaves,  // [S, P, 8]
                            const int* __restrict__ counts,       // [S]
                            uint32_t* __restrict__ roots,         // [S, 8]
                            int P) {
  extern __shared__ uint32_t level[];  // [P, 8]
  const int s = blockIdx.x;
  int cnt = counts[s];
  const int need = cnt < 1 ? 1 : (cnt > P ? P : cnt);
  const uint32_t* src = leaves + (size_t)s * P * 8;
  for (int i = threadIdx.x; i < need * 8; i += blockDim.x) level[i] = src[i];
  __syncthreads();
  int m = P;
  while (m > 1 && cnt > 1) {  // block-uniform loop
    const int half = m >> 1;
    const int pairs = min((cnt + 1) >> 1, half);
    for (int base = 0; base < pairs; base += blockDim.x) {
      const int j = base + threadIdx.x;
      const bool active = j < pairs;
      uint32_t d[8];
      if (active) {
        uint32_t l[8], r[8];
        const bool dup = 2 * j + 1 >= cnt;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          l[k] = level[(2 * j) * 8 + k];
          r[k] = dup ? l[k] : level[(2 * j + 1) * 8 + k];
        }
        hv::sha256_hex_pair(l, r, d);
      }
      __syncthreads();
      if (active) {
#pragma unroll
        for (int k = 0; k < 8; ++k) level[j * 8 + k] = d[k];
      }
      __syncthreads();
    }
    cnt = (cnt + 1) >> 1;
    m = half;
  }
  if (threadIdx.x < 8) roots[(size_t)s * 8 + threadIdx.x] = level[threadIdx.x];
}

}  // namespace

extern "C" const char* hv_mtu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace {

cudaError_t launch_chain(bool with_ring, const void* bodies, const void* seeds, void* out, int T,
                         int L, const RingArgs& ring, void* stream, bool tenants = false) {
  if (T > 0 && L > 0) {
    int sms = 0;
    if (cudaError_t err = hv::sm_count(&sms)) return err;
    const int per_block = min((L + sms - 1) / sms, kChainLanes);
    const int blocks = (L + per_block - 1) / per_block;
    auto kernel = tenants ? chain_kernel<true, true>
                          : (with_ring ? chain_kernel<true> : chain_kernel<false>);
    kernel<<<blocks, kChainThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(bodies), static_cast<const uint4*>(seeds),
        static_cast<uint4*>(out), T, L, per_block, ring);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int hv_chain_digests(const void* bodies, const void* seeds, void* out, int T, int L,
                                void* stream) {
  return static_cast<int>(launch_chain(false, bodies, seeds, out, T, L, RingArgs{}, stream));
}

// The ring form: the chain plus the DeltaLog append of its first n_live
// lane-major rows at cursor (the host mirror; 0 <= n_live <= min(T * L, C)).
extern "C" int hv_chain_digests_ring(const void* bodies, const void* seeds, void* out, int T,
                                     int L, void* ring_body, void* ring_digest,
                                     void* ring_session, void* ring_turn, void* ring_cursor,
                                     const void* wave_sessions, int cursor, int n_live, int C,
                                     void* stream) {
  RingArgs ring;
  ring.body = static_cast<uint4*>(ring_body);
  ring.digest = static_cast<uint4*>(ring_digest);
  ring.session = static_cast<int*>(ring_session);
  ring.turn = static_cast<int*>(ring_turn);
  ring.cursor_out = static_cast<int*>(ring_cursor);
  ring.wave_sessions = static_cast<const int*>(wave_sessions);
  ring.cursor = cursor;
  ring.n_live = n_live;
  ring.C = C;
  return static_cast<int>(launch_chain(true, bodies, seeds, out, T, L, ring, stream));
}

// The tenant ring form: T tenants' chains over L = T * lanes_t lanes and
// their appends, each onto its own ring of C rows of the stacked DeltaLog
// ([T, C] columns, cursor [T]) at cursors[t], its first n_lives[t]
// lane-major rows (device arrays, i32[T]; 0 <= n_lives[t] <= min(T_turns
// * lanes_t, C)).
extern "C" int hv_chain_digests_ring_tenants(
    const void* bodies, const void* seeds, void* out, int T_turns, int tenants, int lanes_t,
    void* ring_body, void* ring_digest, void* ring_session, void* ring_turn, void* ring_cursor,
    const void* wave_sessions, const void* cursors, const void* n_lives, int C, void* stream) {
  RingArgs ring{};
  ring.body = static_cast<uint4*>(ring_body);
  ring.digest = static_cast<uint4*>(ring_digest);
  ring.session = static_cast<int*>(ring_session);
  ring.turn = static_cast<int*>(ring_turn);
  ring.cursor_out = static_cast<int*>(ring_cursor);
  ring.wave_sessions = static_cast<const int*>(wave_sessions);
  ring.cursors = static_cast<const int*>(cursors);
  ring.n_lives = static_cast<const int*>(n_lives);
  ring.C = C;
  ring.lanes_t = lanes_t;
  ring.T = tenants;
  return static_cast<int>(
      launch_chain(true, bodies, seeds, out, T_turns, tenants * lanes_t, ring, stream, true));
}

extern "C" int hv_tree_roots(const void* leaves, const void* counts, void* roots, int S, int P,
                             int lanes, void* stream) {
  if (S > 0 && lanes > 0) {
    // The wrapper's tree_lanes_per_session: P/2 lanes a session (1 for P = 1).
    if (lanes != (P > 1 ? P / 2 : 1) || lanes > 32) return static_cast<int>(cudaErrorInvalidValue);
    const int threads = 64;
    const long long total = (long long)S * lanes;
    tree_packed_kernel<<<static_cast<int>((total + threads - 1) / threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(leaves), static_cast<const int*>(counts),
        static_cast<uint4*>(roots), S, P, lanes);
  } else if (S > 0) {
    const size_t smem = (size_t)P * 8 * sizeof(uint32_t);
    cudaError_t err = cudaFuncSetAttribute(
        tree_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int threads = P / 2;
    threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
    tree_kernel<<<S, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(leaves), static_cast<const int*>(counts),
        static_cast<uint32_t*>(roots), P);
  }
  return static_cast<int>(cudaGetLastError());
}
