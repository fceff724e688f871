// Kernel B8 for Hopper (sm_90a): the depth-bounded slash cascade in
// one cooperative launch. Replaces hypervisor_tpu/kernels/liability_pallas.py
// slash_cascade_pallas (_gather_kernel, _scatter_kernel), which writes
// the gather and the two scatters as one-hot bf16 matmuls for the
// TPU's matrix unit. Plain C entry points, bound with ctypes by
// hypervisor_tpu_torch/kernels/liability.py; each returns the launch's
// CUDA error.
//
// Bound by the launch and by latency: at the default 16,384 agents x
// 65,536 edges the cascade moves about 1.3 MB, which the card reads in
// 0.4 us, while each depth needs every edge's hit before any agent's
// clip, and every agent's clip before the next depth's edges. So the
// whole cascade is one grid, at most one block of THREADS on each SM,
// launched with cudaLaunchCooperativeKernel, its phases separated by grid
// barriers (cooperative_groups' grid.sync(), which reads the grid's
// barrier word from an environment register and needs no -rdc). A
// barrier costs about as much as a pass, so a depth takes ONE phase and
// one barrier, not two: phase p
//   - settles depth p - 1 for the agents a thread owns (n = tid, tid +
//     stride, ...): the blacklist, the clip max(sigma * (1 - omega)^k,
//     floor) with the count k of depth p - 1, the flags, and the state
//     entering depth p, written to one of two buffers while the other
//     is read;
//   - and, for the edges a thread owns (the same way), tests depth p's
//     hit against the wave of depth p, which each edge settles for its
//     own vouchee with the very code the vouchee's owner runs (same
//     inputs, same bits), then adds the hit into the voucher's count of
//     depth p with an int32 atomicAdd and releases the bond.
// An agent joins the next wave when it is clipped below the wipe line,
// is not slashed, and still has a live in-session edge as vouchee. Such
// an agent was never in a wave, so none of those edges was ever hit:
// each of them is live when it settles its vouchee, and the edges that
// find their vouchee wiped mark it in the wave. That costs a write per
// hit, where a has-vouchers flag would cost one per live edge, and those
// writes, many to the same few cache lines, held up the barriers.
// Phase 0 has only edges (depth 0's wave is the seeds), and phase D
// (D = depths) only owners, which write sigma and slashed and count the
// slashed and clipped agents into the metrics counters when they ride
// in (a warp sum, a block sum in shared memory, one unsigned atomic a
// block and counter). That is D barriers. The counts and wave marks are
// kept a depth apart in three buffers, each zeroed by its owners one
// phase after its last reader, so every launch leaves them zero; the
// sigma and slashed flag entering a depth are kept in two. The reads
// after a barrier are plain loads: grid.sync() acquires at gpu scope.
// A thread keeps its first HELD edges (vouchee, voucher and a live bit)
// in registers from phase 0 on; edges past HELD x the grid's threads are
// reloaded every phase, from the inputs and the active column this
// thread wrote. Phase 0 writes every edge's active column and phase 1
// every agent's clipped and wave_of, so no output needs a host-side
// clone or fill.
//
// The clip factor (1 - omega)^k is read from a table the host built
// with its C library's powf(1 - omega, (float)k), subnormals flushed
// (kernels/liability.py factor_table): the bits the reference's CPU
// run gives. k is clamped to the table's last entry, past which every k
// gives the same value. The counts are integers, exact in any order; no
// float is accumulated by atomics. Compiled with --fmad=false: sigma * p
// rounds once, as in the reference. No depth exits early: the
// reference has no early exit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int HELD = 2;  // edges a thread keeps in registers across depths
constexpr int MAX_DEVICES = 64;

struct Cascade {
  // inputs
  const int* voucher;
  const int* vouchee;
  const int* session;
  const uint8_t* active_in;
  const float* expiry;
  const uint8_t* seeds;   // the wave of depth 0
  const float* sigma_in;  // element n at n * sigma_stride
  const float* factor;
  // outputs
  float* sigma;
  uint8_t* active;
  uint8_t* slashed;
  uint8_t* clipped;
  int8_t* wave_of;
  unsigned* counters;  // the metrics counters, or null
  // workspace, each buffer N long
  int* k;                 // [3] hits on each voucher at depth d, in buffer d % 3
  uint8_t* waved;         // [3] in the wave of depth d > 0, in buffer d % 3
  float* state_sigma;     // [2] sigma entering depth d, in buffer d % 2
  uint8_t* state_slashed; // [2] slashed before depth d, in buffer d % 2
  int sigma_stride, slashed_row, clipped_row, n_factor, sess, depths, E, N;
  float now, floor_, wipe;
};

// An agent settled through depth d.
struct Settled {
  float sigma;     // after depth d's blacklist and clip
  bool slashed;    // through depth d
  bool in_wave;    // in the wave of depth d
  bool hit;        // k > 0 at depth d: clipped
  bool wiped;      // clipped below the wipe line and not slashed
};

// Agent x through depth d, once depth d's counts and waves are complete.
// Edges and owners call it alike, so both see the same bits.
__device__ __forceinline__ Settled settle(const Cascade& c, int d, int x) {
  const size_t N = c.N;
  float s;
  bool slashed, in_wave;
  if (d == 0) {
    s = c.sigma_in[static_cast<size_t>(x) * c.sigma_stride];
    slashed = false;
    in_wave = c.seeds[x];
  } else {
    s = c.state_sigma[(d & 1) * N + x];
    slashed = c.state_slashed[(d & 1) * N + x];
    in_wave = c.waved[(d % 3) * N + x];
  }
  const int kx = c.k[(d % 3) * N + x];
  if (in_wave) {
    s = 0.0f;
    slashed = true;
  }
  if (kx > 0) {
    const float p = __ldg(c.factor + (kx < c.n_factor ? kx : c.n_factor - 1));
    const float y = __fmul_rn(s, p);
    s = (y >= c.floor_ || y != y) ? y : c.floor_;  // maximum, NaN passes through
  }
  return {s, slashed, in_wave, kx > 0, kx > 0 && s < c.wipe && !slashed};
}

// One live in-session edge at depth d: the hit test against the wave of
// depth d. Returns whether it was hit. A wiped agent joins the next
// wave when it is the vouchee of a live in-session edge, which this
// edge is; so the edge that finds its vouchee wiped also marks it in
// the wave, and an agent no such edge names stays out of it.
__device__ __forceinline__ bool edge_hit(const Cascade& c, int d, int vee, int vr) {
  const size_t at = static_cast<size_t>(d % 3) * c.N;
  const bool in_wave = d == 0 ? static_cast<bool>(c.seeds[vee]) : settle(c, d - 1, vee).wiped;
  if (in_wave) {
    if (d > 0) c.waved[at + vee] = 1;  // every writer stores the same value
    if (vr >= 0) atomicAdd(c.k + at + vr, 1);
  }
  return in_wave;
}

__global__ void __launch_bounds__(THREADS, 1) slash_cascade_kernel(Cascade c) {
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * THREADS + threadIdx.x;
  const int stride = gridDim.x * THREADS;
  const size_t N = c.N;
  int held_vee[HELD], held_vr[HELD];
  bool held_live[HELD];
  unsigned n_slashed = 0, n_clipped = 0;

  for (int p = 0; p <= c.depths; ++p) {
    // ── owners: settle depth p - 1 ──
    if (p > 0) {
      const bool last = p == c.depths;
      for (int n = tid; n < c.N; n += stride) {
        const Settled a = settle(c, p - 1, n);
        const bool was_clipped = a.hit || (p > 1 && c.clipped[n]);
        if (p == 1) {
          c.clipped[n] = was_clipped;
          c.wave_of[n] = a.in_wave ? 0 : -1;
        } else {
          if (a.hit) c.clipped[n] = 1;
          if (a.in_wave) c.wave_of[n] = static_cast<int8_t>(p - 1);
        }
        if (p >= 2) {  // depth p - 2's last readers ran in phase p - 1
          c.k[((p - 2) % 3) * N + n] = 0;
          c.waved[((p - 2) % 3) * N + n] = 0;
        }
        if (last) {
          c.k[((p - 1) % 3) * N + n] = 0;
          c.waved[((p - 1) % 3) * N + n] = 0;
          c.sigma[n] = a.sigma;
          c.slashed[n] = a.slashed;
          n_slashed += a.slashed;
          n_clipped += was_clipped;
        } else {
          c.state_sigma[(p & 1) * N + n] = a.sigma;
          c.state_slashed[(p & 1) * N + n] = a.slashed;
        }
      }
    }
    if (p == c.depths) break;
    // ── edges: depth p ──
#pragma unroll
    for (int h = 0; h < HELD; ++h) {
      const int e = tid + h * stride;
      if (p == 0) {
        held_live[h] = false;
        if (e < c.E) {  // every field at once: one round trip
          const bool active = c.active_in[e];
          const int vee = c.vouchee[e], vr = c.voucher[e], sess = c.session[e];
          const float expiry = c.expiry[e];
          held_vee[h] = vee;
          held_vr[h] = vr;
          const bool live = active && c.now <= expiry && sess == c.sess && vee >= 0;
          const bool hit = live && edge_hit(c, 0, vee, vr);
          held_live[h] = live && !hit;
          c.active[e] = active && !hit;
        }
      } else if (held_live[h] && edge_hit(c, p, held_vee[h], held_vr[h])) {
        held_live[h] = false;
        c.active[e] = 0;  // the consumed bond is released
      }
    }
    for (int e = tid + HELD * stride; e < c.E; e += stride) {
      const bool active = p == 0 ? c.active_in[e] : c.active[e];
      const int vee = c.vouchee[e], sess = c.session[e];
      const float expiry = c.expiry[e];
      bool hit = false;
      if (active && c.now <= expiry && sess == c.sess && vee >= 0) {
        hit = edge_hit(c, p, vee, c.voucher[e]);
      }
      if (p == 0 || hit) c.active[e] = active && !hit;
    }
    grid.sync();
  }

  if (c.counters == nullptr) return;  // uniform over the grid
  __shared__ unsigned warp_slashed[WARPS], warp_clipped[WARPS];
  n_slashed = __reduce_add_sync(0xffffffffu, n_slashed);
  n_clipped = __reduce_add_sync(0xffffffffu, n_clipped);
  if ((threadIdx.x & 31) == 0) {
    warp_slashed[threadIdx.x / 32] = n_slashed;
    warp_clipped[threadIdx.x / 32] = n_clipped;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned sum_slashed = 0, sum_clipped = 0;
    for (int w = 0; w < WARPS; ++w) {
      sum_slashed += warp_slashed[w];
      sum_clipped += warp_clipped[w];
    }
    if (sum_slashed) atomicAdd(c.counters + c.slashed_row, sum_slashed);
    if (sum_clipped) atomicAdd(c.counters + c.clipped_row, sum_clipped);
  }
}

// Grid barriers alone, for timing one barrier at the cascade's grid.
__global__ void __launch_bounds__(THREADS) grid_barrier_probe_kernel(int reps) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < reps; ++i) grid.sync();
}

// The SMs of the current device (cached), each of which must hold one
// block of the cascade.
int device_sms(int* sms) {
  static int cached[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && cached[dev] > 0) {
    *sms = cached[dev];
    return cudaSuccess;
  }
  int per_sm = 0;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, slash_cascade_kernel, THREADS, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (dev < MAX_DEVICES) cached[dev] = *sms;
  return cudaSuccess;
}

// The cascade's grid: enough blocks for every edge held (HELD a thread)
// and every agent owned (one a thread), at most one block an SM: on the
// slash path's tables half the SMs' blocks timed faster than one an SM,
// and two an SM slower still (PERF.md).
int cascade_blocks(long long E, long long N, int* blocks) {
  int sms = 0;
  const int err = device_sms(&sms);
  if (err != cudaSuccess) return err;
  const long long per_block = static_cast<long long>(THREADS) * HELD;
  long long need = (E + per_block - 1) / per_block;
  if ((N + THREADS - 1) / THREADS > need) need = (N + THREADS - 1) / THREADS;
  *blocks = static_cast<int>(need < 1 ? 1 : (need > sms ? sms : need));
  return cudaSuccess;
}

}  // namespace

extern "C" const char* hv_liability_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most edges the cascade's grid keeps in registers on the current
// device.
extern "C" int hv_slash_held_edges(long long* edges) {
  int sms = 0;
  const int err = device_sms(&sms);
  *edges = static_cast<long long>(sms) * THREADS * HELD;
  return err;
}

// counters: the metrics table's u32 counter column (int32 storage), or
// null to book nothing. k and waved 3 x N: zero, and left zero;
// state_sigma and state_slashed 2 x N, any contents.
extern "C" int hv_slash_cascade(const void* voucher, const void* vouchee, const void* session,
                                const void* active_in, const void* expiry, const void* seeds,
                                const void* sigma_in, int sigma_stride, const void* factor,
                                void* sigma, void* active, void* slashed, void* clipped,
                                void* wave_of, void* counters, void* k, void* waved,
                                void* state_sigma, void* state_slashed, int slashed_row,
                                int clipped_row, int n_factor, int sess, int depths, float now,
                                float floor_, float wipe, int E, int N, void* stream) {
  Cascade c{static_cast<const int*>(voucher), static_cast<const int*>(vouchee),
            static_cast<const int*>(session), static_cast<const uint8_t*>(active_in),
            static_cast<const float*>(expiry), static_cast<const uint8_t*>(seeds),
            static_cast<const float*>(sigma_in), static_cast<const float*>(factor),
            static_cast<float*>(sigma), static_cast<uint8_t*>(active),
            static_cast<uint8_t*>(slashed), static_cast<uint8_t*>(clipped),
            static_cast<int8_t*>(wave_of), static_cast<unsigned*>(counters),
            static_cast<int*>(k), static_cast<uint8_t*>(waved),
            static_cast<float*>(state_sigma), static_cast<uint8_t*>(state_slashed), sigma_stride,
            slashed_row, clipped_row, n_factor, sess, depths, E, N, now, floor_, wipe};
  int blocks = 0;
  cudaError_t err = static_cast<cudaError_t>(cascade_blocks(E, N, &blocks));
  if (err != cudaSuccess) return err;
  void* args[] = {&c};
  err = cudaLaunchCooperativeKernel((void*)slash_cascade_kernel, dim3(blocks), dim3(THREADS), args,
                                    0, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

// One cooperative launch at the cascade's grid for E edges and N agents
// that only crosses `reps` grid barriers.
extern "C" int hv_grid_barrier_probe(int reps, int E, int N, void* stream) {
  int blocks = 0;
  cudaError_t err = static_cast<cudaError_t>(cascade_blocks(E, N, &blocks));
  if (err != cudaSuccess) return err;
  void* args[] = {&reps};
  err = cudaLaunchCooperativeKernel((void*)grid_barrier_probe_kernel, dim3(blocks), dim3(THREADS),
                                    args, 0, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}
