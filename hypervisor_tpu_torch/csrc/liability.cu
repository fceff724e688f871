// Kernel B8 for Hopper (sm_90a): the depth-bounded slash cascade.
// Replaces hypervisor_tpu/kernels/liability_pallas.py
// slash_cascade_pallas (_gather_kernel, _scatter_kernel), which writes
// the gather and the two scatters as one-hot bf16 matmuls for the
// TPU's matrix unit. Plain C entry points, bound with ctypes by
// hypervisor_tpu_torch/kernels/liability.py; every buffer is updated in
// place on the caller's stream and each entry returns cudaGetLastError().
//
// Bound by bytes. Each depth is two launches, issued from the host with
// no synchronisation between them:
//   slash_edges   one thread per edge: the hit test against the wave,
//                 an int32 atomicAdd of the hit into the voucher's count,
//                 the bond release, and the has-vouchers flag of the
//                 vouchee for live in-session edges not hit;
//   slash_agents  one thread per agent: the blacklist, the clip
//                 max(sigma * (1 - omega)^k, floor), the next wave, and
//                 the counts zeroed for the next depth.
// The clip factor (1 - omega)^k is read from a table the host built
// with its C library's powf(1 - omega, (float)k), subnormals flushed
// (kernels/liability.py factor_table): the bits the reference's CPU
// run gives. k is clamped to the table's last entry, past which every k
// gives the same value.
// The counts are integers, exact in any order; no float is accumulated
// by atomics. Compiled with --fmad=false: sigma * p rounds once, as in
// the reference.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void slash_edges_kernel(const int* voucher, const int* vouchee, const int* session,
                                   uint8_t* active, const float* expiry, const uint8_t* wave,
                                   int* k, uint8_t* has_vouchers, int sess, float now, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  if (!active[e] || !(now <= expiry[e]) || session[e] != sess) return;
  const int vee = vouchee[e];
  if (vee < 0) return;
  if (wave[vee]) {
    const int vr = voucher[e];
    if (vr >= 0) atomicAdd(k + vr, 1);
    active[e] = 0;  // the consumed bond is released
  } else {
    has_vouchers[vee] = 1;  // every writer stores the same value
  }
}

__global__ void slash_agents_kernel(float* sigma, uint8_t* wave, uint8_t* slashed,
                                    uint8_t* clipped, int8_t* wave_of, int* k,
                                    uint8_t* has_vouchers, const float* factor, int n_factor,
                                    int depth, int last, float floor_, float wipe, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float s = sigma[n];
  bool was_slashed = slashed[n];
  if (wave[n]) {
    s = 0.0f;
    was_slashed = true;
    slashed[n] = 1;
    if (wave_of[n] < 0) wave_of[n] = static_cast<int8_t>(depth);
  }
  const int kn = k[n];
  if (kn > 0) {
    const float x = __fmul_rn(s, factor[kn < n_factor ? kn : n_factor - 1]);
    s = (x >= floor_ || x != x) ? x : floor_;  // maximum, NaN passes through
    clipped[n] = 1;
  }
  sigma[n] = s;
  if (!last) wave[n] = kn > 0 && s < wipe && has_vouchers[n] && !was_slashed;
  k[n] = 0;
  has_vouchers[n] = 0;
}

}  // namespace

extern "C" const char* hv_liability_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int hv_slash_edges(const void* voucher, const void* vouchee, const void* session,
                              void* active, const void* expiry, const void* wave, void* k,
                              void* has_vouchers, int sess, float now, int E, void* stream) {
  if (E > 0) {
    const int threads = 256;
    slash_edges_kernel<<<(E + threads - 1) / threads, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(voucher), static_cast<const int*>(vouchee),
        static_cast<const int*>(session), static_cast<uint8_t*>(active),
        static_cast<const float*>(expiry), static_cast<const uint8_t*>(wave),
        static_cast<int*>(k), static_cast<uint8_t*>(has_vouchers), sess, now, E);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hv_slash_agents(void* sigma, void* wave, void* slashed, void* clipped,
                               void* wave_of, void* k, void* has_vouchers, const void* factor,
                               int n_factor, int depth, int last, float floor_, float wipe, int N,
                               void* stream) {
  if (N > 0) {
    const int threads = 256;
    slash_agents_kernel<<<(N + threads - 1) / threads, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(sigma), static_cast<uint8_t*>(wave), static_cast<uint8_t*>(slashed),
        static_cast<uint8_t*>(clipped), static_cast<int8_t*>(wave_of), static_cast<int*>(k),
        static_cast<uint8_t*>(has_vouchers), static_cast<const float*>(factor), n_factor, depth,
        last, floor_, wipe, N);
  }
  return static_cast<int>(cudaGetLastError());
}
