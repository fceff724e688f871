// Batched SHA-256 for Hopper (sm_90a): kernel B1. Plain C entry point,
// bound with ctypes by hypervisor_tpu_torch/kernels/sha256.py; u32 words
// arrive as the int32 tensors of the port's u32 convention and are read
// here as uint32_t. The entry launches on the caller's stream and
// returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256.cuh"

namespace {

constexpr int kThreads = 128;  // messages a block, at most

// B1. Replaces hypervisor_tpu/kernels/sha256_pallas.py sha256_words
// (_sha256_tiled's pallas_call): FIPS 180-4 SHA-256 over pre-padded
// big-endian words u32[B, nb*16] -> u32[B, 8]. One thread owns one
// message, its state and schedule window in registers (sha256.cuh), the
// block loop rolled so the compression's code is fetched once.
//
// At the scrubber's strip (4,096 messages), verify's few links and the
// big tree's upper levels an SMSP holds at most one warp, so the time
// is the thread's serial path. Each block's four 16-byte loads are
// issued before the previous block's rounds, so only block 0 waits on
// memory. A strip with fewer than kThreads messages an SM runs in
// blocks of whole warps spread over the SMs. At 30,000 messages the
// kernel is bound by integer instructions (~1,350 a compression against
// 64 bytes read). The TPU kernel laid 1024 messages out as (8, 128)
// register tiles and padded B up to a multiple of 1024; here any B runs.
__global__ void __launch_bounds__(kThreads) sha256_kernel(
    const uint4* __restrict__ words,  // [B, nb*16] as nb*4 x uint4
    uint4* __restrict__ out,          // [B, 8] as 2 x uint4
    int B, int nb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const uint4* msg = words + (size_t)i * nb * 4;
  uint32_t st[8];
  hv::sha256_init(st);
  uint4 v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = msg[q];
#pragma unroll 1
  for (int blk = 0; blk < nb; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[4 * q] = v[q].x; w[4 * q + 1] = v[q].y; w[4 * q + 2] = v[q].z; w[4 * q + 3] = v[q].w;
    }
    if (blk + 1 < nb) {
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = msg[4 * (blk + 1) + q];
    }
    hv::sha256_compress(st, w);
  }
  out[2 * (size_t)i] = make_uint4(st[0], st[1], st[2], st[3]);
  out[2 * (size_t)i + 1] = make_uint4(st[4], st[5], st[6], st[7]);
}

}  // namespace

extern "C" const char* hv_sha256_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int hv_sha256_words(const void* words, void* out, int B, int nb, void* stream) {
  if (B > 0) {
    // Fewer messages than kThreads a block on every SM: smaller blocks
    // (whole warps), so the warps spread over the SMs, not 4 to an SM.
    int sms = 0;
    if (cudaError_t err = hv::sm_count(&sms)) return static_cast<int>(err);
    int threads = kThreads;
    if ((B + kThreads - 1) / kThreads < sms) {
      const int per_sm = (B + sms - 1) / sms;
      threads = min(kThreads, (per_sm + 31) / 32 * 32);
    }
    sha256_kernel<<<(B + threads - 1) / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(words), static_cast<uint4*>(out), B, nb);
  }
  return static_cast<int>(cudaGetLastError());
}
