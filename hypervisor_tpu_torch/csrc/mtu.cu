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

// B2. Replaces hypervisor_tpu/kernels/mtu_pallas.py chain_digests_mtu.
// One thread per lane walks the T turns in order, the parent digest in
// registers: d_t = sha256(body_t || d_{t-1}), d_{-1} = seed. The TPU's
// sequential grid axis and its VMEM carry become this in-thread loop.
__global__ void chain_kernel(const uint4* __restrict__ bodies,  // [T, L, 16] as 4 x uint4
                             const uint4* __restrict__ seeds,   // [L, 8] as 2 x uint4
                             uint4* __restrict__ out,           // [T, L, 8] as 2 x uint4
                             int T, int L) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  uint32_t parent[8];
  {
    const uint4 s0 = seeds[2 * (size_t)l], s1 = seeds[2 * (size_t)l + 1];
    parent[0] = s0.x; parent[1] = s0.y; parent[2] = s0.z; parent[3] = s0.w;
    parent[4] = s1.x; parent[5] = s1.y; parent[6] = s1.z; parent[7] = s1.w;
  }
  for (int t = 0; t < T; ++t) {
    const size_t row = (size_t)t * L + l;
    uint32_t body[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = bodies[4 * row + q];
      body[4 * q] = v.x; body[4 * q + 1] = v.y; body[4 * q + 2] = v.z; body[4 * q + 3] = v.w;
    }
    uint32_t d[8];
    hv::sha256_chain_link(body, parent, d);
    out[2 * row] = make_uint4(d[0], d[1], d[2], d[3]);
    out[2 * row + 1] = make_uint4(d[4], d[5], d[6], d[7]);
#pragma unroll
    for (int j = 0; j < 8; ++j) parent[j] = d[j];
  }
}

// B3. Replaces hypervisor_tpu/kernels/mtu_pallas.py tree_roots. One
// block per session; the level lives in shared memory (P x 8 words) and
// is reduced in place. At each level the threads hash pairs (2j, 2j+1)
// in natural order (right := left where 2j+1 >= count), chunk by chunk:
// every thread hashes into registers, the block syncs, then writes node
// j, so a chunk never overwrites a node a later chunk still reads. Only
// the ceil(count/2) pairs the root depends on are hashed; a count <= 1
// returns leaf 0. The TPU kernel's bit-reversed node order and its
// 128-lane padding were layout tricks for its vector unit and are gone.
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

extern "C" int hv_chain_digests(const void* bodies, const void* seeds, void* out, int T, int L,
                                void* stream) {
  if (T > 0 && L > 0) {
    const int threads = 128;
    chain_kernel<<<(L + threads - 1) / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(bodies), static_cast<const uint4*>(seeds),
        static_cast<uint4*>(out), T, L);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hv_tree_roots(const void* leaves, const void* counts, void* roots, int S, int P,
                             void* stream) {
  if (S > 0) {
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
