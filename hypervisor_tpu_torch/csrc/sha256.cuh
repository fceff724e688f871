// SHA-256 compression (FIPS 180-4) for the port's Hopper kernels.
//
// Shared by the chain and tree kernels (mtu.cu) and the batched hash
// kernel (sha256.cu). One thread owns one message: the 64 rounds are
// fully unrolled so the 16-word schedule window and the eight working
// variables stay in registers; rotr is one funnel shift.
//
// At the paths' shapes an SMSP holds one warp or two, and even one warp
// keeps the SMSP's 16-lane integer pipe busy: a compression is about
// 1,270 SHF, LOP3 and IADD3, two cycles each. So the round is written
// for the fewest such instructions, with its dependent chain as short as
// that allows:
// - the round constants are compile-time immediates (`sha256_k`, folded
//   once the rounds unroll), read from no constant bank;
// - h + K_i + W_i is formed a round ahead (h_i = g_{i-1}), with the next
//   round's message word, and the round then needs four adds, as the
//   textbook order does. Forming d + h + K + W ahead too would take one
//   add off the path from e to the next e but costs a fifth add a round,
//   which made every SHA kernel slower on the card.
// Additions mod 2^32 are exact in any order: the digest is bit for bit
// the same.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hv {

__device__ __forceinline__ constexpr uint32_t sha256_k(int i) {
  constexpr uint32_t k[64] = {
      0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
      0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
      0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
      0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
      0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
      0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
      0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
      0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
      0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
      0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
      0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
  };
  return k[i];
}

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ void sha256_init(uint32_t st[8]) {
  st[0] = 0x6A09E667u; st[1] = 0xBB67AE85u; st[2] = 0x3C6EF372u; st[3] = 0xA54FF53Au;
  st[4] = 0x510E527Fu; st[5] = 0x9B05688Cu; st[6] = 0x1F83D9ABu; st[7] = 0x5BE0CD19u;
}

// W_i for i >= 16 into the rolling window, which holds W_{i-16..i-1}.
__device__ __forceinline__ uint32_t sha256_schedule(uint32_t w[16], int i) {
  const uint32_t w15 = w[(i - 15) & 15];
  const uint32_t w2 = w[(i - 2) & 15];
  const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
  const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
  w[i & 15] += s0 + w[(i - 7) & 15] + s1;  // w[i & 15] held W_{i-16}
  return w[i & 15];
}

// One compression: st <- st + rounds(st, w). w is consumed (it holds the
// rolling 16-word message schedule).
__device__ __forceinline__ void sha256_compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
  uint32_t hkw = h + sha256_k(0) + w[0];  // h + K_i + W_i of the round about to run
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    // Off the critical path: the next round's W and h + K + W (its h is
    // this round's g).
    uint32_t hkw_next = 0;
    if (i < 63) hkw_next = g + sha256_k(i + 1) + (i < 15 ? w[i + 1] : sha256_schedule(w, i + 1));
    const uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint32_t t1 = hkw + s1 + ch;
    const uint32_t e_next = d + t1;
    const uint32_t a_next = t1 + s0 + maj;   // t1 + t2
    h = g; g = f; f = e; e = e_next;
    d = c; c = b; b = a; a = a_next;
    hkw = hkw_next;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// Four lowercase ASCII hex chars of a 16-bit value, packed big-endian:
// nibble n -> n + 0x30 + (n > 9) * 0x27.
__device__ __forceinline__ uint32_t hex4(uint32_t v) {
  uint32_t out = 0;
#pragma unroll
  for (int s = 12; s >= 0; s -= 4) {
    const uint32_t n = (v >> s) & 0xFu;
    out = (out << 8) | (n + 0x30u + (n > 9u ? 0x27u : 0u));
  }
  return out;
}

// sha256(hex(l) || hex(r)): the Merkle interior-node combine, a 128-byte
// ASCII message in 3 blocks (the third is padding only).
__device__ __forceinline__ void sha256_hex_pair(const uint32_t l[8], const uint32_t r[8],
                                                uint32_t out[8]) {
  uint32_t w[16];
  sha256_init(out);
#pragma unroll
  for (int j = 0; j < 8; ++j) { w[2 * j] = hex4(l[j] >> 16); w[2 * j + 1] = hex4(l[j] & 0xFFFFu); }
  sha256_compress(out, w);
#pragma unroll
  for (int j = 0; j < 8; ++j) { w[2 * j] = hex4(r[j] >> 16); w[2 * j + 1] = hex4(r[j] & 0xFFFFu); }
  sha256_compress(out, w);
  w[0] = 0x80000000u;
#pragma unroll
  for (int j = 1; j < 15; ++j) w[j] = 0u;
  w[15] = 128u * 8u;  // message length in bits
  sha256_compress(out, w);
}

// A delta-chain link sha256(body || parent) is a 96-byte message in 2
// blocks. Its first block is the body alone, compressed from the initial
// value: it does not depend on the parent, so B2 computes these
// midstates apart from the serial chain.
__device__ __forceinline__ void sha256_body_midstate(uint32_t body[16], uint32_t mid[8]) {
  sha256_init(mid);
  sha256_compress(mid, body);
}

// The link's second block from its body's midstate: 8 parent words and
// 8 constant padding words, whose part of the schedule folds.
__device__ __forceinline__ void sha256_chain_tail(const uint32_t mid[8], const uint32_t parent[8],
                                                  uint32_t out[8]) {
  uint32_t w[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    out[j] = mid[j];
    w[j] = parent[j];
  }
  w[8] = 0x80000000u;
#pragma unroll
  for (int j = 9; j < 15; ++j) w[j] = 0u;
  w[15] = 96u * 8u;
  sha256_compress(out, w);
}

// The current device's SM count, looked up once a device: the launchers
// size their grids by it.
inline cudaError_t sm_count(int* sms) {
  static int cached[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (cached[device] == 0) {
    err = cudaDeviceGetAttribute(&cached[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *sms = cached[device];
  return cudaSuccess;
}

}  // namespace hv
