// hv_runtime — native host runtime for the TPU-native hypervisor.
//
// The device plane (JAX/XLA/Pallas) owns the batched governance math; this
// library owns the host-side runtime around it:
//
//   1. sha256 / chain / merkle — audit-chain verification and root
//      computation on the host without a device round-trip, bit-compatible
//      with both the reference's hashlib semantics (hex-pair interior
//      nodes, odd-node duplication) and the device binary chain format
//      (ops/merkle.py).
//   2. staging buffer — a lock-free (atomic fetch_add) SoA admission queue
//      that concurrent host threads push governance ops into; the Python
//      driver swaps epochs and hands the filled columns to the jitted tick.
//
// C ABI only (consumed via ctypes; no pybind11 in this image).

#include <atomic>
#include <cstdint>
#include <cstring>

// ──────────────────────────────────────────────────────────────────────
// SHA-256 (FIPS 180-4), scalar host implementation.
// ──────────────────────────────────────────────────────────────────────

namespace {

constexpr uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

struct Sha256 {
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  uint8_t buf[64];
  uint64_t total = 0;
  size_t fill = 0;

  void block(const uint8_t* p) {
    uint32_t w[64];
    for (int i = 0; i < 16; ++i)
      w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
             (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
    for (int i = 16; i < 64; ++i) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
    uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
    for (int i = 0; i < 64; ++i) {
      uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + s1 + ch + K[i] + w[i];
      uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = s0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const uint8_t* data, size_t len) {
    total += len;
    while (len > 0) {
      size_t take = 64 - fill;
      if (take > len) take = len;
      std::memcpy(buf + fill, data, take);
      fill += take;
      data += take;
      len -= take;
      if (fill == 64) { block(buf); fill = 0; }
    }
  }

  void final(uint8_t out[32]) {
    uint64_t bits = total * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero = 0;
    while (fill != 56) update(&zero, 1);
    uint8_t lenb[8];
    for (int i = 0; i < 8; ++i) lenb[i] = uint8_t(bits >> (56 - 8 * i));
    update(lenb, 8);
    for (int i = 0; i < 8; ++i) {
      out[4 * i] = uint8_t(h[i] >> 24);
      out[4 * i + 1] = uint8_t(h[i] >> 16);
      out[4 * i + 2] = uint8_t(h[i] >> 8);
      out[4 * i + 3] = uint8_t(h[i]);
    }
  }
};

void sha256_once(const uint8_t* data, size_t len, uint8_t out[32]) {
  Sha256 s;
  s.update(data, len);
  s.final(out);
}

const char* HEX = "0123456789abcdef";

void to_hex(const uint8_t digest[32], uint8_t hex[64]) {
  for (int i = 0; i < 32; ++i) {
    hex[2 * i] = uint8_t(HEX[digest[i] >> 4]);
    hex[2 * i + 1] = uint8_t(HEX[digest[i] & 0xf]);
  }
}

}  // namespace

extern "C" {

// sha256 of `n` independent equal-length messages (msgs: n*len bytes,
// out: n*32 bytes).
void hv_sha256_batch(const uint8_t* msgs, uint64_t n, uint64_t len,
                     uint8_t* out) {
  for (uint64_t i = 0; i < n; ++i)
    sha256_once(msgs + i * len, len, out + i * 32);
}

// Binary delta chain (device format, ops/merkle.py): digest_i =
// sha256(body_i[64B] || digest_{i-1}[32B]); digest_{-1} = 32 zero bytes.
// bodies: n*64 bytes big-endian-packed records; out: n*32 digests.
void hv_chain_digests(const uint8_t* bodies, uint64_t n, uint8_t* out) {
  uint8_t msg[96];
  std::memset(msg + 64, 0, 32);
  for (uint64_t i = 0; i < n; ++i) {
    std::memcpy(msg, bodies + i * 64, 64);
    if (i > 0) std::memcpy(msg + 64, out + (i - 1) * 32, 32);
    sha256_once(msg, 96, out + i * 32);
  }
}

// Verify the chain: returns index of first mismatch, or -1 when intact.
// recorded: n*32 expected digests.
int64_t hv_verify_chain(const uint8_t* bodies, const uint8_t* recorded,
                        uint64_t n) {
  uint8_t msg[96];
  uint8_t digest[32];
  std::memset(msg + 64, 0, 32);
  for (uint64_t i = 0; i < n; ++i) {
    std::memcpy(msg, bodies + i * 64, 64);
    if (i > 0) std::memcpy(msg + 64, recorded + (i - 1) * 32, 32);
    sha256_once(msg, 96, digest);
    if (std::memcmp(digest, recorded + i * 32, 32) != 0) return int64_t(i);
  }
  return -1;
}

// Merkle root over n leaf digests with the reference's semantics: interior
// node = sha256(ascii_hex(left) || ascii_hex(right)), odd node duplicated
// per level (audit/delta.py:117-134). leaves: n*32; out: 32.
// scratch must hold n*32 bytes (caller-allocated; copied from leaves).
void hv_merkle_root_hex(const uint8_t* leaves, uint64_t n, uint8_t* scratch,
                        uint8_t* out) {
  if (n == 0) return;
  std::memcpy(scratch, leaves, n * 32);
  uint8_t msg[128];
  while (n > 1) {
    uint64_t m = (n + 1) / 2;
    for (uint64_t i = 0; i < m; ++i) {
      const uint8_t* left = scratch + (2 * i) * 32;
      const uint8_t* right =
          (2 * i + 1 < n) ? scratch + (2 * i + 1) * 32 : left;
      to_hex(left, msg);
      to_hex(right, msg + 64);
      sha256_once(msg, 128, scratch + i * 32);
    }
    n = m;
  }
  std::memcpy(out, scratch, 32);
}

// ──────────────────────────────────────────────────────────────────────
// Staging buffer: lock-free SoA admission queue for the batched tick.
// ──────────────────────────────────────────────────────────────────────
//
// Concurrent producers call hv_stage_push (atomic slot claim + column
// writes); the tick driver calls hv_stage_swap to harvest the epoch.
// Columns are caller-owned (numpy) so the harvested arrays feed the jitted
// pipeline with zero copies.

struct StagingBuffer {
  std::atomic<uint64_t> cursor{0};
  uint64_t capacity = 0;
  float* sigma = nullptr;        // f32[capacity]
  int32_t* agent = nullptr;      // i32[capacity]
  int32_t* session = nullptr;    // i32[capacity]
  uint8_t* trustworthy = nullptr;  // u8[capacity]
};

static StagingBuffer g_stage;

void hv_stage_init(uint64_t capacity, float* sigma, int32_t* agent,
                   int32_t* session, uint8_t* trustworthy) {
  g_stage.cursor.store(0, std::memory_order_relaxed);
  g_stage.capacity = capacity;
  g_stage.sigma = sigma;
  g_stage.agent = agent;
  g_stage.session = session;
  g_stage.trustworthy = trustworthy;
}

// Returns the claimed slot, or -1 when the epoch is full.
int64_t hv_stage_push(float sigma, int32_t agent, int32_t session,
                      uint8_t trustworthy) {
  uint64_t slot = g_stage.cursor.fetch_add(1, std::memory_order_relaxed);
  if (slot >= g_stage.capacity) return -1;
  g_stage.sigma[slot] = sigma;
  g_stage.agent[slot] = agent;
  g_stage.session[slot] = session;
  g_stage.trustworthy[slot] = trustworthy;
  return int64_t(slot);
}

// Harvest: returns number of valid rows and resets the cursor for the next
// epoch (caller must have swapped the column arrays first via
// hv_stage_init when double-buffering).
uint64_t hv_stage_swap() {
  uint64_t filled = g_stage.cursor.exchange(0, std::memory_order_acq_rel);
  return filled < g_stage.capacity ? filled : g_stage.capacity;
}

}  // extern "C"
