"""Batched SHA-256 (FIPS 180-4), plain PyTorch.

The counterpart of `hypervisor_tpu.ops.sha256`: messages are pre-padded
big-endian u32 words `[B, n_blocks*16]` (int32 bits, the package's u32
convention) and every lane hashes in parallel. The arithmetic runs in
int64 masked to 32 bits, because torch's CPU uint32 has no add or
shift. This is the plain version the CUDA kernels are held against
(`kernels.mtu`, `kernels.sha256`); bit-identical to `hashlib`.
`sha256_blocks_dispatch` is the batched hash the audit plane calls:
kernel B1 for CUDA tensors, `sha256_blocks` for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from hypervisor_tpu_torch import u32

# Round constants (FIPS 180-4).
_K = np.array(
    [
        0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
        0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
        0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
        0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
        0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
        0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
        0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
        0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
        0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
        0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
        0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
    ],
    dtype=np.uint32,
)

_H0 = np.array(
    [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
     0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19],
    dtype=np.uint32,
)

_M = u32.MASK32


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _M


def _compress(state: list[torch.Tensor], block: list[torch.Tensor]) -> list[torch.Tensor]:
    """One compression over lanes: 8 state and 16 block int64 columns."""
    w = list(block)
    for i in range(16, 64):
        w15, w2 = w[i - 15], w[i - 2]
        s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
        s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & _M)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ _M) & g)
        t1 = (h + s1 + ch + int(_K[i]) + w[i]) & _M
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = s0 + maj
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M, c, b, a, (t1 + t2) & _M
    return [(x + y) & _M for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def sha256_blocks(words: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """Digest pre-padded messages: int32[B, n_blocks*16] -> int32[B, 8]."""
    wide = u32.widen(words)
    state = [torch.full_like(wide[:, 0], int(v)) for v in _H0]
    for blk in range(n_blocks):
        state = _compress(state, [wide[:, blk * 16 + j] for j in range(16)])
    return u32.narrow(torch.stack(state, dim=1))


def sha256_blocks_dispatch(words: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """`sha256_blocks` on the device the words lie on: kernel B1
    (`kernels.sha256.sha256_words`) for CUDA tensors, the plain version
    for CPU tensors."""
    # Imported here: kernels.sha256 imports this module for its plain version.
    from hypervisor_tpu_torch.kernels.sha256 import sha256_words

    return sha256_words(words, n_blocks)


def pad_messages_np(msgs: np.ndarray, msg_len: int) -> tuple[np.ndarray, int]:
    """Host-side FIPS padding for equal-length byte messages:
    u8[B, msg_len] -> (u32[B, n_blocks*16] big-endian words, n_blocks)."""
    b = msgs.shape[0]
    n_blocks = (msg_len + 1 + 8 + 63) // 64
    padded = np.zeros((b, n_blocks * 64), np.uint8)
    padded[:, :msg_len] = msgs
    padded[:, msg_len] = 0x80
    bit_len = np.uint64(msg_len * 8)
    for i in range(8):
        padded[:, -1 - i] = np.uint8((bit_len >> np.uint64(8 * i)) & np.uint64(0xFF))
    words = padded.reshape(b, -1, 4).astype(np.uint32)
    w = words[:, :, 0] << 24 | words[:, :, 1] << 16 | words[:, :, 2] << 8 | words[:, :, 3]
    return w, n_blocks


def pad_tail_words(msg_len: int, n_blocks: int) -> np.ndarray:
    """The constant padding words appended after a msg_len-byte message."""
    w, nb = pad_messages_np(np.zeros((1, msg_len), np.uint8), msg_len)
    if nb != n_blocks:
        raise ValueError(f"{msg_len} bytes pad to {nb} blocks, not {n_blocks}")
    return w[0, msg_len // 4:]


def digests_to_hex(digests) -> list[str]:
    """u32[B, 8] digests (numpy u32, or an int32-bits tensor) -> hex strings."""
    if isinstance(digests, torch.Tensor):
        digests = u32.to_numpy_u32(digests)
    return ["".join(f"{int(x):08x}" for x in row) for row in np.asarray(digests, np.uint32)]


def hex_to_words(hexes: list[str]) -> np.ndarray:
    """64-char hex digests -> u32[B, 8]."""
    return np.array(
        [[int(h[i * 8:(i + 1) * 8], 16) for i in range(8)] for h in hexes],
        dtype=np.uint32,
    )


def _words_to_hex_words(d: torch.Tensor) -> torch.Tensor:
    """int64 u32[B, 8] digest -> int64 u32[B, 16]: the big-endian words
    of its 64-char lowercase ASCII hex (n + 0x30 + (n > 9) * 0x27)."""
    b = d.shape[0]
    shifts = torch.arange(28, -4, -4, device=d.device)
    nibbles = (d[:, :, None] >> shifts[None, None, :]) & 0xF
    chars = (nibbles + 0x30 + (nibbles > 9).to(torch.int64) * 0x27).reshape(b, 16, 4)
    return chars[:, :, 0] << 24 | chars[:, :, 1] << 16 | chars[:, :, 2] << 8 | chars[:, :, 3]


_PAIR_TAIL = pad_tail_words(128, 3)


def hex_pair_message(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """The padded 3-block message hex(left) + hex(right) of int32[B, 8]
    digests: int32[B, 48] words."""
    tail = torch.tensor(_PAIR_TAIL.astype(np.int64), device=left.device)
    msg = torch.cat(
        [
            _words_to_hex_words(u32.widen(left)),
            _words_to_hex_words(u32.widen(right)),
            tail.expand(left.shape[0], tail.shape[0]),
        ],
        dim=1,
    )
    return u32.narrow(msg)


def sha256_hex_pair(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """sha256(hex(left) + hex(right)) on int32[B, 8] digests -> int32[B, 8]:
    the reference's Merkle interior-node combine (128 bytes, 3 blocks),
    through `sha256_blocks_dispatch` (B1 on CUDA)."""
    return sha256_blocks_dispatch(hex_pair_message(left, right), 3)
