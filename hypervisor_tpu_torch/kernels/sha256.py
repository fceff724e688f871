"""The audit plane's batched hash on Hopper: kernel B1 `sha256_words`.

B1 replaces `hypervisor_tpu/kernels/sha256_pallas.py` `sha256_words`:
FIPS 180-4 SHA-256 over pre-padded big-endian u32[B, nb*16] words (int32
bits here) -> u32[B, 8] digests. The scrubber's chain-link strips
(nb = 2), verify's links and the hex-pair levels of Merkle trees above
the tree kernel's 4096 leaves (nb = 3) run through it. Each message's
hash stays in one thread's registers (`csrc/sha256.cuh`'s unrolled
compression), the block loop rolled. At the scrubber's 4,096 messages
an SMSP holds one warp, so the time is that thread's serial path: the
next block's four 16-byte loads are issued before the current block's
rounds, so only the first block waits on memory, and a strip shorter
than 128 messages an SM runs in blocks of whole warps spread over the
SMs. At 30,000 messages it is bound by integer instructions (about
1,350 a compression against 64 bytes read). The TPU's 1024-message
tiling and padding are not carried over: any B runs.

Source: `csrc/sha256.cu`. The plain version is the port's
`ops.sha256.sha256_blocks`.
"""

from __future__ import annotations

import ctypes

import torch

from hypervisor_tpu_torch.kernels import _build
from hypervisor_tpu_torch.kernels.mtu import _check_operand, _require, _route
from hypervisor_tpu_torch.ops.sha256 import sha256_blocks

_P, _I = ctypes.c_void_p, ctypes.c_int

#: Plain version of B1: what CPU tensors run and the kernel is held against.
sha256_words_plain = sha256_blocks


def sha256_words(words: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """B1: int32[B, n_blocks*16] pre-padded words -> int32[B, 8] digests.
    CUDA tensors launch the kernel; CPU tensors take `sha256_words_plain`."""
    _require(words.dim() == 2 and words.shape[1] == 16 * n_blocks and n_blocks > 0,
             "words: [B, n_blocks*16]")
    if not _route(words):
        return sha256_words_plain(words, n_blocks)
    _check_operand(words, "words", torch.int32, words.device, align=16)
    b = words.shape[0]
    out = torch.empty((b, 8), dtype=torch.int32, device=words.device)
    if b == 0:
        return out  # nothing to launch
    fn = _build.entry("sha256", "hv_sha256_words", [_P, _P, _I, _I, _P])
    err = fn(words.data_ptr(), out.data_ptr(), b, n_blocks,
             torch.cuda.current_stream(words.device).cuda_stream)
    _build.check("sha256", err, "sha256_words")
    sha256_words.launches += 1
    return out


sha256_words.launches = 0
