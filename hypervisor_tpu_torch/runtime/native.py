"""ctypes bindings for the native host runtime (`csrc/hv_runtime.cpp`,
the port's copy of the reference's `native/hv_runtime.cpp`).

The shared library is built with g++ on first use (the first entry
called, the first `StagingQueue` or the first read of `HAVE_NATIVE`),
through `kernels._build`, into `hypervisor_tpu_torch/_build/
hv_runtime-<hash>.so`. It is a different file from the reference's
library, so ctypes loads it with globals of its own. Exposes:

 - `chain_digests_host` / `verify_chain_host` — binary delta chains
   (device format) computed on the host, for audit verification without a
   device round-trip.
 - `merkle_root_hex_host` — reference-semantics Merkle root.
 - `sha256_batch_host` — one digest per equal-length message.
 - `StagingQueue` — the lock-free admission queue feeding `flush_joins`.

Every entry point has a pure-Python fallback so the package works on a
host with no compiler; `HAVE_NATIVE` reports which path is live.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import threading as _threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_lib: Optional[ctypes.CDLL] = None
_loaded = False
_LOAD_LOCK = _threading.Lock()


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    from hypervisor_tpu_torch.kernels import _build

    return _build._target("hv_runtime")


def _load() -> None:
    """Build and bind the library once; sets `HAVE_NATIVE`."""
    global _lib, _loaded, HAVE_NATIVE
    if _loaded:
        return
    with _LOAD_LOCK:
        if _loaded:
            return
        from hypervisor_tpu_torch.kernels import _build

        try:
            lib = _build.library("hv_runtime")
        except (RuntimeError, OSError) as exc:
            logger.warning("native host runtime not built (%s); using the Python fallback", exc)
            lib = None
        if lib is not None:
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.hv_sha256_batch.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint64, u8p]
            lib.hv_chain_digests.argtypes = [u8p, ctypes.c_uint64, u8p]
            lib.hv_verify_chain.argtypes = [u8p, u8p, ctypes.c_uint64]
            lib.hv_verify_chain.restype = ctypes.c_int64
            lib.hv_merkle_root_hex.argtypes = [u8p, ctypes.c_uint64, u8p, u8p]
            lib.hv_stage_init.argtypes = [
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                u8p,
            ]
            lib.hv_stage_push.argtypes = [
                ctypes.c_float, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint8,
            ]
            lib.hv_stage_push.restype = ctypes.c_int64
            lib.hv_stage_swap.restype = ctypes.c_uint64
        _lib = lib
        HAVE_NATIVE = lib is not None
        _loaded = True


def _native() -> bool:
    """True when the library's entries are live (building it on first
    use); a test may patch `HAVE_NATIVE` off to take the fallback."""
    _load()
    return HAVE_NATIVE


def __getattr__(name: str):
    # `HAVE_NATIVE` is a module global once the first use has built the
    # library; a read before that builds it.
    if name == "HAVE_NATIVE":
        _load()
        return HAVE_NATIVE
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


# ── audit chain (device binary format, ops/merkle.py) ────────────────


def _bodies_to_bytes(bodies_u32: np.ndarray) -> np.ndarray:
    """u32[N, 16] big-endian words -> u8[N, 64]."""
    return np.ascontiguousarray(bodies_u32.astype(">u4")).view(np.uint8).reshape(
        bodies_u32.shape[0], -1
    )


def chain_digests_host(bodies_u32: np.ndarray) -> np.ndarray:
    """u32[N, 16] records -> u8[N, 32] chained digests (host path)."""
    raw = _bodies_to_bytes(bodies_u32)
    n = raw.shape[0]
    out = np.empty((n, 32), np.uint8)
    if _native():
        _lib.hv_chain_digests(_u8(raw), n, _u8(out))
        return out
    parent = b"\x00" * 32
    for i in range(n):
        parent = hashlib.sha256(raw[i].tobytes() + parent).digest()
        out[i] = np.frombuffer(parent, np.uint8)
    return out


def verify_chain_host(bodies_u32: np.ndarray, recorded: np.ndarray) -> int:
    """Return index of first tampered record, or -1 when intact."""
    raw = _bodies_to_bytes(bodies_u32)
    rec = np.ascontiguousarray(recorded.astype(np.uint8))
    n = raw.shape[0]
    if _native():
        return int(_lib.hv_verify_chain(_u8(raw), _u8(rec), n))
    parent = b"\x00" * 32
    for i in range(n):
        digest = hashlib.sha256(raw[i].tobytes() + parent).digest()
        if digest != rec[i].tobytes():
            return i
        parent = digest
    return -1


def merkle_root_hex_host(leaf_digests: np.ndarray) -> str:
    """u8[N, 32] leaves -> hex root (reference hex-pair semantics)."""
    n = leaf_digests.shape[0]
    if n == 0:
        raise ValueError("no leaves")
    leaves = np.ascontiguousarray(leaf_digests.astype(np.uint8))
    if _native():
        scratch = np.empty((n, 32), np.uint8)
        out = np.empty(32, np.uint8)
        _lib.hv_merkle_root_hex(_u8(leaves), n, _u8(scratch), _u8(out))
        return out.tobytes().hex()
    level = [leaves[i].tobytes().hex() for i in range(n)]
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level), 2):
            left = level[i]
            right = level[i + 1] if i + 1 < len(level) else left
            nxt.append(hashlib.sha256((left + right).encode()).hexdigest())
        level = nxt
    return level[0]


def sha256_batch_host(msgs: np.ndarray) -> np.ndarray:
    """u8[N, L] equal-length messages -> u8[N, 32] digests."""
    msgs = np.ascontiguousarray(msgs)
    n, length = msgs.shape
    out = np.empty((n, 32), np.uint8)
    if _native():
        _lib.hv_sha256_batch(_u8(msgs), n, length, _u8(out))
        return out
    for i in range(n):
        out[i] = np.frombuffer(hashlib.sha256(msgs[i].tobytes()).digest(), np.uint8)
    return out


# ── staging queue ────────────────────────────────────────────────────


# The C++ staging buffer is a PROCESS-GLOBAL registration
# (hv_stage_init binds the column pointers the lock-free push writes
# through). Two live StagingQueues would silently write into whichever
# instance registered last — observed as garbage session slots in the
# first state's harvest. Each queue therefore re-binds the native side
# on ownership change; concurrent PUSHES stay lock-free within the
# owning queue, but only ONE queue can be actively staging at a time:
# a handoff with entries still staged raises, and a foreign bind that
# races an in-flight push is detected right after the push. The one
# foreign-bind source is StagingQueue construction (a new
# HypervisorState) — do not construct one while another state's
# producers are mid-push.
_NATIVE_OWNER: "StagingQueue | None" = None
_OWNER_LOCK = _threading.Lock()


class StagingQueue:
    """Lock-free SoA admission queue feeding the batched governance tick.

    Producers (any thread) call `push`; the flush calls `harvest` to get
    the filled columns and reset the epoch. Columns are numpy arrays
    written directly by the native side — they go to the device with no
    packing step.

    Python fallback: plain list appends under the GIL (same API).
    """

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self.sigma = np.zeros(capacity, np.float32)
        self.agent = np.zeros(capacity, np.int32)
        self.session = np.zeros(capacity, np.int32)
        self.trustworthy = np.zeros(capacity, np.uint8)
        self._py_cursor = 0
        # Loss detector: entries staged into the CURRENT native epoch.
        # Guarded by _count_lock so a push landing concurrently with a
        # flush (the supported producer/flusher overlap) is never lost
        # from the count (the Python-side ctypes calls serialize on the
        # GIL anyway, so the lock costs nothing on the hot path).
        self._staged_since_harvest = 0
        self._count_lock = _threading.Lock()
        if _native():
            self._bind()

    def _bind(self) -> None:
        """Register THIS queue's buffers as the native staging target."""
        global _NATIVE_OWNER
        with _OWNER_LOCK:
            _lib.hv_stage_init(
                self.capacity,
                self.sigma.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.agent.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                self.session.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                _u8(self.trustworthy),
            )
            _NATIVE_OWNER = self

    def _lost_error(self) -> RuntimeError:
        return RuntimeError(
            f"{self._staged_since_harvest} staged join(s) lost: another "
            "StagingQueue re-bound the native staging buffer mid-epoch "
            "(interleaved staging across HypervisorState instances is "
            "not supported; acknowledge_lost_epoch() to continue)"
        )

    def _ensure_bound(self) -> None:
        if _NATIVE_OWNER is not self:
            # Another queue (another HypervisorState) bound since we
            # did. If WE still hold staged-but-unharvested entries,
            # their native count is already gone — rebinding here would
            # silently drop them from our next harvest, so fail loudly.
            if self._staged_since_harvest > 0:
                raise self._lost_error()
            self._bind()

    def acknowledge_lost_epoch(self) -> int:
        """Discard the lost-entry count after a 'staged join(s) lost'
        error; returns how many entries were written off. The caller
        owns re-staging them (the bridge keys bookkeeping by agent
        slot, so a re-push is idempotent there)."""
        with self._count_lock:
            lost, self._staged_since_harvest = self._staged_since_harvest, 0
        return lost

    def push(
        self, sigma: float, agent: int, session: int, trustworthy: bool = True
    ) -> int:
        """Claim a slot; returns the slot index or -1 when the epoch is full."""
        if _native():
            self._ensure_bound()
            # Count BEFORE the native push: a concurrent harvest
            # (supported producer/flusher overlap) may swap between the
            # push and any post-hoc increment, and its subtraction must
            # already see this entry counted — otherwise the clamped
            # subtraction leaves a phantom count that later raises a
            # spurious "staged join(s) lost" or skews a real one.
            # Whether the entry lands pre- or post-swap, pre-counting
            # keeps the detector exact; a full epoch (slot < 0) undoes
            # the provisional count below.
            with self._count_lock:
                self._staged_since_harvest += 1
            slot = int(
                _lib.hv_stage_push(sigma, agent, session, 1 if trustworthy else 0)
            )
            if _NATIVE_OWNER is not self:
                # A foreign bind raced this push: the payload may have
                # landed in the OTHER queue's freshly-registered
                # buffers. Unrecoverable from this side — fail loudly
                # (see the module comment's construction rule). The
                # entry is NOT in this queue's buffers, so undo the
                # provisional count: a caller who keeps using this
                # queue after catching must not inherit a phantom.
                with self._count_lock:
                    self._staged_since_harvest -= 1
                raise RuntimeError(
                    "staging push raced a foreign StagingQueue bind; "
                    "constructing a HypervisorState while another "
                    "state's producers are mid-push is not supported"
                )
            if slot < 0:
                with self._count_lock:
                    self._staged_since_harvest -= 1
            return slot
        if self._py_cursor >= self.capacity:
            return -1
        slot = self._py_cursor
        self._py_cursor += 1
        self.sigma[slot] = sigma
        self.agent[slot] = agent
        self.session[slot] = session
        self.trustworthy[slot] = trustworthy
        return slot

    def harvest(self) -> tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(count, sigma, agent, session, trustworthy) views for the tick."""
        if _native():
            self._ensure_bound()
            n = int(_lib.hv_stage_swap())
            if _NATIVE_OWNER is not self:
                # Symmetric with push: a foreign bind racing the swap
                # means n came from the OTHER queue's fresh cursor and
                # our staged entries are uncounted — loud, not partial.
                raise self._lost_error()
            with self._count_lock:
                # Subtract what this swap harvested; pushes that landed
                # AFTER the swap (supported producer/flusher overlap)
                # belong to the new epoch and keep their count. Every
                # entry in n was counted BEFORE its push (see push()),
                # so the subtraction is exact — floored at 0 so the
                # invariant is CHECKED rather than assumed: a foreign-
                # bind race can land an entry in the other queue's
                # buffers uncounted here, and letting the counter go
                # negative would silently absorb (mask) a later genuine
                # one-entry loss from the 'staged join(s) lost' detector.
                self._staged_since_harvest -= n
                if self._staged_since_harvest < 0:
                    logger.warning(
                        "staging harvest drained %d more entr%s than were "
                        "counted as staged (foreign-bind race?); flooring "
                        "the loss detector at 0",
                        -self._staged_since_harvest,
                        "y" if self._staged_since_harvest == -1 else "ies",
                    )
                    self._staged_since_harvest = 0
        else:
            n = self._py_cursor
            self._py_cursor = 0
        return (
            n,
            self.sigma[:n].copy(),
            self.agent[:n].copy(),
            self.session[:n].copy(),
            self.trustworthy[:n].copy(),
        )
