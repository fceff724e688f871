"""Delta audit engine: Merkle-chained semantic deltas over VFS changes.

Capability parity with reference `audit/delta.py:67-160`: per-turn capture
with parent-hash chaining, canonical JSON payload hashing (sorted keys, same
field set — the hex chain format is an interchange format, kept
bit-compatible), bottom-up Merkle root with odd-node duplication, and full
chain verification.

The port's copy of `hypervisor_tpu.audit.delta`. One function differs:
`merkle_root_device` runs the port's `ops.merkle.merkle_root_lanes` on
an explicit torch device: kernel B3 (one tree launch) up to 4,096 leaves
and B1 level by level above it on CUDA, their plain versions on the CPU.
The engine takes the device at construction (`ManagedSession` hands it
the state's) and uses it from `_DEVICE_ROOT_THRESHOLD` deltas.
`merkle_root_native` runs the port's C++ tree build
(`runtime.native.merkle_root_hex_host`), or the hashlib loop where the
library did not build.

All three builders return the same root for the same hashes.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from datetime import datetime, timedelta
from typing import Callable, Optional

from hypervisor_tpu_torch.utils.clock import Clock, utc_now

# Below this many deltas the host loop beats device dispatch latency.
_DEVICE_ROOT_THRESHOLD = 64
# From this many deltas the C++ tree builder beats the Python loop
# (one ctypes call vs 2N hashlib calls + string concats).
_NATIVE_ROOT_THRESHOLD = 8


@dataclass
class VFSChange:
    """One VFS mutation inside a delta."""

    path: str
    operation: str  # "add" | "modify" | "delete" | "permission"
    content_hash: Optional[str] = None
    previous_hash: Optional[str] = None
    agent_did: Optional[str] = None


@dataclass
class SemanticDelta:
    """One turn's change set, hash-chained to its parent."""

    delta_id: str
    turn_id: int
    session_id: str
    agent_did: str
    timestamp: datetime
    changes: list[VFSChange]
    parent_hash: Optional[str]
    delta_hash: str = ""

    def canonical_payload(self) -> str:
        """Canonical JSON the hash covers (field set per `audit/delta.py:41-62`)."""
        return json.dumps(
            {
                "delta_id": self.delta_id,
                "turn_id": self.turn_id,
                "session_id": self.session_id,
                "agent_did": self.agent_did,
                "timestamp": self.timestamp.isoformat(),
                "changes": [
                    {
                        "path": c.path,
                        "operation": c.operation,
                        "content_hash": c.content_hash,
                        "previous_hash": c.previous_hash,
                    }
                    for c in self.changes
                ],
                "parent_hash": self.parent_hash,
            },
            sort_keys=True,
        )

    def compute_hash(self) -> str:
        self.delta_hash = hashlib.sha256(self.canonical_payload().encode()).hexdigest()
        return self.delta_hash


def merkle_root_host(hashes: list[str]) -> str:
    """Host tree build: pairwise sha256(hexL+hexR), odd node duplicated."""
    level = list(hashes)
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level), 2):
            left = level[i]
            right = level[i + 1] if i + 1 < len(level) else left
            nxt.append(hashlib.sha256((left + right).encode()).hexdigest())
        level = nxt
    return level[0]


def merkle_root_native(hashes: list[str]) -> str:
    """C++ tree build (`csrc/hv_runtime.cpp`), Python-loop fallback.

    Same hex-pair semantics as `merkle_root_host`.
    """
    from hypervisor_tpu_torch.runtime import native

    if not native.HAVE_NATIVE:
        return merkle_root_host(hashes)
    import numpy as np

    leaves = np.frombuffer(bytes.fromhex("".join(hashes)), np.uint8).reshape(-1, 32)
    return native.merkle_root_hex_host(leaves)


def merkle_root_device(hashes: list[str], device="cuda") -> str:
    """Device tree build on `device` (B3, or B1 level by level above 4,096
    leaves, on CUDA; their plain versions on the CPU); bit-identical to
    `merkle_root_host`."""
    import numpy as np

    from hypervisor_tpu_torch import resolve_device, u32
    from hypervisor_tpu_torch.ops import merkle as merkle_ops
    from hypervisor_tpu_torch.ops import sha256 as sha_ops

    n = len(hashes)
    p = 1 << max(0, (n - 1).bit_length())
    leaves = np.zeros((1, max(p, 1), 8), np.uint32)
    leaves[0, :n] = sha_ops.hex_to_words(hashes)
    root = merkle_ops.merkle_root_lanes(
        u32.from_numpy_u32(leaves, resolve_device(device)), n
    )
    return sha_ops.digests_to_hex(root)[0]


class DeltaEngine:
    """Session-scoped Merkle-chained delta log.

    `sink`, when given, receives every captured delta — the facade wires
    it to `HypervisorState.stage_delta` so the device DeltaLog records
    the same leaves as this host chain (shared Merkle trees).
    `tensor_device` is where the device root runs ("cuda" by default; it
    raises there without CUDA, and only when a root takes that path).
    """

    def __init__(
        self,
        session_id: str,
        clock: Clock = utc_now,
        sink: Optional[Callable[["SemanticDelta"], None]] = None,
        tensor_device="cuda",
    ) -> None:
        self.session_id = session_id
        self._clock = clock
        self._sink = sink
        self.tensor_device = tensor_device
        self._deltas: list[SemanticDelta] = []
        self._turns = 0

    def capture(
        self,
        agent_did: str,
        changes: list[VFSChange],
        delta_id: Optional[str] = None,
    ) -> SemanticDelta:
        """Append one turn's delta, chaining it to the previous delta's hash."""
        self._turns += 1
        delta = SemanticDelta(
            delta_id=delta_id or f"delta:{self._turns}",
            turn_id=self._turns,
            session_id=self.session_id,
            agent_did=agent_did,
            timestamp=self._clock(),
            changes=changes,
            parent_hash=self._deltas[-1].delta_hash if self._deltas else None,
        )
        delta.compute_hash()
        self._deltas.append(delta)
        if self._sink is not None:
            self._sink(delta)
        return delta

    def compute_merkle_root(self, device: Optional[bool] = None) -> Optional[str]:
        """Merkle root over the chain; None when empty.

        device=None auto-selects: host loop for short chains, device tree op
        beyond the dispatch-amortization threshold.
        """
        if not self._deltas:
            return None
        hashes = [d.delta_hash for d in self._deltas]
        if device is None:
            device = len(hashes) >= _DEVICE_ROOT_THRESHOLD
        if device:
            return merkle_root_device(hashes, self.tensor_device)
        if len(hashes) >= _NATIVE_ROOT_THRESHOLD:
            return merkle_root_native(hashes)
        return merkle_root_host(hashes)

    def verify_chain(self) -> bool:
        """Recompute every hash and parent link; False on any tamper.

        Side-effect free (unlike the reference, whose recompute overwrites
        the stored hash and thus cannot catch a content-tampered tail delta).
        """
        previous_hash: Optional[str] = None
        for delta in self._deltas:
            recomputed = hashlib.sha256(delta.canonical_payload().encode()).hexdigest()
            if delta.delta_hash != recomputed:
                return False
            if delta.parent_hash != previous_hash:
                return False
            previous_hash = recomputed
        return True

    def prune_expired(self, retention_days: int) -> int:
        """Drop deltas older than the retention window (GC hook)."""
        cutoff = self._clock() - timedelta(days=retention_days)
        keep = [d for d in self._deltas if d.timestamp >= cutoff]
        dropped = len(self._deltas) - len(keep)
        self._deltas = keep
        return dropped

    @property
    def deltas(self) -> list[SemanticDelta]:
        return list(self._deltas)

    @property
    def turn_count(self) -> int:
        return self._turns
