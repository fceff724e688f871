"""Host runtimes over the device tables (`hypervisor_tpu.runtime`): the
native host runtime (the C++ audit hash unit and the lock-free join
staging queue, `native`), the saga scheduler, the lock and write waves,
device-table checkpointing (`checkpoint`) and the mixed-consistency tick
driver (`consistency`)."""

from hypervisor_tpu_torch.runtime import native
from hypervisor_tpu_torch.runtime.native import (
    StagingQueue,
    chain_digests_host,
    merkle_root_hex_host,
    sha256_batch_host,
    verify_chain_host,
)

__all__ = [
    "HAVE_NATIVE",
    "ConsistencyRuntime",
    "StagingQueue",
    "chain_digests_host",
    "merkle_root_hex_host",
    "restore_state",
    "save_state",
    "sha256_batch_host",
    "verify_chain_host",
]


def __getattr__(name: str):
    # Read through to `native`, whose first read builds the library.
    if name == "HAVE_NATIVE":
        return native.HAVE_NATIVE
    # The checkpoint helpers import HypervisorState (which imports this
    # package): resolve lazily to avoid the cycle.
    if name in ("save_state", "restore_state", "wait_durable", "state_arrays"):
        from hypervisor_tpu_torch.runtime import checkpoint

        return getattr(checkpoint, name)
    if name == "ConsistencyRuntime":
        from hypervisor_tpu_torch.runtime.consistency import ConsistencyRuntime

        return ConsistencyRuntime
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
