"""Host runtimes over the device tables (`hypervisor_tpu.runtime`): the
native host runtime (the C++ audit hash unit and the lock-free join
staging queue, `native`), the saga scheduler, and the lock and write
waves."""

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
    "StagingQueue",
    "chain_digests_host",
    "merkle_root_hex_host",
    "sha256_batch_host",
    "verify_chain_host",
]


def __getattr__(name: str):
    # Read through to `native`, whose first read builds the library.
    if name == "HAVE_NATIVE":
        return native.HAVE_NATIVE
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
