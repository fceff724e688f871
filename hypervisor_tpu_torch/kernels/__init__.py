"""The port's hand-written Hopper kernels and their wrappers.

Each wrapper launches its CUDA kernel for CUDA tensors, takes the plain
PyTorch version beside it for CPU tensors, and raises for anything else;
it never falls back from a failed launch. Each counts its launches in a
plain integer attribute (`wrapper.launches`), so a run can show that the
main path went through the kernel.

  B2 `mtu.chain_digests`      <- hypervisor_tpu/kernels/mtu_pallas.py chain_digests_mtu
  B3 `mtu.tree_roots`         <- hypervisor_tpu/kernels/mtu_pallas.py tree_roots
  B4 `wave.admission_block`   <- hypervisor_tpu/kernels/wave_pallas.py admission_block_pallas
  B5 `wave.fsm_saga_block`    <- hypervisor_tpu/kernels/wave_pallas.py fsm_saga_block_pallas
  B6 `mtu.chain_digests_ring` <- hypervisor_tpu/kernels/wave_pallas.py ring_append_pallas
                                 (B2's ring form: the chain and the DeltaLog append in one launch)
  B1 `sha256.sha256_words`    <- hypervisor_tpu/kernels/sha256_pallas.py sha256_words
  B7 `saga.saga_tick_block`   <- hypervisor_tpu/kernels/wave_pallas.py saga_tick_block_pallas
  B8 `liability.slash_cascade` <- hypervisor_tpu/kernels/liability_pallas.py slash_cascade_pallas
  `wave.contribution_toward`  <- hypervisor_tpu/ops/liability.py contribution_toward
                                 (an XLA scatter-add there, no Pallas kernel)

The tenant forms serve T tenants' waves in the launches the solo form
takes for one (the reference's `jax.vmap` of its wave puts the tenant
axis on each Pallas grid):

  `wave.contribution_toward_tenants`, `wave.admission_block_tenants` (B4),
  `wave.fsm_saga_block_tenants` (B5), `mtu.chain_digests_ring_tenants`
  (B2's ring form, with B6's append); B3 takes the T x K lanes flat.
"""

from __future__ import annotations

from hypervisor_tpu_torch.kernels import liability, mtu, saga, sha256, wave

WRAPPERS = {
    "contribution_toward": wave.contribution_toward,
    "chain_digests": mtu.chain_digests,
    "tree_roots": mtu.tree_roots,
    "admission_block": wave.admission_block,
    "fsm_saga_block": wave.fsm_saga_block,
    "chain_digests_ring": mtu.chain_digests_ring,
    "sha256_words": sha256.sha256_words,
    "saga_tick_block": saga.saga_tick_block,
    "slash_cascade": liability.slash_cascade,
    "contribution_toward_tenants": wave.contribution_toward_tenants,
    "admission_block_tenants": wave.admission_block_tenants,
    "fsm_saga_block_tenants": wave.fsm_saga_block_tenants,
    "chain_digests_ring_tenants": mtu.chain_digests_ring_tenants,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
