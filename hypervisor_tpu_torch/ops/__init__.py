"""Batched governance ops on tensors (counterparts of `hypervisor_tpu.ops`)."""
