"""State integrity (`hypervisor_tpu.integrity`): the Merkle scrubber and
the invariant sanitizer."""
