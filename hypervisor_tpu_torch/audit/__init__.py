"""The audit plane's host side (`hypervisor_tpu.audit`)."""
