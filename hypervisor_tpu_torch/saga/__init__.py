"""Saga definitions: the state machines, fan-out policies and the DSL
(`hypervisor_tpu.saga`, without the host orchestrators)."""
