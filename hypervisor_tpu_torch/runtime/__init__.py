"""Host runtimes over the device tables (`hypervisor_tpu.runtime`): the
saga scheduler and the join staging queue."""
