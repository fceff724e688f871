"""Host milliseconds a call in the harness's `tenant_sync` span
(`TenantArena.sync`: the commit of every tenant's lent and rebound
tables, run before the batched session create and before the batched
wave), over the measured window."""


def read(t):
    total = t.spans_ms.get("tenant_sync")
    return None if total is None or not t.calls_ms else total / len(t.calls_ms)
