"""One reader a per-layer metric: `read(trace) -> float | None` takes the
metric from a traced run (`hvbench.trace.TraceData`) and returns None
where it finds nothing to read."""
