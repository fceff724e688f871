"""Observability plane: the metrics table's layout, causal trace ids and the
flight recorder (`tracing`)."""
