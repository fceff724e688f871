"""Observability plane (the metrics table's layout, for now)."""
