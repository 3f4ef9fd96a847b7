"""Observability of the port: the span tracer."""
