"""Observability of the port: the span tracer, the scrape endpoint (http.py)
and the stage-attribution math (report.py)."""
