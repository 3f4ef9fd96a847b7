"""Host-side utilities of the port (the fault injector, the ingest metrics)."""
