"""Per-epoch state processing over validator columns."""
