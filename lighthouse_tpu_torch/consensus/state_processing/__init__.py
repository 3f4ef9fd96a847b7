"""The state transition (the JAX package's copies) and per-epoch processing
over validator columns on the card (per_epoch_torch.py)."""
