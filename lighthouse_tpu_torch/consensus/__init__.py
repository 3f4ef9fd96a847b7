"""The consensus layer of the port: the copies of the JAX package's SSZ,
containers, presets, fork choice and state transition, and the device epoch
balance pipeline (state_processing/per_epoch_torch.py)."""
