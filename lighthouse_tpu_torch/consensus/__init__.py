"""The consensus layer of the port: the device epoch balance pipeline."""
