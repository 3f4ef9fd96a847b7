"""The beacon node's scheduling layer of the port: the work queues and the
verifier ladder (processor.py)."""
