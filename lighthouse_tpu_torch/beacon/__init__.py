"""The beacon node's layers of the port: the work queues and the verifier
ladder (processor.py), and the copies of the JAX package's chain engine,
harness, pools, sync, simulator and their services."""
