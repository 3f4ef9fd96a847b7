"""Batched BLS12-381 verification on PyTorch tensors, with hand-written CUDA
kernels for the Montgomery product and the fused Miller steps."""
