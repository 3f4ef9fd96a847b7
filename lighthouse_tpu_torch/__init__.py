"""PyTorch/CUDA port of lighthouse_tpu's BLS batch-verification path.

The JAX package ``lighthouse_tpu`` stays the reference; this package imports
nothing from it (and never imports jax).  Layout mirrors the JAX package:
``crypto/bls/`` holds the host-side oracle modules and the API, and
``crypto/bls/torch_backend/`` the batched limb arithmetic and its hand-written
CUDA kernels (sources under ``csrc/``, built with nvcc at first use into the
git-ignored ``_build/``).
"""
