"""Shared numeric/hashing ops used across the framework (host + device)."""

from .sha256 import sha256, sha256_many, sha256_many_vec  # noqa: F401
