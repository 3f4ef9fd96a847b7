"""BLS key and signature containers plus the port's backend registry.

A trimmed copy of the JAX package's ``crypto/bls/api.py``: the host-side
containers (compressed bytes + decoded points) and a runtime registry of
verification engines.  The port registers exactly one engine, ``"torch"``
(torch_backend/backend.py), lazily on first ``set_backend("torch")`` so that
importing this module never pulls in torch.

Semantics kept from the reference client:
  * PublicKey rejects the point at infinity (generic_public_key.rs:14-15).
  * Signatures decode without a subgroup check; the check is deferred to
    verification (blst.rs:71-81), where the device batch runs it.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from . import params
from .curve import (
    Fp,
    Fp2,
    G1_GENERATOR,
    affine_mul,
    g1_from_bytes,
    g1_to_bytes,
    g2_from_bytes,
    g2_to_bytes,
)
from .hash_to_curve import hash_to_g2


class BlsError(ValueError):
    pass


class SecretKey:
    __slots__ = ("_sk",)

    def __init__(self, sk: int):
        if not 1 <= sk < params.R:
            raise BlsError("secret key out of range")
        self._sk = sk

    @classmethod
    def random(cls) -> "SecretKey":
        return cls(1 + secrets.randbelow(params.R - 1))

    @classmethod
    def from_bytes(cls, data: bytes) -> "SecretKey":
        if len(data) != params.SCALAR_BYTES:
            raise BlsError("secret key must be 32 bytes")
        return cls(int.from_bytes(data, "big"))

    def to_bytes(self) -> bytes:
        return self._sk.to_bytes(params.SCALAR_BYTES, "big")

    def public_key(self) -> "PublicKey":
        return PublicKey(affine_mul(G1_GENERATOR, self._sk, Fp))

    def sign(self, msg: bytes) -> "Signature":
        return Signature(affine_mul(hash_to_g2(msg), self._sk, Fp2))

    @property
    def int_value(self) -> int:
        return self._sk


class PublicKey:
    """A validated, non-infinity G1 point (decompressed)."""

    __slots__ = ("point",)

    def __init__(self, point):
        if point is None:
            raise BlsError("public key cannot be the point at infinity")
        self.point = point

    @classmethod
    def from_bytes(cls, data: bytes) -> "PublicKey":
        return cls(g1_from_bytes(data, subgroup_check=True))

    def to_bytes(self) -> bytes:
        return g1_to_bytes(self.point)

    def __eq__(self, other):
        return isinstance(other, PublicKey) and self.point == other.point

    def __hash__(self):
        return hash(self.to_bytes())


class Signature:
    """A G2 point or infinity; the subgroup check is deferred to the
    verifying backend."""

    __slots__ = ("point",)

    def __init__(self, point):
        self.point = point

    @classmethod
    def infinity(cls) -> "Signature":
        return cls(None)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Signature":
        return cls(g2_from_bytes(data, subgroup_check=False))

    def to_bytes(self) -> bytes:
        return g2_to_bytes(self.point)

    def is_infinity(self) -> bool:
        return self.point is None

    def __eq__(self, other):
        return isinstance(other, Signature) and self.point == other.point


@dataclass
class SignatureSet:
    """One unit of batch verification: the signature is valid iff it
    verifies against the aggregate of ``signing_keys`` over ``message``
    (generic_signature_set.rs:61-121)."""

    signature: Signature
    signing_keys: list[PublicKey]
    message: bytes

    def verify(self) -> bool:
        return get_backend().verify_signature_sets([self])


_BACKENDS: dict[str, object] = {}
_ACTIVE: list[object] = []


def register_backend(backend) -> None:
    _BACKENDS[backend.name] = backend


def set_backend(name: str) -> None:
    if name == "torch" and name not in _BACKENDS:
        from .torch_backend.backend import register as _register_torch

        _register_torch()
    if name not in _BACKENDS:
        raise KeyError(f"unknown BLS backend {name!r}; have {sorted(_BACKENDS)}")
    _ACTIVE[:] = [_BACKENDS[name]]


def get_backend():
    if not _ACTIVE:
        raise BlsError("no BLS backend selected; call set_backend('torch')")
    return _ACTIVE[0]


# ---------------------------------------------------------------------------
# The free functions of the reference client's ``bls::``, each routed to the
# active backend (crypto/bls/api.py of the JAX package)
# ---------------------------------------------------------------------------


def verify(pubkey: PublicKey, msg: bytes, sig: Signature) -> bool:
    return get_backend().verify(pubkey, msg, sig)


def aggregate_verify(pubkeys, msgs, sig) -> bool:
    return get_backend().aggregate_verify(pubkeys, msgs, sig)


def fast_aggregate_verify(pubkeys, msg, sig) -> bool:
    return get_backend().fast_aggregate_verify(pubkeys, msg, sig)


def eth_fast_aggregate_verify(pubkeys, msg, sig) -> bool:
    """The spec's variant: an infinity signature over no pubkeys is valid
    (sync-committee verification)."""
    if not pubkeys and sig.is_infinity():
        return True
    return fast_aggregate_verify(pubkeys, msg, sig)


def verify_signature_sets(sets: list[SignatureSet]) -> bool:
    return get_backend().verify_signature_sets(sets)
