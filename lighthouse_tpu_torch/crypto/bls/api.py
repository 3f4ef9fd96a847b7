"""BLS key and signature containers plus the port's backend registry.

The port's copy of the JAX package's ``crypto/bls/api.py``: the host-side
containers (compressed bytes + decoded points), the pure-Python engine
``PythonBackend`` (the scalar oracle: pairing.py), the always-valid
``FakeBackend``, and a runtime registry of verification engines.  ``"python"``
and ``"fake"`` are registered at import; ``"torch"`` (torch_backend/backend.py)
lazily on the first ``set_backend("torch")``, so that importing this module
never pulls in torch.  No engine is active until ``set_backend`` names one:
``cpu_backend()`` is the verifier ladder's CPU rung (beacon/processor.py), not
a default.

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
    affine_add,
    affine_mul,
    affine_neg,
    from_jacobian,
    g1_from_bytes,
    g1_to_bytes,
    g2_from_bytes,
    g2_subgroup_check,
    g2_to_bytes,
    jac_add,
    jac_mul,
    to_jacobian,
)
from .hash_to_curve import hash_to_g2
from .pairing import pairing_check


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


class AggregatePublicKey:
    """Sum of pubkeys; may be infinity (TAggregatePublicKey)."""

    __slots__ = ("point",)

    def __init__(self, point):
        self.point = point

    @classmethod
    def aggregate(cls, pubkeys: list[PublicKey]) -> "AggregatePublicKey":
        if not pubkeys:
            raise BlsError("cannot aggregate an empty pubkey list")
        acc = to_jacobian(None, Fp)
        for pk in pubkeys:
            acc = jac_add(acc, to_jacobian(pk.point, Fp), Fp)
        return cls(from_jacobian(acc, Fp))


class Signature:
    """A G2 point or infinity; the subgroup check is deferred to the
    verifying backend (blst.rs:71-81): the device batch runs it on the card,
    ``subgroup_check`` on the host for the scalar oracle."""

    __slots__ = ("point", "_subgroup_checked")

    def __init__(self, point, subgroup_checked: bool = True):
        self.point = point
        self._subgroup_checked = subgroup_checked

    @classmethod
    def infinity(cls) -> "Signature":
        return cls(None)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Signature":
        return cls(g2_from_bytes(data, subgroup_check=False), subgroup_checked=False)

    def to_bytes(self) -> bytes:
        return g2_to_bytes(self.point)

    def is_infinity(self) -> bool:
        return self.point is None

    def subgroup_check(self) -> bool:
        if self._subgroup_checked:
            return True
        ok = self.point is None or g2_subgroup_check(self.point)
        if ok:
            self._subgroup_checked = True
        return ok

    def __eq__(self, other):
        return isinstance(other, Signature) and self.point == other.point


class AggregateSignature:
    __slots__ = ("signature",)

    def __init__(self, signature: Signature | None = None):
        self.signature = signature if signature is not None else Signature.infinity()

    @classmethod
    def aggregate(cls, signatures: list[Signature]) -> "AggregateSignature":
        if not signatures:
            raise BlsError("cannot aggregate an empty signature list")
        acc = to_jacobian(None, Fp2)
        checked = True
        for s in signatures:
            acc = jac_add(acc, to_jacobian(s.point, Fp2), Fp2)
            checked = checked and s._subgroup_checked
        # checked only if every input was (sums of G2 points stay in G2);
        # otherwise the deferred check still runs at verify time
        return cls(Signature(from_jacobian(acc, Fp2), subgroup_checked=checked))

    def add_assign(self, sig: Signature) -> None:
        pt = affine_add(self.signature.point, sig.point, Fp2)
        checked = self.signature._subgroup_checked and sig._subgroup_checked
        self.signature = Signature(pt, subgroup_checked=checked)

    def to_bytes(self) -> bytes:
        return self.signature.to_bytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "AggregateSignature":
        return cls(Signature.from_bytes(data))


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


# ---------------------------------------------------------------------------
# The host engines (the reference's api.py:243-342)
# ---------------------------------------------------------------------------


class PythonBackend:
    """The CPU oracle: pairing-based, pure Python (pairing.py)."""

    name = "python"

    def verify(self, pubkey: PublicKey, msg: bytes, sig: Signature) -> bool:
        if sig.point is None:
            return False
        if not sig.subgroup_check():
            return False
        h = hash_to_g2(msg)
        return pairing_check([(affine_neg(G1_GENERATOR), sig.point), (pubkey.point, h)])

    def aggregate_verify(self, pubkeys: list[PublicKey], msgs: list[bytes],
                         sig: Signature) -> bool:
        """Distinct-message aggregate verification (blst.rs:244-255)."""
        if not pubkeys or len(pubkeys) != len(msgs):
            return False
        if sig.point is None or not sig.subgroup_check():
            return False
        pairs = [(affine_neg(G1_GENERATOR), sig.point)]
        for pk, m in zip(pubkeys, msgs):
            pairs.append((pk.point, hash_to_g2(m)))
        return pairing_check(pairs)

    def fast_aggregate_verify(self, pubkeys: list[PublicKey], msg: bytes,
                              sig: Signature) -> bool:
        """Same-message aggregate verification (blst.rs:231-242)."""
        if not pubkeys:
            return False
        if sig.point is None or not sig.subgroup_check():
            return False
        agg = AggregatePublicKey.aggregate(pubkeys)
        if agg.point is None:
            return False
        h = hash_to_g2(msg)
        return pairing_check([(affine_neg(G1_GENERATOR), sig.point), (agg.point, h)])

    def verify_signature_sets(self, sets: list[SignatureSet]) -> bool:
        """Random-linear-combination multi-set verification
        (blst.rs:35-117)."""
        if not sets:
            return False
        pairs = []
        sig_acc = to_jacobian(None, Fp2)  # sum of r_i * sig_i
        for s in sets:
            # a nonzero 64-bit random weight per set (blst.rs:52-66)
            r = 0
            while r == 0:
                r = secrets.randbits(params.RAND_BITS)
            if s.signature.point is None:
                return False
            if not s.signature.subgroup_check():
                return False
            if not s.signing_keys:
                return False
            agg = AggregatePublicKey.aggregate(s.signing_keys)
            if agg.point is None:
                return False
            sig_acc = jac_add(sig_acc, jac_mul(to_jacobian(s.signature.point, Fp2), r, Fp2),
                              Fp2)
            pairs.append((affine_mul(agg.point, r, Fp), hash_to_g2(s.message)))
        pairs.append((affine_neg(G1_GENERATOR), from_jacobian(sig_acc, Fp2)))
        return pairing_check(pairs)


class FakeBackend:
    """Always-valid engine for crypto-independent logic tests
    (crypto/bls/src/impls/fake_crypto.rs)."""

    name = "fake"

    def verify(self, pubkey, msg, sig) -> bool:
        return True

    def aggregate_verify(self, pubkeys, msgs, sig) -> bool:
        return True

    def fast_aggregate_verify(self, pubkeys, msg, sig) -> bool:
        return True

    def verify_signature_sets(self, sets) -> bool:
        return True


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


def cpu_backend() -> PythonBackend:
    """The pure-Python engine, whichever engine is active: the CPU rung the
    circuit breaker routes to while the device is failing, and the oracle
    of the integrity layer.  It never becomes the active engine by itself."""
    return _BACKENDS["python"]


register_backend(PythonBackend())
register_backend(FakeBackend())


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
