"""KZG commitments for Deneb blobs — verification on the shared pairing core.

Capability twin of crypto/kzg (which wraps the C library c-kzg-4844;
`Kzg` holds the setup at src/lib.rs:30-45) and of the beacon chain's blob
gate `verify_blob_kzg_proof_batch` (beacon_node/beacon_chain/src/
kzg_utils.rs:23-35).  Unlike the reference this is NOT a foreign-library
wrapper: proofs verify through the same BLS12-381 pairing stack the
signature path uses (CPU oracle today, the batched JAX Miller loop as the
device path), so blob batches and signature batches share one crypto core.

Implements the deneb polynomial-commitments spec: blob->polynomial in
evaluation form over bit-reversed roots of unity, Fiat-Shamir challenges,
barycentric evaluation, single + batch proof verification (random linear
combination -> ONE pairing check), and proving (commitment/proof
computation) — instant with a dev setup's known tau, MSM over the Lagrange
setup otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..bls.curve import (
    Fp,
    G1_GENERATOR,
    affine_mul,
    affine_neg,
    from_jacobian,
    g1_from_bytes,
    g1_to_bytes,
    jac_add,
    to_jacobian,
)
from ..bls.curve import G2_GENERATOR
from ..bls.fields import Fp2
from ..bls.pairing import pairing_check
from . import fr
from .fr import BLS_MODULUS

FIELD_ELEMENTS_PER_BLOB = 4096
BYTES_PER_FIELD_ELEMENT = 32
BYTES_PER_BLOB = FIELD_ELEMENTS_PER_BLOB * BYTES_PER_FIELD_ELEMENT
FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"  # 16 bytes, deneb spec
RANDOM_CHALLENGE_KZG_BATCH_DOMAIN = b"RCKZGBATCH___V1_"  # 16 bytes
ENDIANNESS = "big"


class KzgError(ValueError):
    pass


def _hash(data: bytes) -> bytes:
    from ...ops import sha256

    return sha256(data)


def hash_to_bls_field(data: bytes) -> int:
    return int.from_bytes(_hash(data), ENDIANNESS) % BLS_MODULUS


def bytes_to_bls_field(b: bytes) -> int:
    x = int.from_bytes(b, ENDIANNESS)
    if x >= BLS_MODULUS:
        raise KzgError("field element not canonical")
    return x


def blob_to_polynomial(blob: bytes) -> list[int]:
    if len(blob) != BYTES_PER_BLOB:
        raise KzgError(f"blob must be {BYTES_PER_BLOB} bytes")
    return [
        bytes_to_bls_field(blob[i * 32 : (i + 1) * 32])
        for i in range(FIELD_ELEMENTS_PER_BLOB)
    ]


# ---------------------------------------------------------------------------
# Trusted setup
# ---------------------------------------------------------------------------


@dataclass
class TrustedSetup:
    """g1_lagrange: 4096 affine G1 points (evaluation form, bit-reversed
    roots); g2_monomial: [G2, tau*G2, ...]; dev_tau set only for the
    insecure dev setup (enables O(1) proving in tests)."""

    g1_lagrange: list
    g2_monomial: list
    dev_tau: int | None = None

    @classmethod
    def load_mainnet(cls) -> "TrustedSetup":
        """The public KZG ceremony output (converted by
        tools/convert_trusted_setup.py; same constant the reference embeds
        via eth2_network_config)."""
        import os

        import numpy as np

        path = os.path.join(os.path.dirname(__file__), "trusted_setup.npz")
        data = np.load(path)
        g1 = [
            (
                Fp(int.from_bytes(bytes(row[0]), "big")),
                Fp(int.from_bytes(bytes(row[1]), "big")),
            )
            for row in data["g1_lagrange"]
        ]
        g2 = [
            (
                Fp2(
                    int.from_bytes(bytes(row[0]), "big"),
                    int.from_bytes(bytes(row[1]), "big"),
                ),
                Fp2(
                    int.from_bytes(bytes(row[2]), "big"),
                    int.from_bytes(bytes(row[3]), "big"),
                ),
            )
            for row in data["g2_monomial"]
        ]
        return cls(g1_lagrange=g1, g2_monomial=g2)

    @classmethod
    def dev(cls, tau: int = 0x1234_5678_9ABC_DEF0_1357) -> "TrustedSetup":
        """INSECURE known-tau setup for tests (the c-kzg test pattern):
        Lagrange G1 points are [l_i(tau)]G1 over the bit-reversed roots."""
        tau %= BLS_MODULUS
        roots = fr.brp_roots_of_unity(FIELD_ELEMENTS_PER_BLOB)
        # l_i(tau) = (tau^N - 1) / (N * (tau - w_i)) * w_i
        n = FIELD_ELEMENTS_PER_BLOB
        tn = (pow(tau, n, BLS_MODULUS) - 1) % BLS_MODULUS
        lag = [
            tn * w % BLS_MODULUS * fr.inv(n * ((tau - w) % BLS_MODULUS))
            % BLS_MODULUS
            for w in roots
        ]
        g1 = [affine_mul(G1_GENERATOR, l, Fp) for l in lag]
        g2 = [G2_GENERATOR, affine_mul(G2_GENERATOR, tau, Fp2)]
        return cls(g1_lagrange=g1, g2_monomial=g2, dev_tau=tau)


_MAINNET: TrustedSetup | None = None


def mainnet_setup() -> TrustedSetup:
    global _MAINNET
    if _MAINNET is None:
        _MAINNET = TrustedSetup.load_mainnet()
    return _MAINNET


_DEV: TrustedSetup | None = None


def dev_setup() -> TrustedSetup:
    """Process-cached known-tau setup (building the 4096 Lagrange points
    takes ~25 s; every test consumer shares one)."""
    global _DEV
    if _DEV is None:
        _DEV = TrustedSetup.dev()
    return _DEV


# ---------------------------------------------------------------------------
# Polynomial evaluation
# ---------------------------------------------------------------------------


def evaluate_polynomial_in_evaluation_form(poly: list[int], z: int) -> int:
    """Barycentric formula over the bit-reversed roots (spec
    evaluate_polynomial_in_evaluation_form).  The 4096 denominators are
    inverted with ONE Montgomery batch inversion instead of per-term
    Fermat exponentiations (the dominant cost otherwise)."""
    width = len(poly)
    roots = fr.brp_roots_of_unity(width)
    if z in roots:
        return poly[roots.index(z)]
    denoms = [(z - w_i) % BLS_MODULUS for w_i in roots]
    inv_denoms = fr.batch_inv(denoms)
    total = 0
    for p_i, w_i, d_i in zip(poly, roots, inv_denoms):
        total = (total + p_i * w_i % BLS_MODULUS * d_i) % BLS_MODULUS
    zn = (pow(z, width, BLS_MODULUS) - 1) % BLS_MODULUS
    return total * zn % BLS_MODULUS * fr.inv(width) % BLS_MODULUS


def compute_challenge(blob: bytes, commitment: bytes) -> int:
    degree = FIELD_ELEMENTS_PER_BLOB.to_bytes(16, ENDIANNESS)
    return hash_to_bls_field(
        FIAT_SHAMIR_PROTOCOL_DOMAIN + degree + blob + commitment
    )


# ---------------------------------------------------------------------------
# Group helpers
# ---------------------------------------------------------------------------


def g1_lincomb(points: list, scalars: list[int]):
    """MSM: sum scalar_i * P_i (Jacobian accumulation)."""
    acc = to_jacobian(None, Fp)
    for pt, s in zip(points, scalars):
        s %= BLS_MODULUS
        if s == 0 or pt is None:
            continue
        term = affine_mul(pt, s, Fp)
        if term is not None:
            acc = jac_add(acc, to_jacobian(term, Fp), Fp)
    return from_jacobian(acc, Fp)


def _g1_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return from_jacobian(jac_add(to_jacobian(a, Fp), to_jacobian(b, Fp), Fp), Fp)



# ---------------------------------------------------------------------------
# Commit / prove
# ---------------------------------------------------------------------------


def blob_to_kzg_commitment(blob: bytes, setup: TrustedSetup) -> bytes:
    poly = blob_to_polynomial(blob)
    if setup.dev_tau is not None:
        y = evaluate_polynomial_in_evaluation_form(poly, setup.dev_tau)
        pt = affine_mul(G1_GENERATOR, y, Fp)
        return g1_to_bytes(pt)
    return g1_to_bytes(g1_lincomb(setup.g1_lagrange, poly))


def compute_kzg_proof_impl(
    poly: list[int], z: int, setup: TrustedSetup
) -> tuple[bytes, int]:
    """Returns (proof, y).  Quotient in evaluation form per spec
    compute_kzg_proof_impl (incl. the on-root special case)."""
    width = len(poly)
    roots = fr.brp_roots_of_unity(width)
    y = evaluate_polynomial_in_evaluation_form(poly, z)
    if setup.dev_tau is not None:
        tau = setup.dev_tau
        w = fr.div(
            (evaluate_polynomial_in_evaluation_form(poly, tau) - y) % BLS_MODULUS,
            (tau - z) % BLS_MODULUS,
        )
        return g1_to_bytes(affine_mul(G1_GENERATOR, w, Fp)), y
    quotient = [0] * width
    for i, (p_i, w_i) in enumerate(zip(poly, roots)):
        if w_i == z:
            continue
        quotient[i] = fr.div((p_i - y) % BLS_MODULUS, (w_i - z) % BLS_MODULUS)
    if z in roots:
        m = roots.index(z)
        for i, w_i in enumerate(roots):
            if i == m:
                continue
            quotient[m] = (
                quotient[m]
                + (poly[i] - y)
                * w_i
                % BLS_MODULUS
                * fr.inv(z * ((z - w_i) % BLS_MODULUS) % BLS_MODULUS)
            ) % BLS_MODULUS
    return g1_to_bytes(g1_lincomb(setup.g1_lagrange, quotient)), y


def compute_blob_kzg_proof(
    blob: bytes, commitment: bytes, setup: TrustedSetup
) -> bytes:
    z = compute_challenge(blob, commitment)
    proof, _ = compute_kzg_proof_impl(blob_to_polynomial(blob), z, setup)
    return proof


# ---------------------------------------------------------------------------
# Verify
# ---------------------------------------------------------------------------


def _decode_g1(b: bytes, what: str):
    try:
        pt = g1_from_bytes(bytes(b), subgroup_check=True)
    except Exception as e:
        raise KzgError(f"invalid {what}: {e}") from None
    return pt  # None = infinity (valid encoding: commitment to zero poly)


def verify_kzg_proof_impl(
    commitment: bytes, z: int, y: int, proof: bytes, setup: TrustedSetup
) -> bool:
    """e(P - [y]G1, -G2) * e(W, [tau - z]G2) == 1."""
    P = _decode_g1(commitment, "commitment")
    W = _decode_g1(proof, "proof")
    tau_g2 = setup.g2_monomial[1]
    z_g2 = affine_mul(G2_GENERATOR, z % BLS_MODULUS, Fp2)
    x_minus_z = from_jacobian(
        jac_add(
            to_jacobian(tau_g2, Fp2),
            to_jacobian(affine_neg(z_g2) if z_g2 else None, Fp2),
            Fp2,
        ),
        Fp2,
    )
    y_g1 = affine_mul(G1_GENERATOR, y % BLS_MODULUS, Fp) if y else None
    p_minus_y = _g1_add(P, affine_neg(y_g1) if y_g1 else None)
    pairs = []
    if p_minus_y is not None:
        pairs.append((p_minus_y, affine_neg(G2_GENERATOR)))
    if W is not None and x_minus_z is not None:
        pairs.append((W, x_minus_z))
    if not pairs:
        return True
    return pairing_check(pairs)


def verify_blob_kzg_proof(
    blob: bytes, commitment: bytes, proof: bytes, setup: TrustedSetup | None = None
) -> bool:
    setup = setup or mainnet_setup()
    z = compute_challenge(blob, commitment)
    poly = blob_to_polynomial(blob)
    y = evaluate_polynomial_in_evaluation_form(poly, z)
    return verify_kzg_proof_impl(commitment, z, y, proof, setup)


def verify_blob_kzg_proof_batch(
    blobs: list[bytes],
    commitments: list[bytes],
    proofs: list[bytes],
    setup: TrustedSetup | None = None,
) -> bool:
    """kzg_utils.rs:23-35 semantics: one random-linear-combination pairing
    check for the whole sidecar batch."""
    setup = setup or mainnet_setup()
    if not (len(blobs) == len(commitments) == len(proofs)):
        raise KzgError("length mismatch")
    if not blobs:
        return True
    zs, ys = [], []
    for blob, c in zip(blobs, commitments):
        z = compute_challenge(blob, bytes(c))
        zs.append(z)
        ys.append(
            evaluate_polynomial_in_evaluation_form(blob_to_polynomial(blob), z)
        )
    return verify_kzg_proof_batch(
        [bytes(c) for c in commitments], zs, ys, [bytes(p) for p in proofs], setup
    )


def verify_kzg_proof_batch(
    commitments: list[bytes], zs: list[int], ys: list[int],
    proofs: list[bytes], setup: TrustedSetup,
) -> bool:
    n = len(commitments)
    if not (len(zs) == len(ys) == len(proofs) == n):
        raise KzgError("batch input length mismatch")
    # Fiat-Shamir the batch randomizer (spec verify_kzg_proof_batch)
    data = (
        RANDOM_CHALLENGE_KZG_BATCH_DOMAIN
        + FIELD_ELEMENTS_PER_BLOB.to_bytes(8, ENDIANNESS)
        + n.to_bytes(8, ENDIANNESS)
    )
    for c, z, y, w in zip(commitments, zs, ys, proofs):
        data += c + z.to_bytes(32, ENDIANNESS) + y.to_bytes(32, ENDIANNESS) + w
    r = hash_to_bls_field(data)
    r_pow = [pow(r, i, BLS_MODULUS) for i in range(n)]

    C = [_decode_g1(c, "commitment") for c in commitments]
    W = [_decode_g1(w, "proof") for w in proofs]
    proof_lincomb = g1_lincomb(W, r_pow)
    proof_z_lincomb = g1_lincomb(W, [ri * z % BLS_MODULUS for ri, z in zip(r_pow, zs)])
    c_minus_y = [
        _g1_add(c_i, affine_neg(affine_mul(G1_GENERATOR, y, Fp)) if y else None)
        for c_i, y in zip(C, ys)
    ]
    c_minus_y_lincomb = g1_lincomb(c_minus_y, r_pow)
    rhs = _g1_add(c_minus_y_lincomb, proof_z_lincomb)
    pairs = []
    if proof_lincomb is not None:
        pairs.append((proof_lincomb, affine_neg(setup.g2_monomial[1])))
    if rhs is not None:
        pairs.append((rhs, G2_GENERATOR))
    if not pairs:
        return True
    return pairing_check(pairs)
