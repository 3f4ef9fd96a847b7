"""RFC 9380 hash-to-curve for BLS12-381 G2: BLS12381G2_XMD:SHA-256_SSWU_RO_.

This is the `Hash_to_G2` the reference obtains from blst (DST constant at
reference crypto/bls/src/impls/blst.rs:13).  Pipeline:

    msg --expand_message_xmd(SHA-256)--> 512 bytes
        --hash_to_field--> u0, u1 in Fp2
        --SSWU--> two points on E' (the 3-isogenous auxiliary curve)
        --isogeny--> two points on E2 (the twist), added
        --clear_cofactor--> G2

SHA-256 runs host-side (hashlib).  The field/curve/pairing layers this feeds
have batched twins in torch_backend/ (fp.py, tower.py, points.py, pairing.py,
h2c.py); this module stays the host reference for them.  The isogeny constants are derived,
not transcribed — see tools/derive_g2_isogeny.py and g2_isogeny.py.
"""

from __future__ import annotations

import hashlib

from . import g2_isogeny, params
from .curve import B2, affine_add, affine_mul
from .fields import Fp2

# SSWU parameters for the auxiliary curve E' (RFC 9380 §8.8.2).
A_PRIME = Fp2(0, 240)
B_PRIME = Fp2(1012, 1012)
Z = Fp2(-2 % params.P, -1 % params.P)  # -(2 + u)

_L = 64  # bytes per field-element limb draw (ceil((381 + 128) / 8))
_HASH_BLOCK = 64  # SHA-256 block size


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 §5.3.1 expand_message_xmd with SHA-256."""
    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    ell = (len_in_bytes + 31) // 32
    if ell > 255:
        raise ValueError("len_in_bytes too large")
    dst_prime = dst + bytes([len(dst)])
    z_pad = bytes(_HASH_BLOCK)
    l_i_b = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    b = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    out = bytearray(b)
    prev = b
    for i in range(2, ell + 1):
        xored = bytes(x ^ y for x, y in zip(b0, prev))
        prev = hashlib.sha256(xored + bytes([i]) + dst_prime).digest()
        out += prev
    return bytes(out[:len_in_bytes])


def hash_to_field_fp2(msg: bytes, count: int, dst: bytes = params.DST) -> list[Fp2]:
    """RFC 9380 §5.2 hash_to_field with m=2, L=64."""
    len_in_bytes = count * 2 * _L
    uniform = expand_message_xmd(msg, dst, len_in_bytes)
    out = []
    for i in range(count):
        coords = []
        for j in range(2):
            off = _L * (j + i * 2)
            coords.append(int.from_bytes(uniform[off : off + _L], "big") % params.P)
        out.append(Fp2(coords[0], coords[1]))
    return out


def sswu(u: Fp2):
    """Simplified SWU map to the auxiliary curve E' (RFC 9380 §6.6.2)."""
    # tv = Z * u^2;  x1 = -B/A * (1 + 1/(tv^2 + tv))  (or B/(Z*A) if zero)
    tv = Z * u.square()
    tv2 = tv.square() + tv
    if tv2.is_zero():
        x1 = B_PRIME * (Z * A_PRIME).inv()
    else:
        x1 = (-B_PRIME) * A_PRIME.inv() * (Fp2.one() + tv2.inv())
    gx1 = (x1.square() + A_PRIME) * x1 + B_PRIME
    y1 = gx1.sqrt()
    if y1 is not None:
        x, y = x1, y1
    else:
        x2 = tv * x1
        gx2 = (x2.square() + A_PRIME) * x2 + B_PRIME
        y2 = gx2.sqrt()
        assert y2 is not None, "SSWU: neither gx1 nor gx2 is square (impossible)"
        x, y = x2, y2
    if u.sgn0() != y.sgn0():
        y = -y
    return (x, y)


# Isogeny coefficient tables as Fp2 (low degree first).
#
# Y_NUM is negated relative to the raw Velu derivation: the derivation's
# scaling isomorphism used c = 1/3, but the RFC 9380 §8.8.2 map corresponds to
# c = -1/3 (same c^2, negated c^3) — i.e. the RFC map composes the normalized
# Velu isogeny with the [-1] automorphism on the y-coordinate. Verified
# against the RFC 9380 J.10.1 test vector.
_X_NUM = [Fp2(c0, c1) for c0, c1 in g2_isogeny.X_NUM]
_X_DEN = [Fp2(c0, c1) for c0, c1 in g2_isogeny.X_DEN]
_Y_NUM = [-Fp2(c0, c1) for c0, c1 in g2_isogeny.Y_NUM]
_Y_DEN = [Fp2(c0, c1) for c0, c1 in g2_isogeny.Y_DEN]

# RFC 9380 §8.8.2 effective cofactor for G2 cofactor clearing. This differs
# from the naive twist cofactor H2 = #E'(Fp2)/r by a unit mod r, so it also
# lands points in G2 (asserted in tests), but produces the RFC-specified
# point. Verified against the RFC 9380 J.10.1 test vector.
H_EFF_G2 = 0xBC69F08F2EE75B3584C6A0EA91B352888E2A8E9145AD7689986FF031508FFE1329C2F178731DB956D82BF015D1212B02EC0EC69D7477C1AE954CBC06689F6A359894C0ADEBBF6B4E8020005AAA95551


def _poly_eval(coeffs, x: Fp2) -> Fp2:
    acc = Fp2.zero()
    for c in reversed(coeffs):
        acc = acc * x + c
    return acc


def iso_map(pt):
    """The derived 3-isogeny E' -> E2; kernel points map to infinity."""
    if pt is None:
        return None
    x, y = pt
    den = _poly_eval(_X_DEN, x)
    if den.is_zero():
        return None
    X = _poly_eval(_X_NUM, x) * den.inv()
    Y = y * _poly_eval(_Y_NUM, x) * _poly_eval(_Y_DEN, x).inv()
    assert Y.square() == X.square() * X + B2
    return (X, Y)


def hash_to_g2(msg: bytes, dst: bytes = params.DST):
    """Full hash_to_curve; returns an affine G2 point.

    Cofactor clearing uses the endomorphism-based fast path (endo.py), which
    is asserted at import time to equal multiplication by H_EFF_G2 on random
    twist points; `hash_to_g2_slow` keeps the literal RFC scalar mul as the
    differential anchor.
    """
    from .endo import clear_cofactor_fast

    u0, u1 = hash_to_field_fp2(msg, 2, dst)
    q0 = iso_map(sswu(u0))
    q1 = iso_map(sswu(u1))
    return clear_cofactor_fast(affine_add(q0, q1, Fp2))


def hash_to_g2_slow(msg: bytes, dst: bytes = params.DST):
    """Literal RFC 9380 pipeline with scalar-mul cofactor clearing."""
    u0, u1 = hash_to_field_fp2(msg, 2, dst)
    q0 = iso_map(sswu(u0))
    q1 = iso_map(sswu(u1))
    return affine_mul(affine_add(q0, q1, Fp2), H_EFF_G2, Fp2)
