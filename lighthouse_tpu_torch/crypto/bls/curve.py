"""Pure-Python BLS12-381 group arithmetic: G1 (over Fp) and G2 (over Fp2).

Reference-parity notes: this module provides the semantics the reference gets
from blst's point types — deserialization with validation (reference:
crypto/bls/src/generic_public_key.rs:70 infinity-pubkey rejection and blst
key_validate), subgroup checks (crypto/bls/src/impls/blst.rs:71-81), and the
Zcash compressed encodings used across the Ethereum ecosystem.

Points are affine `(x, y)` pairs of field elements or `None` for infinity;
hot loops (scalar mul, multi-exp) use Jacobian coordinates internally.
The coordinate field is generic: `Fp` for G1, `Fp2` for G2 — both expose the
same arithmetic interface (fields.py).
"""

from __future__ import annotations

from . import params
from .fields import Fp, Fp2

# ---------------------------------------------------------------------------
# Generic short-Weierstrass (a = 0) affine/Jacobian arithmetic
# ---------------------------------------------------------------------------
# A point is None (infinity) or (x, y) with y^2 = x^3 + b.
# A Jacobian point is (X, Y, Z): x = X/Z^2, y = Y/Z^3; infinity iff Z == 0.


def to_jacobian(pt, field):
    if pt is None:
        return (field.one(), field.one(), field.zero())
    return (pt[0], pt[1], field.one())


def from_jacobian(jpt, field):
    X, Y, Z = jpt
    if Z.is_zero():
        return None
    zinv = Z.inv()
    zinv2 = zinv.square()
    return (X * zinv2, Y * zinv2 * zinv)


def jac_double(pt, field):
    X, Y, Z = pt
    if Z.is_zero() or Y.is_zero():
        return (field.one(), field.one(), field.zero())
    A = X.square()
    B = Y.square()
    C = B.square()
    D = ((X + B).square() - A - C) * 2
    E = A * 3
    F = E.square()
    X3 = F - D * 2
    Y3 = E * (D - X3) - C * 8
    Z3 = (Y * Z) * 2
    return (X3, Y3, Z3)


def jac_add(p1, p2, field):
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    if Z1.is_zero():
        return p2
    if Z2.is_zero():
        return p1
    Z1Z1 = Z1.square()
    Z2Z2 = Z2.square()
    U1 = X1 * Z2Z2
    U2 = X2 * Z1Z1
    S1 = Y1 * Z2 * Z2Z2
    S2 = Y2 * Z1 * Z1Z1
    if U1 == U2:
        if S1 == S2:
            return jac_double(p1, field)
        return (field.one(), field.one(), field.zero())
    H = U2 - U1
    I = (H * 2).square()
    J = H * I
    rr = (S2 - S1) * 2
    V = U1 * I
    X3 = rr.square() - J - V * 2
    Y3 = rr * (V - X3) - S1 * J * 2
    Z3 = ((Z1 + Z2).square() - Z1Z1 - Z2Z2) * H
    return (X3, Y3, Z3)


def jac_neg(pt):
    X, Y, Z = pt
    return (X, -Y, Z)


def jac_mul(pt, k: int, field):
    """Scalar multiplication (double-and-add, MSB first)."""
    if k < 0:
        return jac_mul(jac_neg(pt), -k, field)
    acc = (field.one(), field.one(), field.zero())
    if k == 0:
        return acc
    for bit in bin(k)[2:]:
        acc = jac_double(acc, field)
        if bit == "1":
            acc = jac_add(acc, pt, field)
    return acc


def affine_add(p1, p2, field):
    return from_jacobian(
        jac_add(to_jacobian(p1, field), to_jacobian(p2, field), field), field
    )


def affine_neg(pt):
    if pt is None:
        return None
    return (pt[0], -pt[1])


def affine_mul(pt, k: int, field):
    return from_jacobian(jac_mul(to_jacobian(pt, field), k, field), field)


def is_on_curve(pt, b, field) -> bool:
    if pt is None:
        return True
    x, y = pt
    return y.square() == x.square() * x + b


# ---------------------------------------------------------------------------
# Concrete groups
# ---------------------------------------------------------------------------

B1 = Fp(params.B_G1)
B2 = Fp2(*params.B_G2)

G1_GENERATOR = (Fp(params.G1_GEN[0]), Fp(params.G1_GEN[1]))
G2_GENERATOR = (Fp2(*params.G2_GEN[0]), Fp2(*params.G2_GEN[1]))

assert is_on_curve(G1_GENERATOR, B1, Fp)
assert is_on_curve(G2_GENERATOR, B2, Fp2)


# The generators must be in the prime-order subgroups.
assert affine_mul(G1_GENERATOR, params.R, Fp) is None
assert affine_mul(G2_GENERATOR, params.R, Fp2) is None


def g1_subgroup_check(pt) -> bool:
    """Fast endomorphism-based membership test (endo.py), asserted there to
    equal the defining [r]P == inf check on random points."""
    from .endo import g1_subgroup_check_fast

    return g1_subgroup_check_fast(pt)


def g2_subgroup_check(pt) -> bool:
    from .endo import g2_subgroup_check_fast

    return g2_subgroup_check_fast(pt)


# ---------------------------------------------------------------------------
# Zcash compressed serialization
# ---------------------------------------------------------------------------
# Flag bits in the most significant byte of the encoding:
#   bit 7 (0x80): compressed flag (always set here)
#   bit 6 (0x40): infinity flag
#   bit 5 (0x20): sign of y (set if y is lexicographically the larger root)


def g1_to_bytes(pt) -> bytes:
    if pt is None:
        out = bytearray(48)
        out[0] = 0xC0
        return bytes(out)
    x, y = pt
    data = bytearray(x.v.to_bytes(48, "big"))
    data[0] |= 0x80
    if y.v > (params.P - 1) // 2:
        data[0] |= 0x20
    return bytes(data)


def g1_from_bytes(data: bytes, subgroup_check: bool = True):
    """Deserialize a compressed G1 point.

    Raises ValueError on malformed input; returns None for the point at
    infinity. Mirrors blst deserialize + key_validate semantics (on-curve and
    subgroup checks; reference crypto/bls/src/impls/blst.rs:124-134).
    """
    if len(data) != 48:
        raise ValueError("G1 compressed encoding must be 48 bytes")
    flags = data[0]
    if not flags & 0x80:
        raise ValueError("uncompressed G1 encodings not supported")
    infinity = bool(flags & 0x40)
    sign = bool(flags & 0x20)
    body = bytes([flags & 0x1F]) + data[1:]
    x_int = int.from_bytes(body, "big")
    if infinity:
        if sign or x_int != 0:
            raise ValueError("malformed infinity encoding")
        return None
    if x_int >= params.P:
        raise ValueError("x coordinate not in field")
    x = Fp(x_int)
    rhs = x.square() * x + B1
    y = rhs.sqrt()
    if y is None:
        raise ValueError("x is not on the curve")
    if (y.v > (params.P - 1) // 2) != sign:
        y = -y
    pt = (x, y)
    if subgroup_check and not g1_subgroup_check(pt):
        raise ValueError("point not in G1 subgroup")
    return pt


def g2_to_bytes(pt) -> bytes:
    if pt is None:
        out = bytearray(96)
        out[0] = 0xC0
        return bytes(out)
    x, y = pt
    # c1 (the "imaginary" coefficient) is serialized first.
    data = bytearray(x.c1.to_bytes(48, "big") + x.c0.to_bytes(48, "big"))
    data[0] |= 0x80
    # Sign: lexicographic order on (c1, c0).
    if _fp2_lex_larger(y):
        data[0] |= 0x20
    return bytes(data)


def _fp2_lex_larger(y: Fp2) -> bool:
    """True if y > -y lexicographically on (c1, c0)."""
    ny1, ny0 = (-y).c1, (-y).c0
    return (y.c1, y.c0) > (ny1, ny0)


def g2_from_bytes(data: bytes, subgroup_check: bool = True):
    if len(data) != 96:
        raise ValueError("G2 compressed encoding must be 96 bytes")
    flags = data[0]
    if not flags & 0x80:
        raise ValueError("uncompressed G2 encodings not supported")
    infinity = bool(flags & 0x40)
    sign = bool(flags & 0x20)
    body = bytes([flags & 0x1F]) + data[1:48]
    x_c1 = int.from_bytes(body, "big")
    x_c0 = int.from_bytes(data[48:], "big")
    if infinity:
        if sign or x_c1 != 0 or x_c0 != 0:
            raise ValueError("malformed infinity encoding")
        return None
    if x_c0 >= params.P or x_c1 >= params.P:
        raise ValueError("x coordinate not in field")
    x = Fp2(x_c0, x_c1)
    rhs = x.square() * x + B2
    y = rhs.sqrt()
    if y is None:
        raise ValueError("x is not on the curve")
    if _fp2_lex_larger(y) != sign:
        y = -y
    pt = (x, y)
    if subgroup_check and not g2_subgroup_check(pt):
        raise ValueError("point not in G2 subgroup")
    return pt
