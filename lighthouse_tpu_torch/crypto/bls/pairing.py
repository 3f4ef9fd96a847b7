"""Pure-Python optimal-ate pairing for BLS12-381: the scalar oracle's.

The port's own copy of the JAX package's ``crypto/bls/pairing.py``: N Miller
loops plus one shared final exponentiation, what blst's
`verify_multiple_aggregate_signatures` computes per pair
(crypto/bls/src/impls/blst.rs:107-117).  ``api.PythonBackend`` runs on it:
the CPU rung of the verifier ladder (beacon/processor.py) and the integrity
layer's oracle.  The batched PyTorch program (torch_backend/pairing.py)
computes the same function on limbs.

Two Miller loops are provided:

* `miller_loop` (the default) — the fast, twist-based loop: the G2 point stays
  on E'(Fp2) in Jacobian coordinates, line functions are evaluated directly in
  the sparse basis Fp12 = Fp2[w]/(w^6 - xi) at positions (w^0, w^2, w^3), and
  inversion-free formulas absorb all denominators into Fp2/Fp4 factors that
  the final exponentiation erases.
* `miller_loop_untwisted` — the original transparent implementation that
  untwists G2 into E(Fp12) and runs affine formulas generically.  It is the
  oracle's oracle: tests assert the two agree after final exponentiation.
"""

from __future__ import annotations

from . import params
from .fields import Fp, Fp2, Fp6, Fp12, XI, fp12_from_fp2_coeffs

# Loop count: |x|, MSB-first bit string.
_X_ABS = abs(params.X)
_X_BITS = bin(_X_ABS)[2:]

_XI_INV = XI.inv()


def untwist(q):
    """Map an affine point of E'(Fp2) (the M-twist) to E(Fp12).

    (x', y') -> (x' / w^2, y' / w^3)  with  1/w^2 = xi^{-1} v^2  and
    1/w^3 = xi^{-1} v w  in the tower basis.
    """
    if q is None:
        return None
    x2, y2 = q
    x12 = Fp12(Fp6(Fp2.zero(), Fp2.zero(), x2 * _XI_INV), Fp6.zero())
    y12 = Fp12(Fp6.zero(), Fp6(Fp2.zero(), y2 * _XI_INV, Fp2.zero()))
    return (x12, y12)


def embed_g1(p):
    """Embed an affine G1 point (Fp coords) into E(Fp12)."""
    if p is None:
        return None
    x, y = p
    return (
        Fp12(Fp6(Fp2(x.v, 0), Fp2.zero(), Fp2.zero()), Fp6.zero()),
        Fp12(Fp6(Fp2(y.v, 0), Fp2.zero(), Fp2.zero()), Fp6.zero()),
    )


def _line_dbl(T, xp_v: int, yp_v: int):
    """Tangent line at Jacobian twist point T, evaluated at P = (xp, yp),
    scaled by 2*Y*Z^3 (an Fp2 factor, erased by the final exponentiation) and
    by w^3 (an Fp4 factor, likewise erased).  Returns the sparse coefficients
    (l0, l2, l3) at w^0/w^2/w^3 and the doubled point.

    Derivation (slope lam = 3x^2/2y, x = X/Z^2, y = Y/Z^3):
      l*w^3 = yp*w^3 - lam*xp*w^2 + (lam*x - y)*w^0 ; multiply by 2YZ^3:
      l0 = 3X^3 - 2Y^2,  l2 = -3X^2Z^2*xp,  l3 = 2YZ^3*yp.
    """
    X1, Y1, Z1 = T
    X_sq = X1.square()
    Y_sq = Y1.square()
    Z_sq = Z1.square()
    Z_cu = Z_sq * Z1
    l0 = X_sq * X1 * 3 - Y_sq * 2
    l2 = -(X_sq * Z_sq * 3) * xp_v
    l3 = (Y1 * Z_cu * 2) * yp_v
    # Jacobian doubling (a = 0), reusing X_sq / Y_sq.
    C = Y_sq.square()
    D = ((X1 + Y_sq).square() - X_sq - C) * 2
    E = X_sq * 3
    F = E.square()
    X3 = F - D * 2
    Y3 = E * (D - X3) - C * 8
    Z3 = (Y1 * Z1) * 2
    return (l0, l2, l3), (X3, Y3, Z3)


def _line_add(T, Q, xp_v: int, yp_v: int):
    """Chord line through Jacobian T and affine twist Q, evaluated at P,
    scaled by Z*H (Fp2, erased) and w^3.  Returns ((l0, l2, l3), T + Q).

    With U2 = x2 Z^2, S2 = y2 Z^3, H = U2 - X, r = S2 - Y, lam = r/(Z*H):
      l0 = r*x2 - y2*Z*H,  l2 = -r*xp,  l3 = Z*H*yp.
    """
    X1, Y1, Z1 = T
    x2, y2 = Q
    Z_sq = Z1.square()
    Z_cu = Z_sq * Z1
    H = x2 * Z_sq - X1
    rr = y2 * Z_cu - Y1
    ZH = Z1 * H
    l0 = rr * x2 - y2 * ZH
    l2 = -rr * xp_v
    l3 = ZH * yp_v
    # Mixed Jacobian + affine addition via the same H / rr.
    H_sq = H.square()
    H_cu = H * H_sq
    V = X1 * H_sq
    X3 = rr.square() - H_cu - V * 2
    Y3 = rr * (V - X3) - Y1 * H_cu
    Z3 = ZH
    return (l0, l2, l3), (X3, Y3, Z3)


def _sparse_to_fp12(l0: Fp2, l2: Fp2, l3: Fp2) -> Fp12:
    return fp12_from_fp2_coeffs([l0, Fp2.zero(), l2, l3, Fp2.zero(), Fp2.zero()])


def miller_loop(p_g1, q_g2) -> Fp12:
    """Twist-based Miller loop: f_{|x|,Q}(P) conjugated for the negative BLS
    parameter, up to Fp2/Fp4 scalings erased by the final exponentiation.
    `p_g1` is an affine G1 point, `q_g2` an affine G2 (twist) point; either
    may be None (infinity), yielding 1."""
    if p_g1 is None or q_g2 is None:
        return Fp12.one()
    xp_v, yp_v = p_g1[0].v, p_g1[1].v
    T = (q_g2[0], q_g2[1], Fp2.one())
    f = Fp12.one()
    for bit in _X_BITS[1:]:
        line, T = _line_dbl(T, xp_v, yp_v)
        f = f.square().mul_by_023(*line)
        if bit == "1":
            line, T = _line_add(T, q_g2, xp_v, yp_v)
            f = f.mul_by_023(*line)
    return f.conjugate()


def miller_loop_untwisted(p_g1, q_g2) -> Fp12:
    """f_{|x|,Q}(P) (conjugated for the negative BLS parameter), without the
    final exponentiation.  `p_g1` is an affine G1 point, `q_g2` an affine G2
    (twist) point; either may be None (infinity), yielding 1."""
    if p_g1 is None or q_g2 is None:
        return Fp12.one()
    xp, yp = embed_g1(p_g1)
    Q = untwist(q_g2)
    xq, yq = Q
    f = Fp12.one()
    xt, yt = xq, yq
    for bit in _X_BITS[1:]:
        # Tangent line at T, evaluated at P.
        slope = (xt.square() * 3) * (yt * 2).inv()
        line = yp - yt - slope * (xp - xt)
        f = f.square() * line
        # T = 2T (affine doubling via the same slope).
        x_new = slope.square() - xt * 2
        y_new = slope * (xt - x_new) - yt
        xt, yt = x_new, y_new
        if bit == "1":
            # Chord line through T and Q, evaluated at P.
            slope = (yq - yt) * (xq - xt).inv()
            line = yp - yt - slope * (xp - xt)
            f = f * line
            x_new = slope.square() - xt - xq
            y_new = slope * (xt - x_new) - yt
            xt, yt = x_new, y_new
    # x < 0: f_{-n} ≡ conj(f_n) modulo the final exponentiation.
    return f.conjugate()


# Hard-part exponent (p^4 - p^2 + 1) / r, computed once.
_P = params.P
_HARD_EXP, _hard_rem = divmod(_P**4 - _P**2 + 1, params.R)
assert _hard_rem == 0


def final_exponentiation(f: Fp12) -> Fp12:
    """f^((p^12-1)/r): easy part via Frobenius/conjugation, hard part as a
    plain square-and-multiply (reference oracle; the JAX backend uses the
    cyclotomic x-chain, differentially tested against this)."""
    # Easy part: f^(p^6-1) then ^(p^2+1).
    f = f.conjugate() * f.inv()
    f = f.frobenius_n(2) * f
    # Hard part.
    return f.pow(_HARD_EXP)


def final_exp_is_one(f: Fp12) -> bool:
    """Fast check  f^((p^12-1)/r) == 1  via the cubed hard part.

    Uses the BLS12 identity  3*hard = (x-1)^2 (x+p) (x^2+p^2-1) + 3
    (asserted below): since gcd(3, r) = 1, f^(easy*3*hard) == 1 iff
    f^(easy*hard) == 1.  Exponentiations by x are 64-bit, so this is ~2x
    cheaper than the generic 381-bit hard-part pow — and it is the exact
    structure the JAX backend's final exponentiation mirrors.
    """
    x = params.X
    # Easy part: f^((p^6-1)(p^2+1)).
    m = f.conjugate() * f.inv()
    m = m.frobenius_n(2) * m
    # Cubed hard part.
    a = m.pow(x - 1)
    a = a.pow(x - 1)
    b = a.frobenius() * a.pow(x)  # a^(x+p)
    # b is in the cyclotomic subgroup (it is a power of m, which satisfies
    # m^(p^6+1) = 1), so conjugation is inversion.
    c = b.pow(x).pow(x) * b.frobenius_n(2) * b.conjugate()  # b^(x^2+p^2-1)
    return c * m.square() * m == Fp12.one()


assert 3 * _HARD_EXP == (params.X - 1) ** 2 * (params.X + _P) * (
    params.X**2 + _P**2 - 1
) + 3


def multi_miller_loop(pairs) -> Fp12:
    f = Fp12.one()
    for p, q in pairs:
        f = f * miller_loop(p, q)
    return f


def pairing(p, q) -> Fp12:
    """Exact pairing value (uses the transparent untwisted loop so that the
    result is the canonical e(P, Q), free of the twist-loop's scalings)."""
    return final_exponentiation(miller_loop_untwisted(p, q))


def pairing_check(pairs) -> bool:
    """True iff prod e(P_i, Q_i) == 1."""
    return final_exp_is_one(multi_miller_loop(pairs))
