"""Endomorphism-accelerated G1/G2 operations for BLS12-381.

The reference gets these from blst's hand-written assembly (subgroup checks at
crypto/bls/src/impls/blst.rs:71-81 via blst's `in_group`, cofactor clearing
inside hash-to-curve).  Here they are derived from first principles and
verified at import time against the slow scalar-multiplication definitions:

* psi — the untwist-Frobenius-twist endomorphism of E'(Fp2).  On G2 it acts
  as multiplication by the BLS parameter x (because p ≡ x (mod r) for BLS12
  curves), which gives Scott's fast subgroup test  psi(Q) == [x]Q  (a 64-bit
  scalar mul instead of a 255-bit one).
* phi — the GLV endomorphism (x, y) -> (beta*x, y) of E(Fp).  On G1 it acts
  as multiplication by lambda = x^2 - 1 (lambda^2 + lambda + 1 = 0 mod r),
  giving the fast G1 test  phi(P) == [x^2 - 1]P  with two 64-bit muls.
* clear_cofactor_fast — Budroni-Pintore G2 cofactor clearing
  [x^2-x-1]P + [x-1]psi(P) + psi2([2]P), equal to multiplication by the
  RFC 9380 effective cofactor h_eff (asserted on random twist points).

All constants are computed here from params.P / params.X, never transcribed.
"""

from __future__ import annotations

import random as _random

from . import params
from .curve import (
    Fp,
    Fp2,
    B1,
    B2,
    G1_GENERATOR,
    G2_GENERATOR,
    affine_add,
    affine_mul,
    from_jacobian,
    is_on_curve,
    jac_add,
    jac_mul,
    to_jacobian,
)
from .fields import XI

P = params.P
X = params.X

# ---------------------------------------------------------------------------
# psi: untwist-Frobenius-twist on E'(Fp2)
# ---------------------------------------------------------------------------
# With w^6 = xi and the untwist (x, y) -> (x/w^2, y/w^3), Frobenius acts on w
# as w^p = gamma * w, gamma = xi^((p-1)/6).  Twisting back:
#   psi(x, y) = (conj(x) * gamma^-2, conj(y) * gamma^-3).

assert (P - 1) % 6 == 0
_GAMMA = XI.pow((P - 1) // 6)
PSI_CX = _GAMMA.pow(2).inv()
PSI_CY = _GAMMA.pow(3).inv()


def psi(pt):
    """The G2 endomorphism; pt is an affine E'(Fp2) point (or None)."""
    if pt is None:
        return None
    x, y = pt
    return (x.conjugate() * PSI_CX, y.conjugate() * PSI_CY)


def psi2(pt):
    return psi(psi(pt))


# psi must be an endomorphism of E' acting as [x] on G2.
assert is_on_curve(psi(G2_GENERATOR), B2, Fp2)
assert psi(G2_GENERATOR) == affine_mul(G2_GENERATOR, X, Fp2)

# ---------------------------------------------------------------------------
# phi: GLV endomorphism on E(Fp)
# ---------------------------------------------------------------------------
# beta is a primitive cube root of unity in Fp; phi(x,y) = (beta x, y) acts on
# G1 as multiplication by an eigenvalue lambda with lambda^2+lambda+1 = 0
# (mod r).  lambda = x^2 - 1 satisfies this for BLS12 ((x^2-1)^2 + (x^2-1) + 1
# = x^4 - x^2 + 1 = Phi_12(x), divisible by r).  The two cube roots give the
# two eigenvalues; pick the one matching lambda = x^2 - 1.

assert (P - 1) % 3 == 0
LAMBDA = X * X - 1
assert (LAMBDA * LAMBDA + LAMBDA + 1) % params.R == 0


def _find_beta() -> int:
    rng = _random.Random(0xBE7A)
    while True:
        g = rng.randrange(2, P)
        b = pow(g, (P - 1) // 3, P)
        if b != 1:
            return b


_B_CAND = _find_beta()


def _phi_with(beta: int, pt):
    if pt is None:
        return None
    x, y = pt
    return (x * beta, y)


# Select the cube root whose action on G1 is [x^2 - 1].
_target = affine_mul(G1_GENERATOR, LAMBDA, Fp)
if _phi_with(_B_CAND, G1_GENERATOR) == _target:
    BETA = _B_CAND
else:
    _other = _B_CAND * _B_CAND % P
    assert _phi_with(_other, G1_GENERATOR) == _target, "no cube root acts as lambda"
    BETA = _other


def phi(pt):
    """The G1 endomorphism (x, y) -> (beta x, y)."""
    return _phi_with(BETA, pt)


# ---------------------------------------------------------------------------
# Fast subgroup checks (Scott, "A note on group membership tests…", 2021)
# ---------------------------------------------------------------------------


def g1_subgroup_check_fast(pt) -> bool:
    """P in G1  iff  phi(P) == [x^2 - 1]P == [x-1]([x+1]P)."""
    if pt is None:
        return True
    t = affine_mul(affine_mul(pt, X + 1, Fp), X - 1, Fp)
    return phi(pt) == t


def g2_subgroup_check_fast(pt) -> bool:
    """Q in G2  iff  psi(Q) == [x]Q  (p ≡ x mod r on the r-torsion)."""
    if pt is None:
        return True
    return psi(pt) == affine_mul(pt, X, Fp2)


# ---------------------------------------------------------------------------
# Fast G2 cofactor clearing (Budroni-Pintore)
# ---------------------------------------------------------------------------
#   h(P) = [x^2 - x - 1]P + [x - 1]psi(P) + psi2([2]P)
# which equals multiplication by the RFC 9380 effective cofactor h_eff.


def clear_cofactor_fast(pt):
    if pt is None:
        return None
    xP = affine_mul(pt, X, Fp2)  # [x]P
    x2P = affine_mul(xP, X, Fp2)  # [x^2]P
    # [x^2]P - [x]P - P
    acc = to_jacobian(x2P, Fp2)
    acc = jac_add(acc, jac_mul(to_jacobian(xP, Fp2), -1, Fp2), Fp2)
    acc = jac_add(acc, jac_mul(to_jacobian(pt, Fp2), -1, Fp2), Fp2)
    # + [x-1]psi(P)
    psiP = psi(pt)
    acc = jac_add(acc, jac_mul(to_jacobian(psiP, Fp2), X - 1, Fp2), Fp2)
    # + psi2([2]P)
    acc = jac_add(acc, to_jacobian(psi2(affine_add(pt, pt, Fp2)), Fp2), Fp2)
    return from_jacobian(acc, Fp2)


def _selfcheck_endo() -> None:
    """Verify the fast paths against the slow definitions on random points."""
    from .hash_to_curve import H_EFF_G2

    rng = _random.Random(0xE4D0)
    # Random E'(Fp2) points (almost surely NOT in G2).
    pts = []
    while len(pts) < 2:
        x = Fp2(rng.randrange(P), rng.randrange(P))
        rhs = x.square() * x + B2
        y = rhs.sqrt()
        if y is not None:
            pts.append((x, y))
    for pt in pts:
        cleared = clear_cofactor_fast(pt)
        assert cleared == affine_mul(pt, H_EFF_G2, Fp2)
        # fast check matches the defining [r]Q == inf test
        slow = affine_mul(pt, params.R, Fp2) is None
        assert g2_subgroup_check_fast(pt) == slow
        assert g2_subgroup_check_fast(cleared)
        assert affine_mul(cleared, params.R, Fp2) is None
    # Random E(Fp) points: fast G1 check vs the defining [r]P == inf test.
    g1_pts = []
    while len(g1_pts) < 2:
        xv = Fp(rng.randrange(P))
        y = (xv.square() * xv + B1).sqrt()
        if y is not None:
            g1_pts.append((xv, y))
    for pt in g1_pts:
        slow = affine_mul(pt, params.R, Fp) is None
        assert g1_subgroup_check_fast(pt) == slow
        in_g1 = affine_mul(pt, params.H1, Fp)
        assert g1_subgroup_check_fast(in_g1)
        assert affine_mul(in_g1, params.R, Fp) is None


_selfcheck_endo()
