"""Device-side map-to-curve: SSWU + 3-isogeny + cofactor clearing, batched.

Port of jax_backend/h2c.py.  The host hashes (expand_message_xmd -> u0, u1
in Fp2); everything after runs on the batch axis: the branchless simplified
SWU map (RFC 9380 §6.6.2) with the q = 9 (mod 16) square-root candidates
t^((q+7)/16) * {1, c1, c2, c3}, the derived 3-isogeny, a Jacobian add and
Budroni-Pintore cofactor clearing through psi.
"""

from __future__ import annotations

import torch

from .. import g2_isogeny, params
from ..fields import Fp2 as OFp2
from ..hash_to_curve import A_PRIME, B_PRIME, Z
from . import fp as F
from . import points as P
from . import tower as T

SQRT_EXP = (params.P * params.P + 7) // 16
SQRT_EXP_BITS = [int(b) for b in bin(SQRT_EXP)[2:]]

# sqrt candidate constants (oracle-computed, self-checked)
_C1 = OFp2(0, 1)  # sqrt(-1)
assert _C1.square() == OFp2(-1 % params.P, 0)
_C2 = _C1.sqrt()
_C3 = (-_C1).sqrt()
assert _C2 is not None and _C3 is not None
assert _C2.square() == _C1 and _C3.square() == -_C1

_NEG_B_OVER_A = (-B_PRIME) * A_PRIME.inv()
_B_OVER_ZA = B_PRIME * (Z * A_PRIME).inv()

_ISO_X_NUM = [OFp2(c0, c1) for c0, c1 in g2_isogeny.X_NUM]
_ISO_X_DEN = [OFp2(c0, c1) for c0, c1 in g2_isogeny.X_DEN]
_ISO_Y_NUM = [-OFp2(c0, c1) for c0, c1 in g2_isogeny.Y_NUM]
_ISO_Y_DEN = [OFp2(c0, c1) for c0, c1 in g2_isogeny.Y_DEN]

assert params.X < 0  # BLS12-381: the BLS parameter is negative


def _const(c, like):
    limbs = like[0].limbs
    return T.fp2_const(c, limbs.shape[1:], limbs.device)


def _stable(a):
    """Reduce both coords to the stable bound class (loop-carry safe).
    When both need it, one stacked product reduces them (the same limbs as
    two separate reductions, one launch instead of two)."""
    if a[0].bound > 2.0 and a[1].bound > 2.0:
        return T.fp2_reduce(a)
    return (F.relabel(F.guard_le(a[0], 2.0), 2.0), F.relabel(F.guard_le(a[1], 2.0), 2.0))


def fp2_pow_static(a, bits: list[int]):
    """a^e for a static exponent (MSB-first bits).  Under the chain arm the
    whole chain is one launch of kernel 5 (chain_kernel.fp2_pow_chain).
    Otherwise square-and-multiply: the multiply runs only where the bit is
    set; the JAX scan computes it every step and selects, which keeps the
    same limbs."""
    a = _stable(a)
    if F.chains_active() and bits[0] == 1 and len(bits) > 4:
        from . import chain_kernel

        bshape = F.batch_shape(a[0])
        r0, r1 = chain_kernel.fp2_pow_chain(
            a[0].limbs.reshape(F.N, -1).contiguous(),
            a[1].limbs.reshape(F.N, -1).contiguous(), bits)
        return _stable((F.LFp(r0.reshape((F.N,) + bshape), 6.0),
                        F.LFp(r1.reshape((F.N,) + bshape), 6.0)))
    acc = tuple(F.relabel(c, 2.0) for c in T.fp2_one_like(a))
    for bit in bits:
        acc = _stable(T.fp2_sqr(acc))
        if bit:
            acc = _stable(T.fp2_mul(acc, a))
        acc = (F.relabel(acc[0], 2.0), F.relabel(acc[1], 2.0))
    return acc


def fp2_sqrt_or_flag(gx):
    """(y, is_square): y^2 == gx where is_square — one exponentiation and
    three constant multiplies."""
    gx = _stable(gx)
    t = fp2_pow_static(gx, SQRT_EXP_BITS)
    cands = [t] + [T.fp2_mul(t, _const(c, gx)) for c in (_C1, _C2, _C3)]
    y = cands[0]
    ok = T.fp2_eq(T.fp2_sqr(cands[0]), gx)
    for cand in cands[1:]:
        match = T.fp2_eq(T.fp2_sqr(cand), gx)
        y = T.fp2_select(match & ~ok, cand, y)
        ok = ok | match
    return _stable(y), ok


def _demont(c):
    """Montgomery -> standard-domain limbs: mont_mul by the literal 1."""
    one_raw = F.int_col(1, str(c.limbs.device))
    one_raw = one_raw.reshape((F.N,) + (1,) * (c.limbs.dim() - 1)).expand(c.limbs.shape)
    return F.mont_mul(F.guard_le(c, 4.0), F.LFp(one_raw, 1.0))


def fp2_sgn0(a):
    """RFC 9380 sgn0 for Fp2 on the standard-domain values."""
    c0 = F.fp_canon(_demont(a[0]))
    c1 = F.fp_canon(_demont(a[1]))
    c0_zero = torch.all(c0 == 0, dim=0)
    return torch.where(c0_zero, c1[0] & 1, c0[0] & 1)


def _gx(x, A, B):
    """x^3 + A x + B on the auxiliary curve."""
    x2 = T.fp2_sqr(x)
    (x3,) = T.fp2_mul_many([x2], [x])
    (ax,) = T.fp2_mul_many([A], [x])
    return T.fp2_add(T.fp2_add(x3, ax), B)


def sswu_g2(u):
    """Batched branchless simplified SWU onto E' (affine)."""
    u = _stable(u)
    Zc, Ac, Bc = _const(Z, u), _const(A_PRIME, u), _const(B_PRIME, u)
    u2 = T.fp2_sqr(u)
    (tv,) = T.fp2_mul_many([Zc], [u2])
    tv2 = T.fp2_add(T.fp2_sqr(tv), tv)
    tv2_zero = T.fp2_is_zero(tv2)
    one = T.fp2_one_like(u)
    inv_tv2 = T.fp2_inv(T.fp2_select(tv2_zero, one, tv2))
    (x1_main,) = T.fp2_mul_many([_const(_NEG_B_OVER_A, u)], [T.fp2_add(one, inv_tv2)])
    x1 = _stable(T.fp2_select(tv2_zero, _const(_B_OVER_ZA, u), x1_main))
    y1, sq1 = fp2_sqrt_or_flag(_gx(x1, Ac, Bc))
    (x2,) = T.fp2_mul_many([tv], [x1])
    x2 = _stable(x2)
    y2, _sq2 = fp2_sqrt_or_flag(_gx(x2, Ac, Bc))
    x = T.fp2_select(sq1, x1, x2)
    y = T.fp2_select(sq1, y1, y2)
    flip = fp2_sgn0(u) != fp2_sgn0(y)  # sgn0(y) must equal sgn0(u)
    y = T.fp2_select(flip, T.fp2_neg(y), y)
    return _stable(x), _stable(y)


def _horner(coeffs, x):
    acc = _const(coeffs[-1], x)
    for c in reversed(coeffs[:-1]):
        (acc_x,) = T.fp2_mul_many([acc], [x])
        acc = T.fp2_add(acc_x, _const(c, x))
    return acc


def iso_map_g2(xy):
    """The derived 3-isogeny E' -> E2, batched."""
    x, y = xy
    xn, xd = _horner(_ISO_X_NUM, x), _horner(_ISO_X_DEN, x)
    yn, yd = _horner(_ISO_Y_NUM, x), _horner(_ISO_Y_DEN, x)
    inv_xd, inv_yd = T.fp2_inv(xd), T.fp2_inv(yd)
    (X,) = T.fp2_mul_many([xn], [inv_xd])
    (yfrac,) = T.fp2_mul_many([yn], [inv_yd])
    (Y,) = T.fp2_mul_many([y], [yfrac])
    return _stable(X), _stable(Y)


def _pt_stable(p):
    """Reduce every Jacobian coordinate to the stable bound class."""
    red = lambda c: F.relabel(F.guard_le(c, 2.0), 2.0)  # noqa: E731
    return tuple(T.map_lfp(red, c) for c in p[:3]) + (p[3],)


def clear_cofactor_g2(xy):
    """h_eff * P = [x^2 - x - 1]P + [x - 1]psi(P) + psi^2([2]P), with |x|
    ladders and sign-corrected adds (x < 0).  Affine in, Jacobian out."""
    xy = (_stable(xy[0]), _stable(xy[1]))
    bits = P.X_ABS_BITS
    ops = P.FP2_OPS
    Pj = P.from_affine(ops, xy)
    absxP = P.scalar_mul_bits(ops, Pj, bits)  # [|x|]P
    xP = _pt_stable(P.pt_neg(ops, absxP))  # [x]P
    absx_xP = P.scalar_mul_bits(ops, xP, bits)  # [|x|][x]P
    x2P = P.pt_neg(ops, absx_xP)  # [x^2]P
    acc = P.jac_add(ops, x2P, P.pt_neg(ops, xP))  # [x^2 - x]P
    acc = P.jac_add(ops, acc, P.pt_neg(ops, Pj))  # - P
    psiPj = _pt_stable(P.from_affine(ops, P.psi_affine(xy)))
    x_psi = P.pt_neg(ops, P.scalar_mul_bits(ops, psiPj, bits))
    acc = P.jac_add(ops, acc, x_psi)
    acc = P.jac_add(ops, acc, P.pt_neg(ops, psiPj))
    twoP_aff = P.to_affine(ops, P.jac_double(ops, Pj), T.fp2_inv)
    psi2_aff = P.psi_affine(P.psi_affine(twoP_aff))
    return P.jac_add(ops, acc, P.from_affine(ops, psi2_aff))


def map_to_g2(u0, u1):
    """hash_to_curve minus the hashing: (u0, u1) Fp2 batches -> affine G2."""
    q0 = iso_map_g2(sswu_g2(u0))
    q1 = iso_map_g2(sswu_g2(u1))
    s = P.jac_add(P.FP2_OPS, P.from_affine(P.FP2_OPS, q0), P.from_affine(P.FP2_OPS, q1))
    g = clear_cofactor_g2(P.to_affine(P.FP2_OPS, s, T.fp2_inv))
    return P.to_affine(P.FP2_OPS, g, T.fp2_inv)
