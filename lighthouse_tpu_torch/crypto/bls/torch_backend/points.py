"""Branchless Jacobian point arithmetic over Fp (G1) and Fp2 (G2), batched.

Port of jax_backend/points.py.  A point is a tuple ``(X, Y, Z, inf)``:
Jacobian coordinates (x = X/Z^2, y = Y/Z^3) in the lazy LFp representation
plus an explicit boolean infinity flag over the batch.

* ``jac_add`` is complete (doubling and cancellation via canonical equality,
  infinities via the flags): for adversarial summands.
* ``jac_add_fast`` handles only the flags: valid inside double-and-add with a
  prime-order base and a scalar below the order, where the accumulator is
  never +-P.

Every point-producing op ends by reducing its coordinates (stacked), so loop
carries keep a stable static bound.
"""

from __future__ import annotations

import torch

from .. import endo as _endo
from .. import params
from . import fp as F
from . import tower as T


class _FpOps:
    add = staticmethod(F.fp_add)
    sub = staticmethod(F.fp_sub)
    neg = staticmethod(F.fp_neg)
    mul = staticmethod(F.mont_mul)
    sqr = staticmethod(F.mont_sqr)
    mul_many = staticmethod(T.mm_many)
    select = staticmethod(F.fp_select)
    eq = staticmethod(F.fp_eq)
    zero_like = staticmethod(F.zero_like)
    one_like = staticmethod(F.one_like)
    reduce_many = staticmethod(T.reduce_many)
    ncoords = 1

    @staticmethod
    def dbl(a):
        return F.fp_add(a, a)

    @staticmethod
    def lanes(a):
        return [a]

    @staticmethod
    def unlanes(lanes):
        return lanes[0]

    @staticmethod
    def first(a):
        return a


class _Fp2Ops:
    add = staticmethod(T.fp2_add)
    sub = staticmethod(T.fp2_sub)
    neg = staticmethod(T.fp2_neg)
    mul = staticmethod(T.fp2_mul)
    sqr = staticmethod(T.fp2_sqr)
    mul_many = staticmethod(T.fp2_mul_many)
    select = staticmethod(T.fp2_select)
    eq = staticmethod(T.fp2_eq)
    zero_like = staticmethod(T.fp2_zero_like)
    one_like = staticmethod(T.fp2_one_like)
    dbl = staticmethod(T.fp2_dbl)
    reduce_many = staticmethod(T.reduce_many)
    ncoords = 2

    @staticmethod
    def lanes(a):
        return [a[0], a[1]]

    @staticmethod
    def unlanes(lanes):
        return (lanes[0], lanes[1])

    @staticmethod
    def first(a):
        return a[0]


FP_OPS = _FpOps
FP2_OPS = _Fp2Ops


def _flags(ops, x, value: bool):
    limbs = ops.first(x).limbs
    return torch.full(limbs.shape[1:], value, dtype=torch.bool, device=limbs.device)


def _reduce_coords(ops, coords):
    """Stacked reduction of a list of field elements to stable bound 2."""
    lanes = []
    for c in coords:
        lanes += ops.lanes(c)
    red = ops.reduce_many(lanes)
    n = ops.ncoords
    return [ops.unlanes(red[i * n : (i + 1) * n]) for i in range(len(coords))]


def pt_select(ops, mask, p, q):
    out = tuple(ops.select(mask, a, b) for a, b in zip(p[:3], q[:3]))
    return out + (torch.where(mask, p[3], q[3]),)


def pt_infinity_like(ops, p):
    one = ops.one_like(p[0])
    return (one, one, ops.zero_like(p[0]), _flags(ops, p[0], True))


def from_affine(ops, xy):
    x, y = xy
    return (x, y, ops.one_like(x), _flags(ops, x, False))


def pt_neg(ops, p):
    return (p[0], ops.neg(p[1]), p[2], p[3])


def jac_double(ops, p):
    """2P on the a = 0 curve; infinity propagates via the flag."""
    X, Y, Z = p[0], p[1], p[2]
    A, B, YZ = ops.mul_many([X, Y, Y], [X, Y, Z])
    E = ops.add(ops.dbl(A), A)
    XB = ops.add(X, B)
    C, t, Fv = ops.mul_many([B, XB, E], [B, XB, E])
    D = ops.dbl(ops.sub(ops.sub(t, A), C))
    X3 = ops.sub(Fv, ops.dbl(D))
    (m,) = ops.mul_many([E], [ops.sub(D, X3)])
    C8 = ops.dbl(ops.dbl(ops.dbl(C)))
    Y3 = ops.sub(m, C8)
    Z3 = ops.dbl(YZ)
    X3, Y3, Z3 = _reduce_coords(ops, [X3, Y3, Z3])
    return (X3, Y3, Z3, p[3])


def _raw_add(ops, p1, p2):
    """Core Jacobian addition; undefined when P1 = +-P2 or an input is
    infinity.  Returns reduced coordinates and (U1, U2, S1, S2)."""
    X1, Y1, Z1 = p1[0], p1[1], p1[2]
    X2, Y2, Z2 = p2[0], p2[1], p2[2]
    Z1Z1, Z2Z2 = ops.mul_many([Z1, Z2], [Z1, Z2])
    U1, U2, t1, t2 = ops.mul_many([X1, X2, Y1, Y2], [Z2Z2, Z1Z1, Z2, Z1])
    S1, S2 = ops.mul_many([t1, t2], [Z2Z2, Z1Z1])
    H = ops.sub(U2, U1)
    rr = ops.dbl(ops.sub(S2, S1))
    H2 = ops.dbl(H)
    Zs = ops.add(Z1, Z2)
    I, rr2, W = ops.mul_many([H2, rr, Zs], [H2, rr, Zs])
    J, V = ops.mul_many([H, U1], [I, I])
    X3 = ops.sub(ops.sub(rr2, J), ops.dbl(V))
    m1, m2, Z3 = ops.mul_many(
        [rr, S1, ops.sub(ops.sub(W, Z1Z1), Z2Z2)],
        [ops.sub(V, X3), J, H],
    )
    Y3 = ops.sub(m1, ops.dbl(m2))
    X3, Y3, Z3 = _reduce_coords(ops, [X3, Y3, Z3])
    return (X3, Y3, Z3), (U1, U2, S1, S2)


def jac_add_fast(ops, p1, p2):
    """P1 + P2 without coincidence detection; infinity via flags only."""
    (X3, Y3, Z3), _ = _raw_add(ops, p1, p2)
    inf1, inf2 = p1[3], p2[3]
    both = inf1 & inf2
    out = (X3, Y3, Z3, both)
    out = pt_select(ops, inf2, (p1[0], p1[1], p1[2], both), out)
    return pt_select(ops, inf1, (p2[0], p2[1], p2[2], both), out)


def jac_add(ops, p1, p2):
    """Complete P1 + P2: doubling, cancellation and infinity via selects."""
    (X3, Y3, Z3), (U1, U2, S1, S2) = _raw_add(ops, p1, p2)
    inf1, inf2 = p1[3], p2[3]
    both_finite = ~(inf1 | inf2)
    ex = ops.eq(U1, U2)
    ey = ops.eq(S1, S2)
    is_dbl = ex & ey & both_finite
    cancels = ex & ~ey & both_finite
    inf_out = (inf1 & inf2) | cancels
    out = (X3, Y3, Z3, inf_out)
    dblp = jac_double(ops, p1)
    out = pt_select(ops, is_dbl, (dblp[0], dblp[1], dblp[2], inf_out), out)
    out = pt_select(ops, inf2, (p1[0], p1[1], p1[2], inf_out), out)
    return pt_select(ops, inf1, (p2[0], p2[1], p2[2], inf_out), out)


def jac_eq(ops, p1, p2):
    """Equality including infinity, via cross-multiplication."""
    X1, Y1, Z1 = p1[0], p1[1], p1[2]
    X2, Y2, Z2 = p2[0], p2[1], p2[2]
    Z1Z1, Z2Z2, t1, t2 = ops.mul_many([Z1, Z2, Y1, Y2], [Z1, Z2, Z2, Z1])
    a, b, c, d = ops.mul_many([X1, X2, t1, t2], [Z2Z2, Z1Z1, Z2Z2, Z1Z1])
    ex = ops.eq(a, b)
    ey = ops.eq(c, d)
    inf1, inf2 = p1[3], p2[3]
    return (inf1 & inf2) | (~(inf1 | inf2) & ex & ey)


def pt_relabel(ops, p, bound: float):
    """Pin coordinate bounds (upward) for loop-carry stability."""
    return tuple(T.map_lfp(lambda c: F.relabel(c, bound), c) for c in p[:3]) + (p[3],)


def scalar_mul_bits(ops, p, bits):
    """[k]P, double-and-always-add MSB first with the fast add (p has prime
    order r and k < 2^64 << r).  ``bits`` is either a (nbits, *batch) int
    tensor of per-lane scalar bits (each step selects per lane, as the JAX
    scan does) or a list of ints for one scalar shared by every lane (the
    add runs only where the bit is set — the limbs the select would keep)."""
    p = pt_relabel(ops, p, 2.0)
    acc = pt_relabel(ops, pt_infinity_like(ops, p), 2.0)
    for bit in bits:
        acc = jac_double(ops, acc)
        if isinstance(bit, int):
            if bit:
                acc = jac_add_fast(ops, acc, p)
        else:
            acc = pt_select(ops, bit == 1, jac_add_fast(ops, acc, p), acc)
    return acc


def to_affine(ops, p, inv_fn):
    """Jacobian -> affine (x, y); under the infinity flag the coordinates
    are garbage — callers consult the flag (p[3])."""
    X, Y, Z = p[0], p[1], p[2]
    zinv = inv_fn(Z)
    zinv2 = ops.sqr(zinv)
    (x,) = ops.mul_many([X], [zinv2])
    (y,) = ops.mul_many([ops.mul(Y, zinv2)], [zinv])
    return (x, y)


# ---------------------------------------------------------------------------
# G2 endomorphism + fast subgroup check (constants from endo.py)
# ---------------------------------------------------------------------------


def psi_affine(xy):
    """psi on an affine G2 point ((xc0, xc1), (yc0, yc1))."""
    x, y = xy
    limbs = x[0].limbs
    cx = T.fp2_const(_endo.PSI_CX, limbs.shape[1:], limbs.device)
    cy = T.fp2_const(_endo.PSI_CY, limbs.shape[1:], limbs.device)
    px, py = T.fp2_mul_many([T.fp2_conj(x), T.fp2_conj(y)], [cx, cy])
    return (px, py)


X_ABS_BITS = [int(c) for c in bin(abs(params.X))[2:]]


def g2_subgroup_check(xy):
    """Scott's test: Q in G2 iff psi(Q) == [x]Q (x < 0: compare with the
    negated |x| multiple).  Inputs must be on the curve."""
    Q = from_affine(FP2_OPS, xy)
    xQ = scalar_mul_bits(FP2_OPS, Q, X_ABS_BITS)  # [|x|]Q
    psiQ = from_affine(FP2_OPS, psi_affine(xy))
    return jac_eq(FP2_OPS, psiQ, pt_neg(FP2_OPS, xQ))


# ---------------------------------------------------------------------------
# Host codecs: oracle affine points <-> device tensors
# ---------------------------------------------------------------------------


def g1_encode(points, device) -> tuple:
    """Oracle affine G1 points (no infinities) -> affine (x, y)."""
    return (F.lfp_encode([p[0].v for p in points], device),
            F.lfp_encode([p[1].v for p in points], device))


def g2_encode(points, device) -> tuple:
    return (T.fp2_encode([p[0] for p in points], device),
            T.fp2_encode([p[1] for p in points], device))


def g1_decode_jac(p) -> list:
    """Jacobian G1 (X, Y, Z, inf) -> oracle affine points (None = inf)."""
    from .. import curve as C
    from .. import fields as O

    Xs, Ys, Zs = F.decode_mont(p[0]), F.decode_mont(p[1]), F.decode_mont(p[2])
    inf = p[3].reshape(-1).tolist()
    out = []
    for x, y, z, isinf in zip(Xs, Ys, Zs, inf):
        if isinf or z == 0:
            out.append(None)
        else:
            out.append(C.from_jacobian((O.Fp(x), O.Fp(y), O.Fp(z)), O.Fp))
    return out


def g2_decode_jac(p) -> list:
    """Jacobian G2 (X, Y, Z, inf) -> oracle affine points (None = inf)."""
    from .. import curve as C
    from .. import fields as O

    Xs, Ys, Zs = T.fp2_decode(p[0]), T.fp2_decode(p[1]), T.fp2_decode(p[2])
    inf = p[3].reshape(-1).tolist()
    out = []
    for x, y, z, isinf in zip(Xs, Ys, Zs, inf):
        if isinf or z.is_zero():
            out.append(None)
        else:
            out.append(C.from_jacobian((x, y, z), O.Fp2))
    return out
