"""Batched Fp2 / Fp6 / Fp12 tower on limb tensors (port of jax_backend/tower.py).

    Fp2  = Fp[u]  / (u^2 + 1)
    Fp6  = Fp2[v] / (v^3 - xi),  xi = u + 1
    Fp12 = Fp6[w] / (w^2 - v)

Elements are nested tuples of ``LFp``: Fp2 = (c0, c1), Fp6 = three Fp2,
Fp12 = two Fp6.  Every group of independent base-field products funnels
through ONE ``mont_mul`` on lanes concatenated along the batch axis
(``mm_many``): one stacked product is one kernel launch, which is what keeps
the launch count of an eager path in check.  Frobenius coefficients come
from the oracle's computed table (fields.FROB_GAMMA).
"""

from __future__ import annotations

import torch

from .. import fields as _oracle
from . import fp as F

# ---------------------------------------------------------------------------
# Stacking helpers: k independent fp ops as one wide op
# ---------------------------------------------------------------------------


def _cat(xs):
    """Stack LFp lanes along the (last) batch axis; bound = max."""
    if len(xs) == 1:
        return xs[0]
    return F.LFp(torch.cat([x.limbs for x in xs], dim=-1), max(x.bound for x in xs))


def _split(x, k):
    if k == 1:
        return [x]
    return [F.LFp(c, x.bound) for c in x.limbs.chunk(k, dim=-1)]


def mm_many(As, Bs):
    """[a_i * b_i] via one Montgomery multiply on stacked lanes; lanes with
    oversized bounds are reduced first (the stacked bound is the max)."""
    As = [F.guard_le(a, 40.0) for a in As]
    Bs = [F.guard_le(b, 40.0) for b in Bs]
    return _split(F.mont_mul(_cat(As), _cat(Bs)), len(As))


def add_many(As, Bs):
    return _split(F.fp_add(_cat(As), _cat(Bs)), len(As))


def sub_many(As, Bs):
    return _split(F.fp_sub(_cat(As), _cat(Bs)), len(As))


def reduce_many(xs):
    """Stacked value-preserving reduction: every element back to bound 2."""
    return _split(F.fp_reduce(_cat(xs)), len(xs))


def fp2_reduce(a):
    c = reduce_many([a[0], a[1]])
    return (c[0], c[1])


def fp6_reduce(a):
    c = reduce_many([a[0][0], a[0][1], a[1][0], a[1][1], a[2][0], a[2][1]])
    return ((c[0], c[1]), (c[2], c[3]), (c[4], c[5]))


def fp12_lanes(a):
    return [
        a[0][0][0], a[0][0][1], a[0][1][0], a[0][1][1], a[0][2][0], a[0][2][1],
        a[1][0][0], a[1][0][1], a[1][1][0], a[1][1][1], a[1][2][0], a[1][2][1],
    ]


def fp12_from_lanes(c):
    return (
        ((c[0], c[1]), (c[2], c[3]), (c[4], c[5])),
        ((c[6], c[7]), (c[8], c[9]), (c[10], c[11])),
    )


def fp12_reduce(a):
    return fp12_from_lanes(reduce_many(fp12_lanes(a)))


# ---------------------------------------------------------------------------
# Fp2
# ---------------------------------------------------------------------------


def fp2_zero_like(x2):
    return (F.zero_like(x2[0]), F.zero_like(x2[0]))


def fp2_one_like(x2):
    return (F.one_like(x2[0]), F.zero_like(x2[0]))


def fp2_add(a, b):
    c = add_many([a[0], a[1]], [b[0], b[1]])
    return (c[0], c[1])


def fp2_sub(a, b):
    c = sub_many([a[0], a[1]], [b[0], b[1]])
    return (c[0], c[1])


def fp2_neg(a):
    return (F.fp_neg(a[0]), F.fp_neg(a[1]))


def fp2_dbl(a):
    return fp2_add(a, a)


def fp2_guard(a, m: float = 11.0):
    """Reduce an Fp2 operand whose coords exceed bound m (keeps the
    Karatsuba sum lanes inside mont_mul's input budget)."""
    if max(a[0].bound, a[1].bound) > m:
        return fp2_reduce(a)
    return a


def fp2_mul(a, b):
    """Karatsuba with one stacked base multiply (3 lanes)."""
    a, b = fp2_guard(a), fp2_guard(b)
    s = add_many([a[0], b[0]], [a[1], b[1]])  # a0+a1, b0+b1
    t0, t1, t2 = mm_many([a[0], a[1], s[0]], [b[0], b[1], s[1]])
    c = sub_many([t0, t2], [t1, F.fp_add(t0, t1)])
    return (c[0], c[1])


def fp2_sqr(a):
    """(a0-a1)(a0+a1), 2 a0 a1 — one stacked multiply (2 lanes)."""
    a = fp2_guard(a)
    d = F.fp_sub(a[0], a[1])
    s = F.fp_add(a[0], a[1])
    c0, t = mm_many([d, a[0]], [s, a[1]])
    return (c0, F.fp_add(t, t))


def fp2_conj(a):
    return (a[0], F.fp_neg(a[1]))


def fp2_mul_by_nonresidue(a):
    """Multiply by xi = 1 + u."""
    return (F.fp_sub(a[0], a[1]), F.fp_add(a[0], a[1]))


def fp2_inv(a):
    a = fp2_guard(a)
    sq = mm_many([a[0], a[1]], [a[0], a[1]])
    ninv = F.fp_inv(F.fp_add(sq[0], sq[1]))
    c = mm_many([a[0], a[1]], [ninv, ninv])
    return (c[0], F.fp_neg(c[1]))


def fp2_is_zero(a):
    return F.fp_is_zero(a[0]) & F.fp_is_zero(a[1])


def fp2_eq(a, b):
    return F.fp_eq(a[0], b[0]) & F.fp_eq(a[1], b[1])


def fp2_select(mask, a, b):
    return (F.fp_select(mask, a[0], b[0]), F.fp_select(mask, a[1], b[1]))


def fp2_const(oracle_fp2: "_oracle.Fp2", batch_shape, device):
    """Oracle Fp2 constant -> broadcast Montgomery limb pair."""
    shape = (F.N,) + (1,) * len(batch_shape)
    out = []
    for v in (oracle_fp2.c0, oracle_fp2.c1):
        col = F.int_col(v * F.R_INT % F.P_INT, str(torch.device(device)))
        out.append(F.LFp(col.reshape(shape).expand((F.N,) + tuple(batch_shape)), 1.0))
    return (out[0], out[1])


def fp2_mul_many(As, Bs):
    """[a_i * b_i] for Fp2 pairs via ONE stacked base multiply (3k lanes)."""
    k = len(As)
    if k == 1:
        return [fp2_mul(As[0], Bs[0])]
    As = [fp2_guard(a) for a in As]
    Bs = [fp2_guard(b) for b in Bs]
    sums = add_many(
        [a[0] for a in As] + [b[0] for b in Bs],
        [a[1] for a in As] + [b[1] for b in Bs],
    )
    a_sums, b_sums = sums[:k], sums[k:]
    lanes_a, lanes_b = [], []
    for a, b, sa, sb in zip(As, Bs, a_sums, b_sums):
        lanes_a += [a[0], a[1], sa]
        lanes_b += [b[0], b[1], sb]
    prods = mm_many(lanes_a, lanes_b)
    t0s, t1s, ss = prods[0::3], prods[1::3], prods[2::3]
    t01s = add_many(t0s, t1s)
    c0s = sub_many(t0s, t1s)
    c1s = sub_many(ss, t01s)
    return list(zip(c0s, c1s))


# ---------------------------------------------------------------------------
# Fp6
# ---------------------------------------------------------------------------


def _fp6_coords(a):
    return [a[0][0], a[0][1], a[1][0], a[1][1], a[2][0], a[2][1]]


def fp6_add(a, b):
    c = add_many(_fp6_coords(a), _fp6_coords(b))
    return ((c[0], c[1]), (c[2], c[3]), (c[4], c[5]))


def fp6_sub(a, b):
    c = sub_many(_fp6_coords(a), _fp6_coords(b))
    return ((c[0], c[1]), (c[2], c[3]), (c[4], c[5]))


def fp6_neg(a):
    return tuple(fp2_neg(x) for x in a)


def fp6_zero_like(a):
    z = fp2_zero_like(a[0])
    return (z, z, z)


def fp6_one_like(a):
    return (fp2_one_like(a[0]), fp2_zero_like(a[0]), fp2_zero_like(a[0]))


def fp6_mul(a, b):
    """Toom/Karatsuba with all six Fp2 products in one stacked multiply."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    s = add_many(
        [a1[0], a1[1], b1[0], b1[1], a0[0], a0[1], b0[0], b0[1], a0[0], a0[1], b0[0], b0[1]],
        [a2[0], a2[1], b2[0], b2[1], a1[0], a1[1], b1[0], b1[1], a2[0], a2[1], b2[0], b2[1]],
    )
    a12, b12 = (s[0], s[1]), (s[2], s[3])
    a01, b01 = (s[4], s[5]), (s[6], s[7])
    a02, b02 = (s[8], s[9]), (s[10], s[11])
    t0, t1, t2, u12, u01, u02 = fp2_mul_many(
        [a0, a1, a2, a12, a01, a02], [b0, b1, b2, b12, b01, b02]
    )
    d1 = sub_many(
        [u12[0], u12[1], u01[0], u01[1], u02[0], u02[1]],
        [t1[0], t1[1], t0[0], t0[1], t0[0], t0[1]],
    )
    d2 = sub_many(d1, [t2[0], t2[1], t1[0], t1[1], t2[0], t2[1]])
    X = (d2[0], d2[1])  # u12 - t1 - t2
    Y = (d2[2], d2[3])  # u01 - t0 - t1
    Z = (d2[4], d2[5])  # u02 - t0 - t2
    xiX = fp2_mul_by_nonresidue(X)
    xit2 = fp2_mul_by_nonresidue(t2)
    e = add_many(
        [xiX[0], xiX[1], Y[0], Y[1], Z[0], Z[1]],
        [t0[0], t0[1], xit2[0], xit2[1], t1[0], t1[1]],
    )
    return fp6_reduce(((e[0], e[1]), (e[2], e[3]), (e[4], e[5])))


def fp6_sqr(a):
    return fp6_mul(a, a)


def fp6_mul_by_v(a):
    return (fp2_mul_by_nonresidue(a[2]), a[0], a[1])


def fp6_inv(a):
    a0, a1, a2 = a
    sq0, sq1, sq2, m12, m01, m02 = fp2_mul_many(
        [a0, a2, a1, a1, a0, a0], [a0, a2, a1, a2, a1, a2]
    )
    t0 = fp2_sub(sq0, fp2_mul_by_nonresidue(m12))
    t1 = fp2_sub(fp2_mul_by_nonresidue(sq1), m01)
    t2 = fp2_sub(sq2, m02)
    p0, p1, p2 = fp2_mul_many([a0, a2, a1], [t0, t1, t2])
    denom = fp2_add(
        p0, fp2_add(fp2_mul_by_nonresidue(p1), fp2_mul_by_nonresidue(p2))
    )
    dinv = fp2_inv(denom)
    c = fp2_mul_many([t0, t1, t2], [dinv, dinv, dinv])
    return fp6_reduce((c[0], c[1], c[2]))


def fp6_select(mask, a, b):
    return tuple(fp2_select(mask, x, y) for x, y in zip(a, b))


def fp6_eq(a, b):
    return fp2_eq(a[0], b[0]) & fp2_eq(a[1], b[1]) & fp2_eq(a[2], b[2])


# ---------------------------------------------------------------------------
# Fp12
# ---------------------------------------------------------------------------


def fp12_one_like(a):
    return (fp6_one_like(a[0]), fp6_zero_like(a[0]))


def fp12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fp6_mul(a0, b0)
    t1 = fp6_mul(a1, b1)
    u = fp6_mul(fp6_add(a0, a1), fp6_add(b0, b1))
    c0 = fp6_add(t0, fp6_mul_by_v(t1))
    c1 = fp6_sub(fp6_sub(u, t0), t1)
    return fp12_reduce((c0, c1))


def fp12_sqr(a):
    a0, a1 = a
    t = fp6_mul(a0, a1)
    c0 = fp6_sub(
        fp6_sub(fp6_mul(fp6_add(a0, a1), fp6_add(a0, fp6_mul_by_v(a1))), t),
        fp6_mul_by_v(t),
    )
    return fp12_reduce((c0, fp6_add(t, t)))


def fp12_conj(a):
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a):
    a0, a1 = a
    denom = fp6_sub(fp6_sqr(a0), fp6_mul_by_v(fp6_sqr(a1)))
    dinv = fp6_inv(denom)
    return fp12_reduce((fp6_mul(a0, dinv), fp6_neg(fp6_mul(a1, dinv))))


def fp12_select(mask, a, b):
    return (fp6_select(mask, a[0], b[0]), fp6_select(mask, a[1], b[1]))


def fp12_eq(a, b):
    return fp6_eq(a[0], b[0]) & fp6_eq(a[1], b[1])


def fp12_is_one(a):
    return fp12_eq(a, fp12_one_like(a))


def fp12_mul_by_023(f, l0, l2, l3):
    """Sparse line multiplication (oracle: Fp12.mul_by_023), all fifteen Fp2
    products in one stacked multiply."""
    a0, a1 = f
    s = fp6_add(a0, a1)
    l23 = fp2_add(l2, l3)
    prods = fp2_mul_many(
        [
            a0[0], a0[2], a0[0], a0[1], a0[1], a0[2],  # t0 terms
            a1[2], a1[0], a1[1],                        # t1 terms
            s[0], s[2], s[0], s[1], s[1], s[2],         # t2 terms
        ],
        [
            l0, l2, l2, l0, l2, l0,
            l3, l3, l3,
            l0, l23, l23, l0, l23, l0,
        ],
    )
    (p00, p02, q00, q01, r01, r02,
     w2, w0, w1,
     s00, s02, v00, v01, x01, x02) = prods
    t0 = (
        fp2_add(p00, fp2_mul_by_nonresidue(p02)),
        fp2_add(q00, q01),
        fp2_add(r01, r02),
    )
    t1 = (fp2_mul_by_nonresidue(w2), w0, w1)
    t2 = (
        fp2_add(s00, fp2_mul_by_nonresidue(s02)),
        fp2_add(v00, v01),
        fp2_add(x01, x02),
    )
    return fp12_reduce(
        (fp6_add(t0, fp6_mul_by_v(t1)), fp6_sub(fp6_sub(t2, t0), t1))
    )


def _gamma(i: int, a):
    x = a[0][0][0].limbs
    return fp2_const(_oracle.FROB_GAMMA[i], x.shape[1:], x.device)


def fp12_frobenius(a):
    c0, c1 = a
    g1, g2, g4 = _gamma(1, a), _gamma(2, a), _gamma(4, a)
    g1g2 = fp2_mul(g2, g1)
    g1g4 = fp2_mul(g4, g1)
    m = fp2_mul_many(
        [fp2_conj(c0[1]), fp2_conj(c0[2]), fp2_conj(c1[0]), fp2_conj(c1[1]), fp2_conj(c1[2])],
        [g2, g4, g1, g1g2, g1g4],
    )
    return fp12_reduce(((fp2_conj(c0[0]), m[0], m[1]), (m[2], m[3], m[4])))


def fp12_frobenius_n(a, n: int):
    for _ in range(n % 12):
        a = fp12_frobenius(a)
    return a


def map_lfp(f, x):
    """Apply f to every LFp leaf of a nested-tuple field element."""
    if isinstance(x, F.LFp):
        return f(x)
    return tuple(map_lfp(f, c) for c in x)


def map2_lfp(f, x, y):
    if isinstance(x, F.LFp):
        return f(x, y)
    return tuple(map2_lfp(f, a, b) for a, b in zip(x, y))


def fp12_relabel(x, bound: float):
    """Pin every coordinate's static bound (upward only)."""
    return map_lfp(lambda c: F.relabel(c, bound), x)


def fp12_pow(a, e: int):
    """a^e for a static non-negative exponent, square-and-multiply MSB
    first.  The multiply runs only where the (host-constant) bit is set;
    the carried bound is pinned to 2.0 every step, as in the JAX scan."""
    assert e >= 0
    if e == 0:
        return fp12_one_like(a)
    a = map_lfp(lambda c: F.guard_le(c, 2.0), a)
    acc = fp12_relabel(fp12_one_like(a), 2.0)
    for bit in bin(e)[2:]:
        acc = fp12_sqr(acc)
        if bit == "1":
            acc = fp12_mul(acc, a)
        acc = fp12_relabel(acc, 2.0)
    return acc


# ---------------------------------------------------------------------------
# Host codecs (oracle <-> device)
# ---------------------------------------------------------------------------


def fp2_encode(vals: list["_oracle.Fp2"], device) -> tuple:
    return (F.lfp_encode([v.c0 for v in vals], device),
            F.lfp_encode([v.c1 for v in vals], device))


def fp2_decode(x2) -> list["_oracle.Fp2"]:
    return [_oracle.Fp2(a, b) for a, b in zip(F.decode_mont(x2[0]), F.decode_mont(x2[1]))]


def fp12_encode(vals: list["_oracle.Fp12"], device) -> tuple:
    c0 = tuple(fp2_encode([getattr(v.c0, c) for v in vals], device) for c in ("c0", "c1", "c2"))
    c1 = tuple(fp2_encode([getattr(v.c1, c) for v in vals], device) for c in ("c0", "c1", "c2"))
    return (c0, c1)


def fp12_decode(x12) -> list["_oracle.Fp12"]:
    c0 = [fp2_decode(x12[0][i]) for i in range(3)]
    c1 = [fp2_decode(x12[1][i]) for i in range(3)]
    return [
        _oracle.Fp12(
            _oracle.Fp6(c0[0][j], c0[1][j], c0[2][j]),
            _oracle.Fp6(c1[0][j], c1[1][j], c1[2][j]),
        )
        for j in range(len(c0[0]))
    ]
