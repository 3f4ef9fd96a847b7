"""Batched optimal-ate pairing (port of jax_backend/pairing.py).

One Miller loop per (G1, G2) pair along the batch axis, run as 63 fused
doubling steps and 63 fused addition steps (miller_kernel.py), a log-depth GT
product over the batch, and one final exponentiation with the cubed hard
part 3*hard = (x-1)^2 (x+p) (x^2+p^2-1) + 3.
"""

from __future__ import annotations

import torch

from .. import params
from . import fp as F
from . import tower as T


def miller_loop(p_aff, q_aff):
    """Batched Miller loop over affine G1 points (xp, yp) and affine twist
    points ((x2c0, x2c1), (y2c0, y2c1)); the trailing axis is the batch.
    No input may be infinity (the host rejects those before pairing)."""
    from . import miller_kernel

    return miller_kernel.miller_loop_fused(p_aff, q_aff)


def fp12_one_like_from_fp2(x2):
    z = T.fp2_zero_like(x2)
    o = T.fp2_one_like(x2)
    return ((o, z, z), (z, z, z))


def gt_product(f):
    """Reduce the trailing batch axis of an Fp12 by multiplication
    (log-depth tree, padded with ones to a power of two)."""
    ref = f[0][0][0].limbs
    B = ref.shape[-1]
    target = 1 << max(1, (B - 1).bit_length())
    if target != B:
        shape = ref.shape[:-1] + (target - B,)
        zero = F.LFp(torch.zeros(shape, dtype=ref.dtype, device=ref.device), 0.0)
        one = F.LFp(F.bcast("ONE", shape[1:], ref.device), 1.0)
        z2, o2 = (zero, zero), (one, zero)
        pad = ((o2, z2, z2), (z2, z2, z2))
        f = T.map2_lfp(
            lambda a, b: F.LFp(torch.cat([a.limbs, b.limbs], dim=-1), max(a.bound, b.bound)),
            f, pad,
        )
    n = target
    while n > 1:
        half = n // 2
        lo = T.map_lfp(lambda a: F.LFp(a.limbs[..., :half], a.bound), f)
        hi = T.map_lfp(lambda a: F.LFp(a.limbs[..., half : 2 * half], a.bound), f)
        f = T.fp12_mul(lo, hi)
        n = half
    return f


def _pow_signed(a, e: int):
    """a^e on the cyclotomic subgroup (negative e via conjugation)."""
    if e < 0:
        return T.fp12_conj(T.fp12_pow(a, -e))
    return T.fp12_pow(a, e)


def final_exp_is_one(f):
    """f^((p^12 - 1) / r) == 1, over the batch shape of f: the easy part,
    then the cubed hard part with 64-bit |x| exponentiations."""
    x = params.X
    m = T.fp12_mul(T.fp12_conj(f), T.fp12_inv(f))
    m = T.fp12_mul(T.fp12_frobenius_n(m, 2), m)
    a = _pow_signed(m, x - 1)
    a = _pow_signed(a, x - 1)
    b = T.fp12_mul(T.fp12_frobenius(a), _pow_signed(a, x))
    c = T.fp12_mul(
        T.fp12_mul(_pow_signed(_pow_signed(b, x), x), T.fp12_frobenius_n(b, 2)),
        T.fp12_conj(b),
    )
    out = T.fp12_mul(c, T.fp12_mul(T.fp12_sqr(m), m))
    return T.fp12_is_one(out)


def pairing_check(p_aff, q_aff):
    """True iff prod_i e(P_i, Q_i) == 1 over the trailing batch axis."""
    return final_exp_is_one(gt_product(miller_loop(p_aff, q_aff)))
