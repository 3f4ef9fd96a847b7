"""BLS12-381 scalar field (Fr) helpers for KZG polynomial math.

The polynomial side of KZG lives in Fr (the curve order), not Fp: blobs ARE
polynomials in evaluation form over the 4096th roots of unity in Fr.
"""

from __future__ import annotations

from functools import lru_cache

from ..bls.params import R as BLS_MODULUS  # curve order r

PRIMITIVE_ROOT = 7  # generator of Fr* (standard for BLS12-381)


def inv(x: int) -> int:
    return pow(x, BLS_MODULUS - 2, BLS_MODULUS)


def div(a: int, b: int) -> int:
    return a * inv(b) % BLS_MODULUS


@lru_cache(maxsize=4)
def roots_of_unity(order: int) -> list[int]:
    """The ``order`` distinct order-th roots of unity, natural order."""
    assert (BLS_MODULUS - 1) % order == 0
    root = pow(PRIMITIVE_ROOT, (BLS_MODULUS - 1) // order, BLS_MODULUS)
    out = [1]
    for _ in range(order - 1):
        out.append(out[-1] * root % BLS_MODULUS)
    assert out[-1] * root % BLS_MODULUS == 1
    return out


def bit_reversal_permutation(seq: list) -> list:
    """Reorder by bit-reversed index (the evaluation-form ordering the
    ceremony setup and blobs use)."""
    n = len(seq)
    bits = n.bit_length() - 1
    assert 1 << bits == n, "length must be a power of two"
    return [seq[int(format(i, f"0{bits}b")[::-1], 2)] for i in range(n)]


@lru_cache(maxsize=4)
def brp_roots_of_unity(order: int) -> tuple[int, ...]:
    return tuple(bit_reversal_permutation(roots_of_unity(order)))


def batch_inv(xs: list[int]) -> list[int]:
    """Montgomery batch inversion: one Fermat inverse + 3(n-1) mults.
    Zero inputs map to zero (callers exclude the on-root case upstream)."""
    n = len(xs)
    prefix = [0] * n
    acc = 1
    for i, x in enumerate(xs):
        prefix[i] = acc
        if x:
            acc = acc * x % BLS_MODULUS
    inv_acc = inv(acc)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        if xs[i]:
            out[i] = inv_acc * prefix[i] % BLS_MODULUS
            inv_acc = inv_acc * xs[i] % BLS_MODULUS
    return out
