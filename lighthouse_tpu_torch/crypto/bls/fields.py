"""Pure-Python BLS12-381 field tower: Fp -> Fp2 -> Fp6 -> Fp12.

This is the *reference* arithmetic backend: the correctness anchor against
which the PyTorch limb kernels (torch_backend/) are differentially tested, and
the source of every constant table they derive.  It plays the role blst's C/assembly
field code plays for the reference client (reference: crypto/bls/src/impls/
blst.rs uses blst's fp/fp2/fp12 types); here it is deliberately simple Python
over arbitrary-precision ints.

Tower construction (the standard one for BLS12-381):
    Fp2  = Fp[u]  / (u^2 + 1)
    Fp6  = Fp2[v] / (v^3 - xi),  xi = u + 1
    Fp12 = Fp6[w] / (w^2 - v)

Frobenius coefficients are computed at import time from `params.P` (they are
powers of xi), never transcribed.
"""

from __future__ import annotations

from .params import P

# ---------------------------------------------------------------------------
# Fp  — represented as plain ints in [0, P).  Helper functions only.
# ---------------------------------------------------------------------------


def fp_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("inverse of 0 in Fp")
    # CPython's extended-gcd modular inverse: ~9x faster than the Fermat
    # exponentiation for the 381-bit modulus (measured on this image)
    return pow(a, -1, P)


def fp_sqrt(a: int) -> int | None:
    """Square root in Fp (P ≡ 3 mod 4), or None if a is not a QR."""
    if a == 0:
        return 0
    s = pow(a, (P + 1) // 4, P)
    return s if s * s % P == a else None


class Fp:
    """Fp element with the same interface as Fp2/Fp6/Fp12, so curve code can
    be generic over the coordinate field."""

    __slots__ = ("v",)

    def __init__(self, v: int):
        self.v = v % P

    @staticmethod
    def zero() -> "Fp":
        return Fp(0)

    @staticmethod
    def one() -> "Fp":
        return Fp(1)

    def is_zero(self) -> bool:
        return self.v == 0

    def __eq__(self, other) -> bool:
        return isinstance(other, Fp) and self.v == other.v

    def __hash__(self):
        return hash(("Fp", self.v))

    def __repr__(self):
        return f"Fp(0x{self.v:x})"

    def __add__(self, o: "Fp") -> "Fp":
        return Fp(self.v + o.v)

    def __sub__(self, o: "Fp") -> "Fp":
        return Fp(self.v - o.v)

    def __neg__(self) -> "Fp":
        return Fp(-self.v)

    def __mul__(self, o) -> "Fp":
        if isinstance(o, int):
            return Fp(self.v * o)
        return Fp(self.v * o.v)

    __rmul__ = __mul__

    def square(self) -> "Fp":
        return Fp(self.v * self.v)

    def inv(self) -> "Fp":
        return Fp(fp_inv(self.v))

    def pow(self, e: int) -> "Fp":
        if e < 0:
            return self.inv().pow(-e)
        return Fp(pow(self.v, e, P))

    def sqrt(self) -> "Fp | None":
        s = fp_sqrt(self.v)
        return Fp(s) if s is not None else None

    def sgn0(self) -> int:
        return self.v % 2


# ---------------------------------------------------------------------------
# Fp2
# ---------------------------------------------------------------------------


class Fp2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % P
        self.c1 = c1 % P

    # -- constructors ------------------------------------------------------
    @staticmethod
    def zero() -> "Fp2":
        return Fp2(0, 0)

    @staticmethod
    def one() -> "Fp2":
        return Fp2(1, 0)

    # -- predicates --------------------------------------------------------
    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Fp2) and self.c0 == other.c0 and self.c1 == other.c1
        )

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __repr__(self):
        return f"Fp2(0x{self.c0:x}, 0x{self.c1:x})"

    # -- arithmetic --------------------------------------------------------
    def __add__(self, o: "Fp2") -> "Fp2":
        return Fp2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fp2") -> "Fp2":
        return Fp2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fp2":
        return Fp2(-self.c0, -self.c1)

    def __mul__(self, o) -> "Fp2":
        if isinstance(o, int):
            return Fp2(self.c0 * o, self.c1 * o)
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        # (a0 + a1 u)(b0 + b1 u) with u^2 = -1
        return Fp2(a0 * b0 - a1 * b1, a0 * b1 + a1 * b0)

    __rmul__ = __mul__

    def square(self) -> "Fp2":
        a0, a1 = self.c0, self.c1
        # (a0 + a1 u)^2 = (a0-a1)(a0+a1) + 2 a0 a1 u
        return Fp2((a0 - a1) * (a0 + a1), 2 * a0 * a1)

    def inv(self) -> "Fp2":
        a0, a1 = self.c0, self.c1
        norm = (a0 * a0 + a1 * a1) % P
        ninv = fp_inv(norm)
        return Fp2(a0 * ninv, -a1 * ninv)

    def conjugate(self) -> "Fp2":
        return Fp2(self.c0, -self.c1)

    def mul_by_nonresidue(self) -> "Fp2":
        """Multiply by xi = 1 + u."""
        return Fp2(self.c0 - self.c1, self.c0 + self.c1)

    def pow(self, e: int) -> "Fp2":
        if e < 0:
            return self.inv().pow(-e)
        result = Fp2.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def sqrt(self) -> "Fp2 | None":
        """Square root in Fp2 via the norm/trace ('complex') method."""
        if self.is_zero():
            return Fp2.zero()
        a0, a1 = self.c0, self.c1
        if a1 == 0:
            s = fp_sqrt(a0)
            if s is not None:
                return Fp2(s, 0)
            # a0 is a non-residue in Fp; sqrt is purely imaginary:
            # (t*u)^2 = -t^2  => t = sqrt(-a0)
            t = fp_sqrt((-a0) % P)
            return Fp2(0, t) if t is not None else None
        alpha = fp_sqrt((a0 * a0 + a1 * a1) % P)  # norm is QR iff a is a square
        if alpha is None:
            return None
        delta = (a0 + alpha) * fp_inv(2) % P
        x0 = fp_sqrt(delta)
        if x0 is None:
            delta = (a0 - alpha) * fp_inv(2) % P
            x0 = fp_sqrt(delta)
            if x0 is None:
                return None
        x1 = a1 * fp_inv(2 * x0 % P) % P
        cand = Fp2(x0, x1)
        return cand if cand.square() == self else None

    def sgn0(self) -> int:
        """RFC 9380 sign function for Fp2 elements."""
        sign_0 = self.c0 % 2
        zero_0 = 1 if self.c0 == 0 else 0
        sign_1 = self.c1 % 2
        return sign_0 | (zero_0 & sign_1)


XI = Fp2(1, 1)  # the Fp6 non-residue

# ---------------------------------------------------------------------------
# Fp6 = Fp2[v] / (v^3 - xi)
# ---------------------------------------------------------------------------


class Fp6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fp2, c1: Fp2, c2: Fp2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @staticmethod
    def zero() -> "Fp6":
        return Fp6(Fp2.zero(), Fp2.zero(), Fp2.zero())

    @staticmethod
    def one() -> "Fp6":
        return Fp6(Fp2.one(), Fp2.zero(), Fp2.zero())

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Fp6)
            and self.c0 == other.c0
            and self.c1 == other.c1
            and self.c2 == other.c2
        )

    def __repr__(self):
        return f"Fp6({self.c0}, {self.c1}, {self.c2})"

    def __add__(self, o: "Fp6") -> "Fp6":
        return Fp6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o: "Fp6") -> "Fp6":
        return Fp6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self) -> "Fp6":
        return Fp6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o) -> "Fp6":
        if isinstance(o, (int, Fp2)):
            return Fp6(self.c0 * o, self.c1 * o, self.c2 * o)
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        # Karatsuba-style (Toom) interpolation
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_nonresidue() + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_nonresidue()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fp6(c0, c1, c2)

    def square(self) -> "Fp6":
        return self * self

    def mul_by_v(self) -> "Fp6":
        """Multiply by v: (c0, c1, c2) -> (xi*c2, c0, c1)."""
        return Fp6(self.c2.mul_by_nonresidue(), self.c0, self.c1)

    def inv(self) -> "Fp6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - (a1 * a2).mul_by_nonresidue()
        t1 = a2.square().mul_by_nonresidue() - a0 * a1
        t2 = a1.square() - a0 * a2
        denom = a0 * t0 + (a2 * t1).mul_by_nonresidue() + (a1 * t2).mul_by_nonresidue()
        dinv = denom.inv()
        return Fp6(t0 * dinv, t1 * dinv, t2 * dinv)


# ---------------------------------------------------------------------------
# Fp12 = Fp6[w] / (w^2 - v)
# ---------------------------------------------------------------------------

# Frobenius coefficients: gamma_i = xi^(i*(P-1)/6) in Fp2, i = 1..5.
assert (P - 1) % 6 == 0
FROB_GAMMA = [XI.pow(i * (P - 1) // 6) for i in range(6)]  # index 0 unused (== 1)


def _fp2_frobenius(a: Fp2) -> Fp2:
    return a.conjugate()


def _fp6_frobenius(a: Fp6) -> Fp6:
    return Fp6(
        _fp2_frobenius(a.c0),
        _fp2_frobenius(a.c1) * FROB_GAMMA[2],
        _fp2_frobenius(a.c2) * FROB_GAMMA[4],
    )


class Fp12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fp6, c1: Fp6):
        self.c0, self.c1 = c0, c1

    @staticmethod
    def zero() -> "Fp12":
        return Fp12(Fp6.zero(), Fp6.zero())

    @staticmethod
    def one() -> "Fp12":
        return Fp12(Fp6.one(), Fp6.zero())

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero()

    def __eq__(self, other) -> bool:
        return isinstance(other, Fp12) and self.c0 == other.c0 and self.c1 == other.c1

    def __repr__(self):
        return f"Fp12({self.c0}, {self.c1})"

    def __add__(self, o: "Fp12") -> "Fp12":
        return Fp12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fp12") -> "Fp12":
        return Fp12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fp12":
        return Fp12(-self.c0, -self.c1)

    def __mul__(self, o) -> "Fp12":
        if isinstance(o, (int, Fp2, Fp6)):
            return Fp12(self.c0 * o, self.c1 * o)
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        c0 = t0 + t1.mul_by_v()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1
        return Fp12(c0, c1)

    def square(self) -> "Fp12":
        a0, a1 = self.c0, self.c1
        t = a0 * a1
        c0 = (a0 + a1) * (a0 + a1.mul_by_v()) - t - t.mul_by_v()
        return Fp12(c0, t + t)

    def inv(self) -> "Fp12":
        a0, a1 = self.c0, self.c1
        denom = a0.square() - a1.square().mul_by_v()
        dinv = denom.inv()
        return Fp12(a0 * dinv, -(a1 * dinv))

    def conjugate(self) -> "Fp12":
        """The Fp6-conjugation c0 - c1 w == Frobenius^6; inverse on the
        cyclotomic subgroup (unit-norm elements after the easy part)."""
        return Fp12(self.c0, -self.c1)

    def mul_by_023(self, l0: Fp2, l2: Fp2, l3: Fp2) -> "Fp12":
        """Multiply by the sparse element l0 + l2*w^2 + l3*w^3 (a Miller-loop
        line function in the basis Fp12 = Fp2[w]/(w^6 - xi)).  In the tower
        that element is (b0, b1) with b0 = (l0, l2, 0), b1 = (0, l3, 0);
        exploiting the zeros costs ~15 Fp2 muls vs 18+ for the dense mul."""
        a0, a1 = self.c0, self.c1
        # t0 = a0 * b0, b0 = (l0, l2, 0):
        #   z0 = x0*l0 + xi*(x2*l2); z1 = x0*l2 + x1*l0; z2 = x1*l2 + x2*l0
        t0 = Fp6(
            a0.c0 * l0 + (a0.c2 * l2).mul_by_nonresidue(),
            a0.c0 * l2 + a0.c1 * l0,
            a0.c1 * l2 + a0.c2 * l0,
        )
        # t1 = a1 * b1, b1 = (0, l3, 0):  (x0,x1,x2)*(l3 v) =
        #   xi*(x2*l3) + x0*l3 v + x1*l3 v^2
        t1 = Fp6(
            (a1.c2 * l3).mul_by_nonresidue(),
            a1.c0 * l3,
            a1.c1 * l3,
        )
        # c0 = t0 + t1*v ; c1 = (a0+a1)(b0+b1) - t0 - t1 with
        # b0+b1 = (l0, l2+l3, 0).
        s = a0 + a1
        l23 = l2 + l3
        t2 = Fp6(
            s.c0 * l0 + (s.c2 * l23).mul_by_nonresidue(),
            s.c0 * l23 + s.c1 * l0,
            s.c1 * l23 + s.c2 * l0,
        )
        return Fp12(t0 + t1.mul_by_v(), t2 - t0 - t1)

    def frobenius(self) -> "Fp12":
        c0 = _fp6_frobenius(self.c0)
        c1 = _fp6_frobenius(self.c1)
        # multiply c1 by gamma^(1/1): coefficients of w, w*v, w*v^2 pick up
        # xi^((p-1)/6) * the Fp6 coefficient adjustments
        c1 = Fp6(
            c1.c0 * FROB_GAMMA[1],
            c1.c1 * FROB_GAMMA[1],
            c1.c2 * FROB_GAMMA[1],
        )
        return Fp12(c0, c1)

    def frobenius_n(self, n: int) -> "Fp12":
        out = self
        for _ in range(n % 12):
            out = out.frobenius()
        return out

    def pow(self, e: int) -> "Fp12":
        if e < 0:
            return self.inv().pow(-e)
        result = Fp12.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result


def fp12_from_fp2_coeffs(coeffs: list[Fp2]) -> Fp12:
    """Build an Fp12 element from coefficients of w^0..w^5 over Fp2, using the
    basis identification Fp12 = Fp2[w]/(w^6 - xi):
        1, w, w^2, w^3, w^4, w^5
    maps to the tower as (c0 = (a0, a2, a4) in v-basis, c1 = (a1, a3, a5)),
    since v = w^2 and w*v = w^3 etc.  (The line evaluations of pairing.py.)
    """
    a0, a1, a2, a3, a4, a5 = coeffs
    return Fp12(Fp6(a0, a2, a4), Fp6(a1, a3, a5))
