"""Kernels 2 and 3: the fused Miller doubling and addition steps.

Replaces ``lighthouse_tpu/crypto/bls/jax_backend/pallas_miller.py``
``_step_dbl_kernel`` (line_dbl -> fp12 square -> sparse 023 multiply) and
``_step_add_kernel`` (line_add -> sparse 023 multiply -> per-lane bit select
of (f, T)).  Each step runs as ONE launch with every Fp2/Fp6/Fp12
intermediate kept on the chip; the loop makes 63 launches of each.

The step formulas (``KFp`` and the ``k*``/``k2_*``/``k6_*``/``k12_*``/
``k_line_*`` functions, pallas_miller.py:95-397) are written ONCE here,
generic over a context ``ctx``.  They run on a recording context that keeps
a straight-line program of limb ops (``Program``); the bound asserts of
``KFp`` (MAX_BOUND, MAX_MUL_PRODUCT, REDUCE_PIN) fire while it records,
exactly as they fire at trace time in the reference.  The one program
then has two readings:

* the plain version (``miller_step_dbl_plain``/``miller_step_add_plain``)
  runs it on torch tensors, with the Montgomery products of one dependency
  level stacked into one ``mont_mul_plain`` call;
* ``codegen.py`` prints it as the CUDA kernels of ``csrc/miller_step.cu``
  (committed, regenerated text-identically by a test).

Both apply the same limb ops in dependency order, so their limbs agree byte
for byte.  Which Montgomery core each product uses and which bias k each
subtraction uses match pallas_miller.py, since the formulas are its own.
Under the MXU arm (``fp.mxu_active()``) the same programs run with every
product on the 13-bit plane: ``csrc/miller_step_mxu.cu`` (kernel 7's core
in each product, as pallas_miller.py's ``_Ctx(..., mxu)``) and the plain
versions over ``mxu_kernel.mont_mul_mxu_plain``; they launch as
``miller_step_dbl_mxu`` and ``miller_step_add_mxu``.

Hopper design.  What bounds both steps on the card: about 1,703 32-bit
multiply-adds per product (169 products in dbl, 111 in add) against 9.9 KB
of traffic per lane, so integer throughput at full occupancy; with one
thread per lane a step's products ran one after another in one thread,
one warp per SM at the Miller loop's 4,097 lanes, and the card waited on
that thread.  Both steps now run in the group form (csrc/group.cuh,
codegen.group_schedule): G threads per lane (DBL_GROUP, ADD_GROUP), the
program's products in rounds of at most G independent products, one per
thread with the unchanged Montgomery core, the linear ops between rounds
dealt to the threads, a barrier after each phase; the lane's values sit in
16-bit shared-memory slots reassigned by the schedule.  The serial chain
falls from 169 products to 11 rounds (dbl) and from 111 to 10 (add).
The MXU steps run in the same form at G = DBL_MXU_GROUP = ADD_MXU_GROUP =
8, one rank per warp so that every product's mma.sync is made by a whole
warp; 8 warps' DMMA staging and the slots fill one block's shared memory
(the addition step, with more slots, stages its products in 16 rows a
pass, the doubling step in 32: codegen.MXU_GROUP_ROWS).  The serial chain
of the MXU addition step falls from 111 products to 15 rounds.  Every form
reads the step's f (12 planes), T (6), Q (4), xp and yp once and writes the
18 output planes once, coalesced by lane.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .. import params
from . import _build
from . import fp as F
from . import tower as T
from .mont_kernel import mont_mul_plain, mont_sqr_plain
from .mxu_kernel import mont_mul_mxu_plain

N = F.N

# -- the recorded program -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Op:
    """One op: ``out = kind(*ins)``.  ``arg`` is the bias k of a sub or neg,
    the (buffer, plane) a limb input is read from, or the buffer a flag is
    read from."""

    kind: str  # limbs: in | one | zero | add | sub | neg | mul | sqr | sel
    #            flags: bit | flag | and | fsel
    out: int
    ins: tuple
    arg: object = None


PRODUCTS = ("mul", "sqr")  # the Montgomery product and the triangle square
FLAGS = ("bit", "flag", "and", "fsel")  # per-lane flag values, not limbs


class Program:
    """A straight-line step program over 26-limb values and per-lane flags."""

    def __init__(self, name: str, ops: list, outputs: list):
        self.name = name
        self.ops = ops
        self.outputs = outputs  # [(buffer, plane, value id)]
        self.n_mul = sum(op.kind == "mul" for op in ops)
        self.n_sqr = sum(op.kind == "sqr" for op in ops)
        self.stages = self._stages()

    def _stages(self):
        """Execution order of the plain version: by dependency level, where
        a product sits one level above its deepest operand and any other op
        at the level of its deepest operand.  Products of one kind and level
        depend only on lower levels, so they run as one stacked call; the
        other ops of a level follow them in program order."""
        level = {}
        for op in self.ops:
            base = max((level[i] for i in op.ins), default=0)
            level[op.out] = base + 1 if op.kind in PRODUCTS else base
        top = max(level.values())
        stages = []
        for lv in range(top + 1):
            for kind in PRODUCTS:
                prods = [op for op in self.ops if op.kind == kind and level[op.out] == lv]
                if prods:
                    stages.append((kind, prods))
            stages += [("op", op) for op in self.ops
                       if op.kind not in PRODUCTS and level[op.out] == lv]
        return stages


class _Recorder:
    """The recording context: every ctx call appends one Op."""

    def __init__(self):
        self.ops = []
        self.one = self._op("one", ())

    def _op(self, kind, ins, arg=None) -> int:
        vid = len(self.ops)
        self.ops.append(Op(kind, vid, tuple(ins), arg))
        return vid

    def input(self, buffer: str, plane: int) -> int:
        return self._op("in", (), (buffer, plane))

    def bit(self) -> int:
        return self._op("bit", ())

    def flag(self, buffer: str) -> int:
        """A (1, n) flag plane, read as its per-lane value."""
        return self._op("flag", (), buffer)

    def flag_and(self, a, b) -> int:
        return self._op("and", (a, b))

    def flag_select(self, mask, a, b) -> int:
        return self._op("fsel", (mask, a, b))

    def zero(self) -> int:
        return self._op("zero", ())

    def add(self, a, b):
        return self._op("add", (a, b))

    def sub(self, a, b, k):
        return self._op("sub", (a, b), k)

    def neg(self, a, k):
        return self._op("neg", (a,), k)

    def mont(self, a, b):
        return self._op("mul", (a, b))

    def msqr(self, a):
        return self._op("sqr", (a,))

    def select(self, mask, a, b):
        return self._op("sel", (mask, a, b))


# -- the step formulas (pallas_miller.py:95-397), written once -----------------


class KFp:
    """In-kernel lazy field element: limb value + static bound."""

    __slots__ = ("cols", "bound")

    def __init__(self, cols, bound: float):
        assert bound <= F.MAX_BOUND, f"KFp bound {bound} escapes MAX_BOUND"
        self.cols = cols
        self.bound = bound


def kadd(ctx, a: KFp, b: KFp) -> KFp:
    return KFp(ctx.add(a.cols, b.cols), a.bound + b.bound)


def ksub(ctx, a: KFp, b: KFp) -> KFp:
    k = F._k_for(b.bound)
    return KFp(ctx.sub(a.cols, b.cols, k), a.bound + k)


def kneg(ctx, a: KFp) -> KFp:
    k = F._k_for(a.bound)
    return KFp(ctx.neg(a.cols, k), float(k))


def kdbl(ctx, a: KFp) -> KFp:
    return kadd(ctx, a, a)


def kmul(ctx, a: KFp, b: KFp) -> KFp:
    prod = a.bound * b.bound
    assert prod <= F.MAX_MUL_PRODUCT, (
        f"in-kernel mont product bound {prod} > {F.MAX_MUL_PRODUCT}"
    )
    return KFp(ctx.mont(a.cols, b.cols), prod / F.MONT_DIVISOR + F.MONT_EPS)


def ksqr(ctx, a: KFp) -> KFp:
    """The triangle square (pallas_miller.ksqr -> pallas_fp._mont_sqr_core)."""
    prod = a.bound * a.bound
    assert prod <= F.MAX_MUL_PRODUCT
    return KFp(ctx.msqr(a.cols), prod / F.MONT_DIVISOR + F.MONT_EPS)


def kreduce(ctx, a: KFp) -> KFp:
    out = kmul(ctx, a, KFp(ctx.one, 1.0))
    assert out.bound <= F.REDUCE_PIN
    return KFp(out.cols, F.REDUCE_PIN)


def kguard(ctx, a: KFp, m: float) -> KFp:
    return kreduce(ctx, a) if a.bound > m else a


def kselect(ctx, mask, a: KFp, b: KFp) -> KFp:
    return KFp(ctx.select(mask, a.cols, b.cols), max(a.bound, b.bound))


def k2_add(ctx, a, b):
    return (kadd(ctx, a[0], b[0]), kadd(ctx, a[1], b[1]))


def k2_sub(ctx, a, b):
    return (ksub(ctx, a[0], b[0]), ksub(ctx, a[1], b[1]))


def k2_neg(ctx, a):
    return (kneg(ctx, a[0]), kneg(ctx, a[1]))


def k2_dbl(ctx, a):
    return (kdbl(ctx, a[0]), kdbl(ctx, a[1]))


def k2_guard(ctx, a, m: float = 11.0):
    if max(a[0].bound, a[1].bound) > m:
        return (kreduce(ctx, a[0]), kreduce(ctx, a[1]))
    return a


def k2_select(ctx, mask, a, b):
    return (kselect(ctx, mask, a[0], b[0]), kselect(ctx, mask, a[1], b[1]))


def k2_mul(ctx, a, b):
    a = k2_guard(ctx, a)
    b = k2_guard(ctx, b)
    s0 = kadd(ctx, a[0], a[1])
    s1 = kadd(ctx, b[0], b[1])
    t0 = kmul(ctx, a[0], b[0])
    t1 = kmul(ctx, a[1], b[1])
    t2 = kmul(ctx, s0, s1)
    return (ksub(ctx, t0, t1), ksub(ctx, t2, kadd(ctx, t0, t1)))


def k2_sqr(ctx, a):
    a = k2_guard(ctx, a)
    d = ksub(ctx, a[0], a[1])
    s = kadd(ctx, a[0], a[1])
    c0 = kmul(ctx, d, s)
    t = kmul(ctx, a[0], a[1])
    return (c0, kadd(ctx, t, t))


def k2_mul_small(ctx, a, k: int):
    assert k >= 1
    out = a
    for bit in bin(k)[3:]:
        out = k2_dbl(ctx, out)
        if bit == "1":
            out = k2_add(ctx, out, a)
    return out


def k2_mul_by_nonresidue(ctx, a):
    return (ksub(ctx, a[0], a[1]), kadd(ctx, a[0], a[1]))


def k2_reduce(ctx, a):
    return (kreduce(ctx, a[0]), kreduce(ctx, a[1]))


def k6_add(ctx, a, b):
    return tuple(k2_add(ctx, x, y) for x, y in zip(a, b))


def k6_sub(ctx, a, b):
    return tuple(k2_sub(ctx, x, y) for x, y in zip(a, b))


def k6_mul_by_v(ctx, a):
    return (k2_mul_by_nonresidue(ctx, a[2]), a[0], a[1])


def k6_reduce(ctx, a):
    return tuple(k2_reduce(ctx, x) for x in a)


def k6_mul(ctx, a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = k2_mul(ctx, a0, b0)
    t1 = k2_mul(ctx, a1, b1)
    t2 = k2_mul(ctx, a2, b2)
    u12 = k2_mul(ctx, k2_add(ctx, a1, a2), k2_add(ctx, b1, b2))
    u01 = k2_mul(ctx, k2_add(ctx, a0, a1), k2_add(ctx, b0, b1))
    u02 = k2_mul(ctx, k2_add(ctx, a0, a2), k2_add(ctx, b0, b2))
    X = k2_sub(ctx, k2_sub(ctx, u12, t1), t2)
    Y = k2_sub(ctx, k2_sub(ctx, u01, t0), t1)
    Z = k2_sub(ctx, k2_sub(ctx, u02, t0), t2)
    c0 = k2_add(ctx, k2_mul_by_nonresidue(ctx, X), t0)
    c1 = k2_add(ctx, Y, k2_mul_by_nonresidue(ctx, t2))
    c2 = k2_add(ctx, Z, t1)
    return k6_reduce(ctx, (c0, c1, c2))


def k12_sqr(ctx, a):
    a0, a1 = a
    t = k6_mul(ctx, a0, a1)
    c0 = k6_sub(
        ctx,
        k6_sub(
            ctx,
            k6_mul(ctx, k6_add(ctx, a0, a1), k6_add(ctx, a0, k6_mul_by_v(ctx, a1))),
            t,
        ),
        k6_mul_by_v(ctx, t),
    )
    c1 = k6_add(ctx, t, t)
    return tuple(k6_reduce(ctx, h) for h in (c0, c1))


def k12_mul_by_023(ctx, f, l0, l2, l3):
    a0, a1 = f
    s = k6_add(ctx, a0, a1)
    l23 = k2_add(ctx, l2, l3)
    p00 = k2_mul(ctx, a0[0], l0)
    p02 = k2_mul(ctx, a0[2], l2)
    q00 = k2_mul(ctx, a0[0], l2)
    q01 = k2_mul(ctx, a0[1], l0)
    r01 = k2_mul(ctx, a0[1], l2)
    r02 = k2_mul(ctx, a0[2], l0)
    w2 = k2_mul(ctx, a1[2], l3)
    w0 = k2_mul(ctx, a1[0], l3)
    w1 = k2_mul(ctx, a1[1], l3)
    s00 = k2_mul(ctx, s[0], l0)
    s02 = k2_mul(ctx, s[2], l23)
    v00 = k2_mul(ctx, s[0], l23)
    v01 = k2_mul(ctx, s[1], l0)
    x01 = k2_mul(ctx, s[1], l23)
    x02 = k2_mul(ctx, s[2], l0)
    t0 = (
        k2_add(ctx, p00, k2_mul_by_nonresidue(ctx, p02)),
        k2_add(ctx, q00, q01),
        k2_add(ctx, r01, r02),
    )
    t1 = (k2_mul_by_nonresidue(ctx, w2), w0, w1)
    t2 = (
        k2_add(ctx, s00, k2_mul_by_nonresidue(ctx, s02)),
        k2_add(ctx, v00, v01),
        k2_add(ctx, x01, x02),
    )
    c0 = k6_add(ctx, t0, k6_mul_by_v(ctx, t1))
    c1 = k6_sub(ctx, k6_sub(ctx, t2, t0), t1)
    return (k6_reduce(ctx, c0), k6_reduce(ctx, c1))


def k_line_dbl(ctx, Tpt, xp: KFp, yp: KFp):
    X1, Y1, Z1 = Tpt
    X_sq = k2_sqr(ctx, X1)
    Y_sq = k2_sqr(ctx, Y1)
    Z_sq = k2_sqr(ctx, Z1)
    YZ = k2_mul(ctx, Y1, Z1)
    E = k2_mul_small(ctx, X_sq, 3)
    XB = k2_add(ctx, X1, Y_sq)
    X_cu = k2_mul(ctx, X_sq, X1)
    Z_cu = k2_mul(ctx, Z_sq, Z1)
    XZ = k2_mul(ctx, X_sq, Z_sq)
    C = k2_sqr(ctx, Y_sq)
    t = k2_sqr(ctx, XB)
    Fv = k2_sqr(ctx, k2_guard(ctx, E))
    l0 = k2_sub(ctx, k2_mul_small(ctx, X_cu, 3), k2_dbl(ctx, Y_sq))
    D = k2_dbl(ctx, k2_sub(ctx, k2_sub(ctx, t, X_sq), C))
    X3 = k2_sub(ctx, Fv, k2_dbl(ctx, D))
    YZ3 = k2_dbl(ctx, k2_mul(ctx, Y1, Z_cu))
    m3XZ = k2_neg(ctx, k2_mul_small(ctx, XZ, 3))
    l2 = (kmul(ctx, kguard(ctx, m3XZ[0], 40.0), xp),
          kmul(ctx, kguard(ctx, m3XZ[1], 40.0), xp))
    l3 = (kmul(ctx, YZ3[0], yp), kmul(ctx, YZ3[1], yp))
    m = k2_mul(ctx, k2_guard(ctx, E), k2_sub(ctx, D, X3))
    Y3 = k2_sub(ctx, m, k2_mul_small(ctx, C, 8))
    Z3 = k2_dbl(ctx, YZ)
    out = [k2_reduce(ctx, v) for v in (l0, l2, l3, X3, Y3, Z3)]
    return (out[0], out[1], out[2]), (out[3], out[4], out[5])


def k_line_add(ctx, Tpt, Q, xp: KFp, yp: KFp):
    X1, Y1, Z1 = Tpt
    x2, y2 = Q
    Z_sq = k2_sqr(ctx, Z1)
    Z_cu = k2_mul(ctx, Z_sq, Z1)
    U2 = k2_mul(ctx, x2, Z_sq)
    H = k2_sub(ctx, U2, X1)
    S2 = k2_mul(ctx, y2, Z_cu)
    ZH = k2_mul(ctx, Z1, H)
    H_sq = k2_sqr(ctx, k2_guard(ctx, H))
    rr = k2_sub(ctx, S2, Y1)
    p_rx = k2_mul(ctx, rr, x2)
    p_yZH = k2_mul(ctx, y2, ZH)
    rr2 = k2_sqr(ctx, k2_guard(ctx, rr))
    H_cu = k2_mul(ctx, H, H_sq)
    V = k2_mul(ctx, X1, H_sq)
    l0 = k2_sub(ctx, p_rx, p_yZH)
    X3 = k2_sub(ctx, k2_sub(ctx, rr2, H_cu), k2_dbl(ctx, V))
    m1 = k2_mul(ctx, rr, k2_sub(ctx, V, X3))
    m2 = k2_mul(ctx, Y1, H_cu)
    Y3 = k2_sub(ctx, m1, m2)
    neg_rr = k2_neg(ctx, rr)
    l2 = (kmul(ctx, kguard(ctx, neg_rr[0], 40.0), xp),
          kmul(ctx, kguard(ctx, neg_rr[1], 40.0), xp))
    l3 = (kmul(ctx, ZH[0], yp), kmul(ctx, ZH[1], yp))
    out = [k2_reduce(ctx, v) for v in (l0, l2, l3, X3, Y3, ZH)]
    return (out[0], out[1], out[2]), (out[3], out[4], out[5])


# -- the two step programs -----------------------------------------------------


@functools.lru_cache(maxsize=None)
def program(step: str) -> Program:
    """Record the ``"dbl"`` or ``"add"`` step.  Inputs arrive reduced
    (bound 2); every output is asserted back in that class."""
    ctx = _Recorder()

    def inp(buf, plane):
        return KFp(ctx.input(buf, plane), 2.0)

    f = T.fp12_from_lanes([inp("f", i) for i in range(12)])
    Tpt = tuple((inp("t", 2 * i), inp("t", 2 * i + 1)) for i in range(3))
    if step == "dbl":
        xp, yp = inp("xp", 0), inp("yp", 0)
        line, T2 = k_line_dbl(ctx, Tpt, xp, yp)
        f_out = T.fp12_lanes(k12_mul_by_023(ctx, k12_sqr(ctx, f), *line))
        t_out = [c for pt in T2 for c in pt]
    elif step == "add":
        q = ((inp("q", 0), inp("q", 1)), (inp("q", 2), inp("q", 3)))
        xp, yp = inp("xp", 0), inp("yp", 0)
        bit = ctx.bit()
        line, T_add = k_line_add(ctx, Tpt, q, xp, yp)
        f_a = k12_mul_by_023(ctx, f, *line)
        f_out = [kselect(ctx, bit, va, vf)
                 for va, vf in zip(T.fp12_lanes(f_a), T.fp12_lanes(f))]
        t_out = [kselect(ctx, bit, T_add[i][c], Tpt[i][c])
                 for i in range(3) for c in range(2)]
    else:
        raise ValueError(step)
    for v in f_out + t_out:
        assert v.bound <= 2.0
    outputs = ([("f_out", i, v.cols) for i, v in enumerate(f_out)]
               + [("t_out", i, v.cols) for i, v in enumerate(t_out)])
    return Program(f"miller_step_{step}", ctx.ops, outputs)


def run_plain(prog: Program, bufs: dict, mxu: bool = False) -> dict:
    """The plain PyTorch reading of a program.  ``bufs`` maps each limb
    input buffer to (planes, 26, n) or (26, n), each flag buffer to (1, n)
    and "bit" to (n,) int32 tensors; returns {output buffer: tensor}, limb
    outputs as (planes, 26, n) and flag outputs as (1, n).  With ``mxu``
    every product, a square too, is the 13-bit product."""
    ref = next(b for b in bufs.values() if b.dim() >= 2)
    n = ref.shape[-1]
    mul = mont_mul_mxu_plain if mxu else mont_mul_plain
    sqr = (lambda a: mont_mul_mxu_plain(a, a)) if mxu else mont_sqr_plain
    vals = {}
    for kind, item in prog.stages:
        if kind == "mul":
            a = torch.cat([vals[op.ins[0]] for op in item], dim=1)
            b = torch.cat([vals[op.ins[1]] for op in item], dim=1)
            for op, r in zip(item, mul(a, b).split(n, dim=1)):
                vals[op.out] = r
            continue
        if kind == "sqr":
            a = torch.cat([vals[op.ins[0]] for op in item], dim=1)
            for op, r in zip(item, sqr(a).split(n, dim=1)):
                vals[op.out] = r
            continue
        op = item
        x = [vals[i] for i in op.ins]
        if op.kind == "in":
            buf, plane = op.arg
            src = bufs[buf]
            vals[op.out] = src if src.dim() == 2 else src[plane]
        elif op.kind == "bit":
            vals[op.out] = (bufs["bit"] != 0)[None]
        elif op.kind == "flag":
            vals[op.out] = bufs[op.arg]
        elif op.kind == "one":
            vals[op.out] = F.bcast("ONE", (n,), ref.device)
        elif op.kind == "zero":
            vals[op.out] = torch.zeros((N, n), dtype=F.DTYPE, device=ref.device)
        elif op.kind == "add":
            vals[op.out] = F.compress1(x[0] + x[1])
        elif op.kind == "sub":
            vals[op.out] = F.compress1(x[0] + F.const(op.arg, x[0]) - x[1])
        elif op.kind == "neg":
            vals[op.out] = F.compress1(F.const(op.arg, x[0]) - x[0])
        elif op.kind == "sel":
            vals[op.out] = torch.where(x[0] != 0, x[1], x[2])
        elif op.kind == "and":
            vals[op.out] = x[0] & x[1]
        elif op.kind == "fsel":
            vals[op.out] = torch.where(x[0] != 0, x[1], x[2])
        else:
            raise AssertionError(op.kind)
    planes = {}
    for buf, plane, vid in prog.outputs:
        planes[buf] = max(planes.get(buf, 0), plane + 1)
    out = {}
    for buf, plane, vid in prog.outputs:
        if prog.ops[vid].kind in FLAGS:
            out[buf] = vals[vid]
            continue
        if buf not in out:
            out[buf] = torch.empty((planes[buf], N, n), dtype=F.DTYPE, device=ref.device)
        out[buf][plane] = vals[vid]
    return out


# -- wrappers -----------------------------------------------------------------

DBL_GROUP = 16  # threads per lane of kernel 2's group form
ADD_GROUP = 16  # kernel 3's (G = 8 ran slower on the card, G = 32 spills)
DBL_MXU_GROUP = 8  # kernel 2m's: the most warps whose staging fits beside the slots
ADD_MXU_GROUP = 8  # kernel 3m's: the same, its staging in passes of 16 rows

dbl_launches = 0  # kernel launches (plain-version calls do not count)
add_launches = 0
dbl_mxu_launches = 0  # the MXU variants
add_mxu_launches = 0


def _check(named: dict) -> None:
    f = named["f"]
    n = f.shape[-1]
    shapes = {"f": (12, N, n), "t": (6, N, n), "q": (4, N, n), "xp": (N, n),
              "yp": (N, n), "bit": (n,)}
    for name, x in named.items():
        if x.dtype != torch.int32:
            raise TypeError(f"{name}: Miller step takes int32 tensors")
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shapes[name]}")
        if x.device != f.device:
            raise ValueError(f"{name}: on {x.device}, f on {f.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    if f.device.type not in ("cpu", "cuda"):
        raise ValueError(f"Miller step has no path for device {f.device}")


def group_of(step: str, mxu: bool) -> int:
    """Threads per lane of the form the wrapper launches."""
    if step == "dbl":
        return DBL_MXU_GROUP if mxu else DBL_GROUP
    return ADD_MXU_GROUP if mxu else ADD_GROUP


def _launch(step: str, mxu: bool, args: tuple):
    """Launch the ``"dbl"`` or ``"add"`` step's kernel in its form
    (lh_miller_step_<step>[_mxu]_g<G>, G from group_of) on the wrapper's
    checked CUDA operands ``args``, on the current stream; returns (f', T')."""
    group = group_of(step, mxu)
    name = f"lh_miller_step_{step}" + ("_mxu" if mxu else "") + f"_g{group}"
    if args[0].device.type != "cuda":
        raise ValueError(f"{name} launches on CUDA tensors only")
    lib = _build.library("miller_step_mxu" if mxu else "miller_step")
    launch = getattr(lib, name)
    if not launch.argtypes:
        launch.argtypes = [ctypes.c_void_p] * (len(args) + 2) + [ctypes.c_int, ctypes.c_void_p]
        launch.restype = ctypes.c_int
    f, t = args[0], args[1]
    f_out, t_out = torch.empty_like(f), torch.empty_like(t)
    err = launch(*(x.data_ptr() for x in args), f_out.data_ptr(), t_out.data_ptr(),
                 f.shape[-1], torch.cuda.current_stream(f.device).cuda_stream)
    _build.check(lib, err, f"{name} kernel")
    return f_out, t_out


def miller_step_dbl_plain(f, t, xp, yp, mxu: bool = False):
    out = run_plain(program("dbl"), {"f": f, "t": t, "xp": xp, "yp": yp}, mxu)
    return out["f_out"], out["t_out"]


def miller_step_add_plain(f, t, q, xp, yp, bit, mxu: bool = False):
    out = run_plain(program("add"), {"f": f, "t": t, "q": q, "xp": xp, "yp": yp, "bit": bit},
                    mxu)
    return out["f_out"], out["t_out"]


def miller_step_dbl(f, t, xp, yp, mxu: bool | None = None):
    """One doubling step on f (12, 26, n) and T (6, 26, n) at P = (xp, yp):
    returns (f', T').  CUDA tensors launch kernel 2 on the current stream
    (its MXU variant with ``mxu``, which defaults to ``fp.mxu_active()``);
    CPU tensors take the plain version."""
    _check({"f": f, "t": t, "xp": xp, "yp": yp})
    mxu = F.mxu_active() if mxu is None else mxu
    if f.device.type == "cpu":
        return miller_step_dbl_plain(f, t, xp, yp, mxu)
    out = _launch("dbl", mxu, (f, t, xp, yp))
    global dbl_launches, dbl_mxu_launches
    if mxu:
        dbl_mxu_launches += 1
    else:
        dbl_launches += 1
    return out


def miller_step_add(f, t, q, xp, yp, bit, mxu: bool | None = None):
    """One addition step with the affine twist point Q (4, 26, n): where
    bit (n,) is set, (f, T) take the added values, elsewhere they pass
    through.  CUDA tensors launch kernel 3 (its MXU variant with ``mxu``);
    CPU tensors the plain version."""
    _check({"f": f, "t": t, "q": q, "xp": xp, "yp": yp, "bit": bit})
    mxu = F.mxu_active() if mxu is None else mxu
    if f.device.type == "cpu":
        return miller_step_add_plain(f, t, q, xp, yp, bit, mxu)
    out = _launch("add", mxu, (f, t, q, xp, yp, bit))
    global add_launches, add_mxu_launches
    if mxu:
        add_mxu_launches += 1
    else:
        add_launches += 1
    return out


# -- the fused Miller loop -----------------------------------------------------

X_BITS = [int(c) for c in bin(abs(params.X))[2:]]


def miller_loop_fused(p_aff, q_aff):
    """The Miller loop as 63 doubling and 63 addition launches (the addition
    step always runs; its bit plane selects).  Inputs and output are LFp
    trees as in pairing.miller_loop; the result carries the conjugation for
    the negative BLS parameter."""
    def pin(c):
        return F.relabel(F.guard_le(c, 2.0), 2.0)

    def flat(x):
        return x.limbs.reshape(N, -1).contiguous()

    xp, yp = pin(p_aff[0]), pin(p_aff[1])
    q0 = (pin(q_aff[0][0]), pin(q_aff[0][1]))
    q1 = (pin(q_aff[1][0]), pin(q_aff[1][1]))
    batch = xp.limbs.shape[1:]
    xp_a, yp_a = flat(xp), flat(yp)
    n = xp_a.shape[-1]
    q_arr = torch.stack([flat(q0[0]), flat(q0[1]), flat(q1[0]), flat(q1[1])])
    one = F.const("ONE", xp_a).expand(N, n)
    f_arr = torch.zeros((12, N, n), dtype=F.DTYPE, device=xp_a.device)
    f_arr[0] = one
    t_arr = torch.cat([q_arr, torch.zeros_like(q_arr[:2])])
    t_arr[4] = one
    bit_rows = {b: torch.full((n,), b, dtype=F.DTYPE, device=xp_a.device) for b in (0, 1)}
    mxu = F.mxu_active()
    for bit in X_BITS[1:]:
        f_arr, t_arr = miller_step_dbl(f_arr, t_arr, xp_a, yp_a, mxu)
        f_arr, t_arr = miller_step_add(f_arr, t_arr, q_arr, xp_a, yp_a, bit_rows[bit], mxu)
    vals = [F.LFp(f_arr[i].reshape((N,) + batch), 2.0) for i in range(12)]
    return T.fp12_conj(T.fp12_from_lanes(vals))
