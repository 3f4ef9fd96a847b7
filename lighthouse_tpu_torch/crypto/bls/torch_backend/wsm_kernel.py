"""Kernel 6: the fused weight-scalar-mul step, for G1 and G2, and its driver.

Replaces ``lighthouse_tpu/crypto/bls/jax_backend/pallas_wsm.py``
(``_make_step_kernel`` / ``_step_call``, driven by ``scalar_mul_bits_fused``):
one double-and-always-add bit of [k]P for a per-lane 64-bit k, as ONE
launch per bit per curve: the Jacobian double, the mixed add of the affine
base (Z2 = 1: the coordinates of ``points._raw_add`` at Z2 = 1) and the
bit and infinity-flag selects, every intermediate kept on the chip.  The 64
bits of a weight make 64 launches per curve.

The step formulas (``_k_jac_double``, ``_k_mixed_add``, the flag discipline
of ``_make_step_kernel`` and ``_base_z_one``) are written once here over
miller_kernel's recording context, as the Miller steps are.  G1 squares
with the triangle square (``ksqr``); G2's ``k2_sqr`` uses products only.
The recorded programs run as the plain versions (``run_plain``) and are
printed as ``csrc/wsm_step.cu`` by codegen.py, so the two agree byte for
byte.  The reference promises values, not bytes, against
``points.scalar_mul_bits``: the tests hold the fused driver to the port's
``P.scalar_mul_bits`` by canonical value, flags included.

Hopper design: several threads per lane.  One thread per lane ran the
step's products one after another (1,703 multiplies each, 1,378 a square)
with under one warp per SM at the path's 4,096 lanes; each curve now runs
in the form that was the faster there (``FORMS``, PERF.md), every input
plane read once and every output plane written once:

* G2 in the group form of kernels 2 and 3 (``codegen._kernel``): 16
  threads per lane in blocks of 32 lanes run the products of a dependency
  level side by side, each the one-thread core, in 10 rounds of at most 16.
* G1, whose 25 products fall in 8 rounds of at most 4, in the cooperative
  form (``codegen._coop_kernel``): 16 threads per lane in blocks of 8 lanes
  make each product together, one after another, on kernel 4's tiles
  (csrc/mont_coop.cuh; the squares by the group triangle square), the
  linear ops riding in the products' phases.

What bounds it on the card: integer multiplies (the programs' products
times 1,703, squares times 1,378, per lane) against about 1 KB (G1) or
2 KB (G2) of traffic per lane.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import fp as F
from .miller_kernel import (
    KFp,
    Program,
    _Recorder,
    k2_add,
    k2_dbl,
    k2_guard,
    k2_mul,
    k2_neg,
    k2_reduce,
    k2_select,
    k2_sqr,
    k2_sub,
    kadd,
    kdbl,
    kguard,
    kmul,
    kneg,
    kreduce,
    kselect,
    ksqr,
    ksub,
    run_plain,
)

N = F.N

# -- in-kernel field namespaces (pallas_wsm._K1 / _K2) ---------------------------


class _K1:
    ncoords = 1

    @staticmethod
    def read(ctx, buf, i):
        return KFp(ctx.input(buf, i), 2.0)

    add = staticmethod(kadd)
    sub = staticmethod(ksub)
    dbl = staticmethod(kdbl)
    mul = staticmethod(kmul)
    sqr = staticmethod(ksqr)
    neg = staticmethod(kneg)
    reduce = staticmethod(kreduce)
    select = staticmethod(kselect)

    @staticmethod
    def guard(ctx, a, m: float = 11.0):
        return kguard(ctx, a, m)

    @staticmethod
    def lanes(v):
        return [v]


class _K2:
    ncoords = 2

    @staticmethod
    def read(ctx, buf, i):
        return (KFp(ctx.input(buf, 2 * i), 2.0), KFp(ctx.input(buf, 2 * i + 1), 2.0))

    add = staticmethod(k2_add)
    sub = staticmethod(k2_sub)
    dbl = staticmethod(k2_dbl)
    mul = staticmethod(k2_mul)
    sqr = staticmethod(k2_sqr)
    neg = staticmethod(k2_neg)
    reduce = staticmethod(k2_reduce)
    select = staticmethod(k2_select)

    @staticmethod
    def guard(ctx, a, m: float = 11.0):
        return k2_guard(ctx, a, m)

    @staticmethod
    def lanes(v):
        return [v[0], v[1]]


# -- the step formulas (pallas_wsm.py:123-223), written once ----------------------


def _k_jac_double(K, ctx, X, Y, Z):
    """points.jac_double: 7 products and squares."""
    A = K.sqr(ctx, X)
    B = K.sqr(ctx, Y)
    YZ = K.mul(ctx, Y, Z)
    E = K.add(ctx, K.dbl(ctx, A), A)
    XB = K.add(ctx, X, B)
    C = K.sqr(ctx, B)
    t = K.sqr(ctx, K.guard(ctx, XB))
    Fv = K.sqr(ctx, K.guard(ctx, E))
    D = K.dbl(ctx, K.sub(ctx, K.sub(ctx, t, A), C))
    X3 = K.sub(ctx, Fv, K.dbl(ctx, D))
    m = K.mul(ctx, K.guard(ctx, E), K.guard(ctx, K.sub(ctx, D, X3)))
    C8 = K.dbl(ctx, K.dbl(ctx, K.dbl(ctx, C)))
    Y3 = K.sub(ctx, m, C8)
    Z3 = K.dbl(ctx, YZ)
    return (K.reduce(ctx, X3), K.reduce(ctx, Y3), K.reduce(ctx, Z3))


def _k_mixed_add(K, ctx, X1, Y1, Z1, x2, y2):
    """points._raw_add with Z2 = 1 (affine base): U1 = X1, S1 = Y1 and the
    Z3 pre-factor collapses to 2 Z1 — the same values, five fewer products."""
    Z1Z1 = K.sqr(ctx, Z1)
    U2 = K.mul(ctx, x2, Z1Z1)
    Z1cu = K.mul(ctx, Z1, Z1Z1)
    S2 = K.mul(ctx, y2, Z1cu)
    H = K.sub(ctx, U2, X1)
    rr = K.dbl(ctx, K.sub(ctx, S2, Y1))
    H2 = K.dbl(ctx, H)
    I = K.sqr(ctx, K.guard(ctx, H2))  # noqa: E741 (the formula's name)
    J = K.mul(ctx, K.guard(ctx, H), I)
    V = K.mul(ctx, X1, I)
    rr2 = K.sqr(ctx, K.guard(ctx, rr))
    X3 = K.sub(ctx, K.sub(ctx, rr2, J), K.dbl(ctx, V))
    m1 = K.mul(ctx, K.guard(ctx, rr), K.guard(ctx, K.sub(ctx, V, X3)))
    m2 = K.mul(ctx, Y1, J)
    Y3 = K.sub(ctx, m1, K.dbl(ctx, m2))
    Z3 = K.mul(ctx, K.dbl(ctx, Z1), K.guard(ctx, H))
    return (K.reduce(ctx, X3), K.reduce(ctx, Y3), K.reduce(ctx, Z3))


def _pt_select_lanes(K, ctx, mask, a_pt, b_pt):
    return tuple(K.select(ctx, mask, a, b) for a, b in zip(a_pt, b_pt))


def _base_z_one(K, ctx):
    """Z = 1 (the Montgomery one) for lifting the affine base to Jacobian."""
    if K.ncoords == 1:
        return KFp(ctx.one, 2.0)
    return (KFp(ctx.one, 2.0), KFp(ctx.zero(), 1.0))


@functools.lru_cache(maxsize=None)
def program(ncoords: int) -> Program:
    """Record one step for G1 (``ncoords`` 1) or G2 (2): buffers "acc"
    (3 x ncoords planes) and "base" (2 x ncoords) of reduced limbs, flag
    planes "inf_acc", "inf_base" and "bit"; outputs "acc_out" and "inf_out"
    (pallas_wsm._make_step_kernel)."""
    K = {1: _K1, 2: _K2}[ncoords]
    ctx = _Recorder()
    acc = tuple(K.read(ctx, "acc", i) for i in range(3))
    inf_acc = ctx.flag("inf_acc")
    base = tuple(K.read(ctx, "base", i) for i in range(2))
    inf_base = ctx.flag("inf_base")
    bit = ctx.flag("bit")

    dbl_pt = _k_jac_double(K, ctx, *acc)
    add_pt = _k_mixed_add(K, ctx, *dbl_pt, *base)
    # jac_add_fast's flag discipline: a base at infinity keeps the doubled
    # acc; an acc at infinity takes the (lifted) base
    add_pt = _pt_select_lanes(K, ctx, inf_base, dbl_pt, add_pt)
    base_jac = (base[0], base[1], _base_z_one(K, ctx))
    add_pt = _pt_select_lanes(K, ctx, inf_acc, base_jac, add_pt)
    inf_add = ctx.flag_and(inf_acc, inf_base)

    out_pt = _pt_select_lanes(K, ctx, bit, add_pt, dbl_pt)
    inf_out = ctx.flag_select(bit, inf_add, inf_acc)
    lanes = [c for v in out_pt for c in K.lanes(v)]
    for v in lanes:
        assert v.bound <= 2.0
    outputs = ([("acc_out", i, v.cols) for i, v in enumerate(lanes)]
               + [("inf_out", 0, inf_out)])
    return Program(f"wsm_step_g{ncoords}", ctx.ops, outputs)


# -- wrappers ---------------------------------------------------------------------

# Each curve's form: (kind, threads per lane, lanes per block), the faster at
# the path's 4,096 lanes of those timed on the card (PERF.md): G2 "group"
# (G = 16 before G = 8 and the cooperative form), G1 "coop" (before the
# group form at G = 4).
FORMS = {1: ("coop", 16, 8), 2: ("group", 16, 32)}

g1_launches = 0  # kernel launches (plain-version calls do not count)
g2_launches = 0


def _check(ncoords: int, named: dict) -> None:
    acc = named["acc"]
    n = acc.shape[-1]
    shapes = {"acc": (3 * ncoords, N, n), "inf_acc": (1, n), "base": (2 * ncoords, N, n),
              "inf_base": (1, n), "bit": (1, n)}
    for name, x in named.items():
        if x.dtype != torch.int32:
            raise TypeError(f"{name}: the WSM step takes int32 tensors")
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shapes[name]}")
        if x.device != acc.device:
            raise ValueError(f"{name}: on {x.device}, acc on {acc.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    if acc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the WSM step has no path for device {acc.device}")


def launcher(ncoords: int) -> str:
    """The C launcher of a curve's form: lh_wsm_step_g<nc>_coop or
    lh_wsm_step_g<nc>_g<G>."""
    kind, group, _ = FORMS[ncoords]
    return f"lh_wsm_step_g{ncoords}_" + ("coop" if kind == "coop" else f"g{group}")


def _lib() -> ctypes.CDLL:
    lib = _build.library("wsm_step")
    for nc in (1, 2):
        fn = getattr(lib, launcher(nc))
        if not fn.argtypes:
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def _plain(ncoords, acc, inf_acc, base, inf_base, bit):
    out = run_plain(program(ncoords), {"acc": acc, "inf_acc": inf_acc, "base": base,
                                       "inf_base": inf_base, "bit": bit})
    return out["acc_out"], out["inf_out"]


def _step(ncoords, acc, inf_acc, base, inf_base, bit):
    _check(ncoords, {"acc": acc, "inf_acc": inf_acc, "base": base, "inf_base": inf_base,
                     "bit": bit})
    if acc.device.type == "cpu":
        return _plain(ncoords, acc, inf_acc, base, inf_base, bit)
    acc_out, inf_out = torch.empty_like(acc), torch.empty_like(inf_acc)
    lib = _lib()
    err = getattr(lib, launcher(ncoords))(
        acc.data_ptr(), inf_acc.data_ptr(), base.data_ptr(), inf_base.data_ptr(),
        bit.data_ptr(), acc_out.data_ptr(), inf_out.data_ptr(), acc.shape[-1],
        torch.cuda.current_stream(acc.device).cuda_stream)
    _build.check(lib, err, f"wsm_step_g{ncoords} kernel")
    global g1_launches, g2_launches
    if ncoords == 1:
        g1_launches += 1
    else:
        g2_launches += 1
    return acc_out, inf_out


def wsm_step_g1_plain(acc, inf_acc, base, inf_base, bit):
    return _plain(1, acc, inf_acc, base, inf_base, bit)


def wsm_step_g2_plain(acc, inf_acc, base, inf_base, bit):
    return _plain(2, acc, inf_acc, base, inf_base, bit)


def wsm_step_g1(acc, inf_acc, base, inf_base, bit):
    """One G1 step: acc (3, 26, n) Jacobian, inf_acc (1, n), base (2, 26, n)
    affine, inf_base (1, n), bit (1, n) -> (acc', inf_acc').  CUDA tensors
    launch kernel 6's G1 entry point in its form (FORMS); CPU tensors take
    the plain version."""
    return _step(1, acc, inf_acc, base, inf_base, bit)


def wsm_step_g2(acc, inf_acc, base, inf_base, bit):
    """One G2 step on (6, 26, n) / (4, 26, n) planes; as wsm_step_g1."""
    return _step(2, acc, inf_acc, base, inf_base, bit)


# -- the driver (pallas_wsm.scalar_mul_bits_fused) --------------------------------


def scalar_mul_bits_fused(ops, p_aff, inf_base, wbits):
    """[k]P per lane through 64 (or nbits) step launches; the drop-in for
    ``points.scalar_mul_bits(ops, points.from_affine(ops, p_aff), wbits)``.

    ``p_aff``: affine (x, y) (LFp, or Fp2 pairs for G2); ``inf_base``:
    (*batch,) bool, lanes whose base is the identity; ``wbits``: (nbits,
    *batch) int MSB-first scalar bits.  Returns a Jacobian point (X, Y, Z,
    inf) with coordinates bounded by 2."""
    nc = ops.ncoords

    def pin(c):
        return F.relabel(F.guard_le(c, 2.0), 2.0)

    coords = [pin(c) for xy in p_aff for c in ops.lanes(xy)]
    batch = F.batch_shape(coords[0])
    base = torch.stack([c.limbs.reshape(N, -1) for c in coords])
    n = base.shape[-1]
    device = base.device
    one = F.bcast("ONE", (n,), device)
    zero = torch.zeros((N, n), dtype=F.DTYPE, device=device)
    # acc starts at the point at infinity: (one, one, zero), flag set
    acc = torch.stack([one] * nc + [one] * nc + [zero] * nc)
    inf_acc = torch.ones((1, n), dtype=torch.int32, device=device)
    inf_b = inf_base.reshape(1, n).to(torch.int32)
    bits = wbits.reshape(wbits.shape[0], n).to(torch.int32).contiguous()
    step = wsm_step_g1 if nc == 1 else wsm_step_g2
    for i in range(bits.shape[0]):
        acc, inf_acc = step(acc, inf_acc, base, inf_b, bits[i:i + 1])
    out = [F.LFp(acc[i].reshape((N,) + batch), 2.0) for i in range(3 * nc)]
    pt = tuple(ops.unlanes(out[i * nc:(i + 1) * nc]) for i in range(3))
    return pt + ((inf_acc != 0).reshape(batch),)
