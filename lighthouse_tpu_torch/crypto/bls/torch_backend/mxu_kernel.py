"""Kernel 7: the Montgomery product on the 31 x 13-bit plane, and its plain
version.

Replaces ``lighthouse_tpu/crypto/bls/jax_backend/pallas_mxu.py:mont_core_mxu``
(the body of ``pallas_fp._mont_kernel_mxu``), the ``mxu13`` arm of the
reference's kernel-arm registry.  The same core runs inside the MXU variants
of the chains (chain_kernel.py) and of the Miller steps (miller_kernel.py).

Contract (as the reference's): (26, n) x (26, n) int32 quasi-15 limbs with
bound product <= 2000 -> (26, n) STRICT 15-bit limbs, value a*b*R^-1 + kP.
The algebra is the 15-bit core's with R = 2^390 shared (26 * 15 = 30 * 13):

    a13, b13 = to13(a), to13(b)      quasi-13 limbs (<= 8193), exact in value
    t = a13 * b13                    61 columns, three 13-bit carry passes
    m = low 30 columns of t * P'13   (three carry passes)
    u = m * P13                      61 columns, three carry passes
    out = to15((t + u) / 2^390)      a 61-step carry, then a 13 -> 15 regroup

Every column sum is below 31 * 8193^2 < 2^31.

Two points decide byte identity with the reference.  P13 and P'13 are the
reference's in-kernel ``_to13`` of the 15-bit constants, quasi-13 limbs
that need not be the strict 13-bit limbs of the same integers: a different
representative of P' changes the low columns of t * P', so m changes and the
output moves by one P.  And carry passes move carries upward only, so the
low 30 columns of t * P' depend only on the 465 products with i + j <= 29:
the kernel forms only those (the reference, and the plain version here,
form all 961 and slice).  The result may differ in bytes from the 15-bit
core's (kernel 1) on a ~2^-13 sliver of inputs (pallas_mxu.py:27-32), by
one P, never in value mod P.

Hopper design (csrc/mxu.cu, csrc/mxu_coop.cuh, csrc/mxu.cuh): two forms,
``FORMS``.  The group form ``MXU_FORM``: G ranks per lane, one rank per
warp, in blocks of 32 lanes, running the cooperative core
``mont_group_mxu_core`` that kernels 4m and 5m also run.  a * b has two
per-lane operands, so its 961 products are 32-bit multiply-adds, cut into G
tiles summed by shared-memory atomics.  The two other products have a
lane-invariant right operand, so they are true matrix products,
Toeplitz(P'13)[0:32, 0:32] @ t13 and Toeplitz(P13)[0:64, 0:32] @ m13 with
the block's 32 lanes along N, and run on the FP64 tensor cores
(``mma.sync.aligned.m8n8k4`` DMMA) as tile pairs dealt to the warps: every
product is below 2^27 and every column sum below 2^31, exact in a 53-bit
mantissa.  The carry passes and the 61-step carry are cut into blocks of
columns, one per rank, the carry composed from per-rank carry maps.  The
core's first phase reads the operands straight from their global planes;
its last stores the strict limbs.  The one-thread form (blocks of 64, each
warp staging its DMMA operands in shared memory) issues fewer instructions
in all, and wins where the group form needs several waves of blocks, so
``form_for`` picks the form from the width.  What bounds it on the card:
the bytes (312 per lane) set a bound of some hundred nanoseconds at most of
the path's widths; the group form takes the latency of eight barrier
phases and a launch.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from . import fp as F
from .fp import MASK, N, P_NP, PPRIME_NP, QMAX, upload

BITS13 = 13
NL13 = 31  # 30 limbs span R = 2^390, plus one spill limb
NCOLS = 2 * NL13 - 1  # 61 schoolbook columns
M13 = (1 << BITS13) - 1
QMAX13 = (1 << BITS13) + 2  # limbs.SPEC13.qmax: to13 emits <= 8193
NLOW = 30  # m = the low 30 columns of t * P'

# Multiplies per lane in the kernel: a * b on the integer pipes; the two
# products with a constant operand on the tensor cores (products that can be
# nonzero: P13's limb 30 is zero, so m * P has 30 x 30).
IMAD_PER_LANE = NL13 * NL13
DMMA_FMA_PER_LANE = NLOW * (NLOW + 1) // 2 + NLOW * NLOW

launches = 0  # kernel launches (plain-version calls do not count)

# The compiled forms: (ranks per lane, lanes per block).  The group form, G
# ranks, one per warp, in blocks of 32 lanes (csrc/mxu.cu kMontMxuGroup), and
# the one-thread form in blocks of 64.
MXU_FORM = (8, 32)
FORMS = (MXU_FORM, (1, 64))
# The widest n the group form is used for; wider calls take the one-thread
# form.  chip_smoke.py's mxu_widths phase times both forms at every width of
# the mxu arm: the group form wins up to 36,864 lanes, the one-thread form at
# 49,152 and 73,728; the widths between are not launched.
FORM_MAX_WIDTH = (36864,)

# to13: 15-bit limb i sits at bit 15 i = 13 q + r, split into 13-bit chunks
# at columns q, q + 1 and, where QMAX << r reaches bit 26, q + 2.
_Q, _R = (np.array(x) for x in zip(*(divmod(15 * i, BITS13) for i in range(N))))
_THIRD = np.array([((QMAX << int(r)) >> 26) > 0 for r in _R])
# to15: strict 15-bit limb q collects bits [15 q, 15 q + 15) from 13-bit
# limbs j, j + 1 and, where 15 q is 12 bits into limb j, j + 2.
_J, _S = (np.array(x) for x in zip(*(divmod(15 * q, BITS13) for q in range(N))))


@functools.lru_cache(maxsize=None)
def _tables(device) -> dict:
    """The regrouping tables as int64 tensors on ``device``, made once."""
    third = np.flatnonzero(_THIRD)
    return {name: torch.as_tensor(x, dtype=torch.int64, device=device)
            for name, x in (("q", _Q), ("q1", _Q + 1), ("r", _R[:, None]), ("third", third),
                            ("q2", (_Q + 2)[third]), ("j", _J), ("j1", _J + 1),
                            ("j2", np.minimum(_J + 2, NL13 - 1)), ("s", _S[:, None]))}


def compress13(cols: torch.Tensor) -> torch.Tensor:
    """One 13-bit carry pass (pallas_mxu._compress13); the top row's carry
    is dropped."""
    out = cols & M13
    out[1:] += cols[:-1] >> BITS13
    return out


def to13_plain(a15: torch.Tensor) -> torch.Tensor:
    """(26, n) quasi-15 limbs -> (31, n) int64 quasi-13 limbs (<= 8193),
    exact in value (pallas_mxu._to13)."""
    a = a15.long()
    tb = _tables(a.device)
    v = F.seen(a << tb["r"])
    cols = torch.zeros((NL13,) + tuple(a.shape[1:]), dtype=torch.int64, device=a.device)
    cols.index_add_(0, tb["q"], v & M13)
    cols.index_add_(0, tb["q1"], (v >> BITS13) & M13)
    cols.index_add_(0, tb["q2"], v[tb["third"]] >> 26)
    return compress13(cols)


def to15_plain(a13: torch.Tensor) -> torch.Tensor:
    """(31, n) STRICT 13-bit limbs of a value below 2^390 -> (26, n) strict
    15-bit limbs (pallas_mxu._to15)."""
    a = a13.long()
    tb = _tables(a.device)
    s = tb["s"]
    acc = (a[tb["j"]] >> s) + (a[tb["j1"]] << (BITS13 - s))
    acc = acc + torch.where(s == 12, a[tb["j2"]] << (2 * BITS13 - s), 0)
    return acc & MASK


@functools.lru_cache(maxsize=None)
def constants13() -> dict:
    """P and P' re-limbed as the reference does in-kernel: to13 of the
    15-bit constants (host numpy, (31,) int64 each)."""
    return {name: to13_plain(torch.as_tensor(col).reshape(N, 1))[:, 0].numpy()
            for name, col in (("P13", P_NP), ("PP13", PPRIME_NP))}


@functools.lru_cache(maxsize=None)
def _const13(name: str, device: str) -> torch.Tensor:
    return upload(torch.as_tensor(constants13()[name]).reshape(NL13, 1), device)


def dot_cols_plain(a13: torch.Tensor, b13: torch.Tensor) -> torch.Tensor:
    """All 61 schoolbook columns of a 31 x 31 limb product, then three 13-bit
    carry passes (pallas_mxu._dot_cols).  ``b13`` may be a (31, 1) constant.
    Row i of the int64 outer product lands at columns i..i+30 of a (31, 62,
    n) buffer through one strided view; summing the rows gives the columns."""
    outer = F.seen(a13[:, None, :] * b13[None, :, :])
    n = outer.shape[-1]
    rows = torch.zeros((NL13, 2 * NL13, n), dtype=torch.int64, device=outer.device)
    rows.as_strided((NL13, NL13, n), ((2 * NL13 + 1) * n, n, 1)).copy_(outer)
    cols = F.seen(rows.sum(0)[:NCOLS])
    return F.seen(compress13(compress13(compress13(cols))))


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    """A (30, n) slice back to the 31-row plane, zero spill row."""
    return torch.cat([x, torch.zeros_like(x[:1])])


def _strict13(cols: torch.Tensor) -> torch.Tensor:
    """Strict 13-bit limbs of sum(cols[k] << 13 k) mod 2^(13 len(cols)), for
    columns below 2^15: what the reference's sequential carry chain computes
    (strict limbs of a value are unique).  Two carry passes leave every
    column <= 2^13, so the carry into each limb is 0 or 1 and a parallel
    prefix finds it (fp.full_chain on the 13-bit plane)."""
    c = F.seen(compress13(compress13(cols)))
    carry_in = F._shift_up(F._carry_prefix(c > M13, c == M13), 1).to(c.dtype)
    return (c + carry_in) & M13


def mont_mul_mxu_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of kernel 7: the limbs of
    pallas_mxu.mont_core_mxu, in int64."""
    dev = str(a.device)
    n = a.shape[1]
    a13, b13 = F.seen(to13_plain(torch.cat([a, b], dim=1))).split(n, dim=1)
    t = dot_cols_plain(a13, b13)
    m = dot_cols_plain(_pad_row(t[:NLOW]), _const13("PP13", dev))[:NLOW]
    u = dot_cols_plain(_pad_row(m), _const13("P13", dev))
    return to15_plain(_strict13(F.seen(t + u))[NLOW:]).to(torch.int32)


# -- the wrapper ------------------------------------------------------------------


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("mont_mul_mxu takes int32 limb tensors")
    if a.dim() != 2 or a.shape[0] != N or a.shape != b.shape:
        raise ValueError(f"mont_mul_mxu takes two (26, n) tensors, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError("mont_mul_mxu operands on different devices")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("mont_mul_mxu takes contiguous tensors")


def form_for(n: int) -> tuple:
    """The form of kernel 7 for an n-lane product."""
    for form, widest in zip(FORMS, FORM_MAX_WIDTH):
        if n <= widest:
            return form
    return FORMS[-1]


def _lib() -> ctypes.CDLL:
    lib = _build.library("mxu")
    if not lib.lh_mont_mul_mxu.argtypes:
        lib.lh_mont_mul_mxu.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        lib.lh_mont_mul_mxu.restype = ctypes.c_int
    return lib


def mont_mul_mxu(a: torch.Tensor, b: torch.Tensor, form: tuple | None = None) -> torch.Tensor:
    """Batched Montgomery product on the 13-bit plane.  CUDA tensors launch
    kernel 7 on the current stream, in ``form`` (one of FORMS; by default
    ``form_for(n)``); CPU tensors take the plain version."""
    _check(a, b)
    if form is not None and tuple(form) not in FORMS:
        raise ValueError(f"mont_mul_mxu has no form {form}")
    if a.device.type == "cpu":
        return mont_mul_mxu_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"mont_mul_mxu has no path for device {a.device}")
    n = a.shape[1]
    out = torch.empty_like(a)
    if n == 0:
        return out
    lib = _lib()
    group, lanes = form_for(n) if form is None else form
    err = lib.lh_mont_mul_mxu(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, group, lanes,
                              torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, err, "mont_mul_mxu kernel")
    global launches
    launches += 1
    return out
