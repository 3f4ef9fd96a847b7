"""Kernels 4 and 5: static-exponent chains in Fp and Fp2, and their plain
versions.

Replaces ``lighthouse_tpu/crypto/bls/jax_backend/pallas_fp.py``:

* kernel 4, ``_make_megachain_kernel`` / ``_megachain_call`` /
  ``pow_chain_limbs``: a^e in Fp, behind ``fp.fp_pow`` (so every Fermat
  inversion, ``fp_inv``) under the chain arm;
* kernel 5, ``_make_fp2_megachain_kernel`` / ``_fp2_megachain_call`` /
  ``fp2_pow_chain``: a^e in Fp2, behind ``h2c.fp2_pow_static`` (the
  (p^2 + 7) / 16 square-root chain of the SSWU map).

Contract (as the reference's): the exponent is an MSB-first tape of
base-2^4 digits.  powers[0] is the Montgomery one, powers[1] the base,
powers[k] = powers[k-1] * base; the accumulator starts at powers[tape[0]]
and each later digit costs 4 squares and one multiply by powers[digit] (a
0 digit multiplies by the one, which rewrites the limbs: never skipped).
The Fp chain squares with the triangle square; its base must be bounded
below 4.3 P.  The Fp2 chain uses its own Karatsuba cores with fixed 16P /
2P biases and the full product only; its inputs are reduced (bound <= 2).
Outputs are the reference's limbs byte for byte.

Under the MXU arm (``fp.mxu_active()``) both chains run their products on
the 13-bit plane (kernel 7's core, mxu_kernel.py): the Fp chain's square is
then the full product mont(a, a), not the triangle (pallas_fp._core_pair).
Those variants launch as ``fp_chain_mxu`` and ``fp2_chain_mxu``.

Hopper design (csrc/chain.cu): one launch per chain.  The 15-bit chains
run in kernel 1's group form (csrc/mont_coop.cuh): 16 threads per lane, each
product and square cut into tiles, one per rank, its phases ending at block
barriers; the Fp chain squares with the group triangle square.  The lane's
power table, accumulator and temporaries stay in shared memory, so a
digit's table entry is a shared-memory offset.  The Fp2 chain's products
run one after another on all 16 ranks, its linear ops dealt to the ranks
limb by limb.  ``FP_FORMS`` lists the Fp chain's forms (threads per lane,
lanes per block) and ``form_for`` picks one by width; the Fp2 chain has one
form, ``FP2_FORM``, the path's only width being 4,096.  The MXU variants
run the same chain bodies in one group form each (``FP_MXU_FORM``,
``FP2_MXU_FORM``: G ranks per lane, one per warp, blocks of 32 lanes) on
the 13-bit core ``mont_group_mxu_core`` (csrc/mxu_coop.cuh), the Fp chain
squaring with the full product.  What bounds it on the card: integer
multiplies (about 0.75M per lane for the p-2 chain, 3.6M for the Fp2 square
root) against a few hundred bytes per lane.  The digit tape sits in device memory, uploaded
once per device and exponent.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import fp as F
from . import mxu_kernel as X
from .mont_kernel import IMAD_PER_LANE, SQR_IMAD_PER_LANE, mont_mul_plain, mont_sqr_plain

N = F.N
CHAIN_WINDOW = 4  # pallas_fp.CHAIN_WINDOW: 2^w table entries, w squares + 1 multiply per digit

fp_launches = 0  # kernel launches (plain-version calls do not count)
fp2_launches = 0
fp_mxu_launches = 0  # the MXU variants
fp2_mxu_launches = 0

# The compiled forms of the 15-bit Fp chain: (threads per lane, lanes per block)
FP_FORMS = ((16, 8), (16, 16))
# The widest n each form is used for, in FP_FORMS' order; wider calls take
# the last form.  chip_smoke.py's chain_forms phase times both forms at the
# widths the path launches (1 and 4,096) and at a sweep between them:
# blocks of 8 lanes win at every width up to 3,072, blocks of 16 at 4,096;
# the widths between are not measured.
FORM_MAX_WIDTH = (3072,)
# The one form of the 15-bit Fp2 chain (csrc/chain.cu kFp2Lanes)
FP2_FORM = (16, 16)
# The one form of each MXU chain: G ranks per lane, one per warp, in blocks
# of 32 lanes (csrc/chain.cu kFpMxuGroup, kFp2MxuGroup)
FP_MXU_FORM = (8, 32)
FP2_MXU_FORM = (8, 32)


def window_digits(bitstr: str, w: int = CHAIN_WINDOW) -> list[int]:
    """MSB-aligned base-2^w digits of a binary string (pallas_fp._window_digits)."""
    pad = (-len(bitstr)) % w
    bitstr = "0" * pad + bitstr
    return [int(bitstr[i:i + w], 2) for i in range(0, len(bitstr), w)]


def _fp2_bits(bits) -> str:
    bits = tuple(int(b) for b in bits)
    if not bits or bits[0] != 1:
        raise ValueError("the Fp2 chain takes MSB-first bits with a leading 1")
    return "".join(str(b) for b in bits)


def products_per_lane(n_digits: int) -> dict:
    """Montgomery products one lane of each chain runs: the table, then
    4 squares and one multiply for every digit after the first."""
    table = (1 << CHAIN_WINDOW) - 2
    steps = n_digits - 1
    return {"fp": {"mul": table + steps, "sqr": CHAIN_WINDOW * steps},
            "fp2": {"mul": 3 * table + steps * (2 * CHAIN_WINDOW + 3), "sqr": 0}}


def imads_per_lane(kind: str, n_digits: int, mxu: bool = False) -> int:
    """32-bit multiplies one lane of the ``kind`` ("fp" or "fp2") chain does
    on the integer pipes (under MXU, a square is a full product)."""
    c = products_per_lane(n_digits)[kind]
    if mxu:
        return (c["mul"] + c["sqr"]) * X.IMAD_PER_LANE
    return c["mul"] * IMAD_PER_LANE + c["sqr"] * SQR_IMAD_PER_LANE


def form_for(n: int) -> tuple:
    """The form of the 15-bit Fp chain for an n-lane call."""
    for form, widest in zip(FP_FORMS, FORM_MAX_WIDTH):
        if n <= widest:
            return form
    return FP_FORMS[-1]


def _cores(mxu: bool):
    """(mul, sqr) plain cores: the 15-bit product and triangle square, or
    the 13-bit product for both (pallas_fp._core_pair)."""
    if mxu:
        return X.mont_mul_mxu_plain, lambda a: X.mont_mul_mxu_plain(a, a)
    return mont_mul_plain, mont_sqr_plain


@functools.lru_cache(maxsize=None)
def _tape(digits: tuple, device: str) -> torch.Tensor:
    """The digit tape on ``device``, uploaded once per device and exponent
    (pinned, without a host sync)."""
    return F.upload(torch.tensor(digits, dtype=torch.int32), device)


def _form(form, n: int) -> tuple:
    """The 15-bit Fp chain's form: ``form`` (one of FP_FORMS) or form_for(n)."""
    if form is None:
        return form_for(n)
    if tuple(form) not in FP_FORMS:
        raise ValueError(f"the Fp chain has no form {form}")
    return tuple(form)


def _check(name: str, *planes: torch.Tensor) -> None:
    a = planes[0]
    for x in planes:
        if x.dtype != torch.int32:
            raise TypeError(f"{name} takes int32 limb tensors")
        if x.dim() != 2 or x.shape[0] != N or x.shape != a.shape:
            raise ValueError(f"{name} takes (26, n) tensors of one shape, got {tuple(x.shape)}")
        if x.device != a.device:
            raise ValueError(f"{name} operands on different devices")
        if not x.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} has no path for device {a.device}")


def _lib() -> ctypes.CDLL:
    lib = _build.library("chain")
    if not lib.lh_fp_chain.argtypes:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.lh_fp_chain.argtypes = [vp, ci, vp, vp, ci, ci, ci, vp]
        lib.lh_fp_chain_mxu.argtypes = [vp, ci, vp, vp, ci, vp]
        lib.lh_fp2_chain.argtypes = [vp, ci, vp, vp, vp, vp, ci, vp]
        lib.lh_fp2_chain_mxu.argtypes = [vp, ci, vp, vp, vp, vp, ci, vp]
        for fn in (lib.lh_fp_chain, lib.lh_fp_chain_mxu, lib.lh_fp2_chain, lib.lh_fp2_chain_mxu):
            fn.restype = ctypes.c_int
    return lib


# -- kernel 4: Fp ----------------------------------------------------------------


def pow_chain_plain(base: torch.Tensor, exponent: int, mxu: bool = False) -> torch.Tensor:
    """The plain version of kernel 4 (of its MXU variant with ``mxu``):
    base^exponent in the Montgomery domain, the same limbs as
    pallas_fp.pow_chain_limbs(..., mxu=mxu)."""
    mul, sqr = _cores(mxu)
    digits = window_digits(bin(exponent)[2:])
    powers = [F.const("ONE", base).expand_as(base), base]
    for _ in range(2, 1 << CHAIN_WINDOW):
        powers.append(mul(powers[-1], base))
    acc = powers[digits[0]]
    for d in digits[1:]:
        for _ in range(CHAIN_WINDOW):
            acc = sqr(acc)
        acc = mul(acc, powers[d])
    return acc


def pow_chain(base: torch.Tensor, exponent: int, mxu: bool | None = None,
              form: tuple | None = None) -> torch.Tensor:
    """base^exponent for (26, n) limbs of values below 4.3 P -> (26, n)
    strict limbs.  CUDA tensors launch kernel 4 on the current stream, in
    ``form`` (one of FP_FORMS; by default ``form_for(n)``), or its MXU variant
    with ``mxu``, which defaults to ``fp.mxu_active()``; CPU tensors take
    the plain version."""
    _check("pow_chain", base)
    if exponent < 1:
        raise ValueError("pow_chain takes a positive exponent")
    mxu = F.mxu_active() if mxu is None else mxu
    n = base.shape[1]
    group, lanes = _form(form, n)
    if base.device.type == "cpu":
        return pow_chain_plain(base, exponent, mxu)
    digits = tuple(window_digits(bin(exponent)[2:]))
    out = torch.empty_like(base)
    if n == 0:
        return out
    lib = _lib()
    tape = _tape(digits, str(base.device)).data_ptr()
    stream = torch.cuda.current_stream(base.device).cuda_stream
    if mxu:
        err = lib.lh_fp_chain_mxu(tape, len(digits), base.data_ptr(), out.data_ptr(), n, stream)
    else:
        err = lib.lh_fp_chain(tape, len(digits), base.data_ptr(), out.data_ptr(), n, group,
                              lanes, stream)
    _build.check(lib, err, "fp_chain_mxu kernel" if mxu else "fp_chain kernel")
    global fp_launches, fp_mxu_launches
    if mxu:
        fp_mxu_launches += 1
    else:
        fp_launches += 1
    return out


# -- kernel 5: Fp2 ---------------------------------------------------------------


def _sub_biased(a: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    """a - b + kP, one carry pass (pallas_fp._sub_biased)."""
    return F.compress1(a + F.const(k, a) - b)


def _fp2_mul_core(a0, a1, b0, b1, mul=mont_mul_plain):
    """Karatsuba (pallas_fp._fp2_mul_core), the three products stacked into
    one call."""
    n = a0.shape[1]
    x = torch.cat([a0, a1, F.compress1(a0 + a1)], dim=1)
    y = torch.cat([b0, b1, F.compress1(b0 + b1)], dim=1)
    v0, v1, m = mul(x, y).split(n, dim=1)
    return _sub_biased(v0, v1, 2), _sub_biased(_sub_biased(m, v0, 2), v1, 2)


def _fp2_sqr_core(a0, a1, mul=mont_mul_plain):
    """(a0 + a1)(a0 - a1 + 16P), 2 a0 a1 (pallas_fp._fp2_sqr_core), the two
    products stacked into one call."""
    n = a0.shape[1]
    x = torch.cat([F.compress1(a0 + a1), a0], dim=1)
    y = torch.cat([_sub_biased(a0, a1, 16), a1], dim=1)
    r0, t = mul(x, y).split(n, dim=1)
    return r0, F.compress1(t + t)


def fp2_pow_chain_plain(a0: torch.Tensor, a1: torch.Tensor, bits, mxu: bool = False) -> tuple:
    """The plain version of kernel 5 (of its MXU variant with ``mxu``):
    (a0 + a1 u)^e for MSB-first ``bits`` (leading bit 1), the same limbs as
    pallas_fp.fp2_pow_chain(..., mxu=mxu)."""
    mul, _ = _cores(mxu)
    digits = window_digits(_fp2_bits(bits))
    powers = [(F.const("ONE", a0).expand_as(a0), torch.zeros_like(a0)), (a0, a1)]
    for _ in range(2, 1 << CHAIN_WINDOW):
        powers.append(_fp2_mul_core(*powers[-1], a0, a1, mul=mul))
    c0, c1 = powers[digits[0]]
    for d in digits[1:]:
        for _ in range(CHAIN_WINDOW):
            c0, c1 = _fp2_sqr_core(c0, c1, mul=mul)
        c0, c1 = _fp2_mul_core(c0, c1, *powers[d], mul=mul)
    return c0, c1


def fp2_pow_chain(a0: torch.Tensor, a1: torch.Tensor, bits, mxu: bool | None = None) -> tuple:
    """(a0 + a1 u)^e for reduced (26, n) limb planes and MSB-first ``bits``
    -> (r0, r1), each bounded by 6 P.  CUDA tensors launch kernel 5 on the
    current stream (in FP2_FORM), or its MXU variant with ``mxu``, which
    defaults to ``fp.mxu_active()``; CPU tensors take the plain version."""
    _check("fp2_pow_chain", a0, a1)
    mxu = F.mxu_active() if mxu is None else mxu
    n = a0.shape[1]
    if a0.device.type == "cpu":
        return fp2_pow_chain_plain(a0, a1, bits, mxu)
    digits = tuple(window_digits(_fp2_bits(bits)))
    o0, o1 = torch.empty_like(a0), torch.empty_like(a1)
    if n == 0:
        return o0, o1
    lib = _lib()
    tape = _tape(digits, str(a0.device)).data_ptr()
    stream = torch.cuda.current_stream(a0.device).cuda_stream
    ptrs = (a0.data_ptr(), a1.data_ptr(), o0.data_ptr(), o1.data_ptr())
    launch = lib.lh_fp2_chain_mxu if mxu else lib.lh_fp2_chain
    err = launch(tape, len(digits), *ptrs, n, stream)
    _build.check(lib, err, "fp2_chain_mxu kernel" if mxu else "fp2_chain kernel")
    global fp2_launches, fp2_mxu_launches
    if mxu:
        fp2_mxu_launches += 1
    else:
        fp2_launches += 1
    return o0, o1
