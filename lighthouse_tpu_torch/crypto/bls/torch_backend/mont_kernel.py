"""Kernel 1: the batched Montgomery product, and its plain version.

Replaces ``lighthouse_tpu/crypto/bls/jax_backend/pallas_fp.py:_mont_kernel``
(``_mont_core`` = ``_wide_product`` + ``_mont_reduce``), the Pallas kernel
behind every ``fp.mont_mul`` on the TPU.

Contract: (26, n) x (26, n) int32 quasi limbs with bound product <= 2000 ->
(26, n) int32 STRICT limbs, the same limbs as the reference.  The
quasi-normalized intermediate m = (t * P') mod R is not unique (a different
representative shifts the output by P), so both versions reproduce the
reference's exact column sums and carry passes: two one-step carry passes
over the 52-column schoolbook, m from the low 26 columns of t * P' after
its two passes, u = m * P, then one 52-step carry.

Hopper design (csrc/mont.cu, mont_coop.cuh, group.cuh): G threads per
lane (16 or 4) in blocks of a few lanes whose ranks run the same code.  Each
of the three schoolbooks is cut into G tiles of one shape; a rank forms the
split lo/hi halves of its tile's products in registers and adds its
partial columns into the lane's column sums in shared memory (exact
integer sums, so the order of the ranks' adds changes nothing); the carry
passes run where their results are read, from windows two columns wide
below; the 52-step carry is resolved by carry maps composed across the
ranks.  Six phases, each ending at a block barrier.  What bounds it on the
card: 1,703 32-bit multiplies per lane, each with a mask, a shift and an
add, at 64 integer operations a clock per SM, against 312 bytes of
traffic.  With one thread per lane the whole chain was one thread's
straight-line stream, about one warp per SM sub-partition at the path's
widths, so the time per launch hardly depended on the width; the group
cuts each thread's chain to about 1/G of the products and gives the card
G times the warps.  At widths that fill the card the one-thread form
(blocks of 128, kept in mont.cu) issues fewer instructions in all (no tile
padding, no barriers), so ``form_for`` picks the form from the width.  The
limb-major layout puts limb i of neighbouring lanes in neighbouring words,
so every load and store coalesces; the ragged edge is masked, not padded.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import fp as F
from .fp import BITS, MASK, N, compress1, compress2, const

launches = 0  # kernel launches (plain-version calls do not count)

# The compiled forms: (threads per lane, lanes per block); (1, 128) is the
# one-thread form.
FORMS = ((16, 8), (16, 16), (4, 32), (1, 128))
# The widest n each group form is used for, in FORMS' order; wider calls
# take the one-thread form (chip_smoke.py's mont_groups phase times every
# form at the path's heaviest widths and at wider ones).
FORM_MAX_WIDTH = (1024, 6144, 16384)

IMAD_PER_LANE = 26 * 26 + 26 * 27 // 2 + 26 * 26  # multiplies per lane in the kernel
SQR_IMAD_PER_LANE = 26 * 27 // 2 + 26 * 27 // 2 + 26 * 26  # the triangle square's


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("mont_mul takes int32 limb tensors")
    if a.dim() != 2 or a.shape[0] != N or a.shape != b.shape:
        raise ValueError(f"mont_mul takes two (26, n) tensors, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError("mont_mul operands on different devices")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("mont_mul takes contiguous tensors")


def form_for(n: int) -> tuple:
    """The form of kernel 1 for an n-lane product."""
    for form, widest in zip(FORMS, FORM_MAX_WIDTH):
        if n <= widest:
            return form
    return FORMS[-1]


def _lib() -> ctypes.CDLL:
    lib = _build.library("mont")
    if not lib.lh_mont_mul.argtypes:
        lib.lh_mont_mul.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.lh_mont_mul.restype = ctypes.c_int
    return lib


def mont_mul(a: torch.Tensor, b: torch.Tensor, form: tuple | None = None) -> torch.Tensor:
    """Batched Montgomery product.  CUDA tensors launch the kernel on the
    current stream, in ``form`` (one of FORMS; by default ``form_for(n)``);
    CPU tensors take the plain version."""
    _check(a, b)
    if form is not None and tuple(form) not in FORMS:
        raise ValueError(f"mont_mul has no form {form}")
    if a.device.type == "cpu":
        return mont_mul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"mont_mul has no path for device {a.device}")
    n = a.shape[1]
    out = torch.empty_like(a)
    if n == 0:
        return out
    lib = _lib()
    group, lanes = form_for(n) if form is None else form
    err = lib.lh_mont_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, group, lanes,
                          torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, err, "mont_mul kernel")
    global launches
    launches += 1
    return out


def _columns(p: torch.Tensor) -> torch.Tensor:
    """(26, 26, n) int64 products, entry (i, j) of weight 2^(15 (i + j)) ->
    (52, n) schoolbook columns: its low 15 bits at column i+j, its high
    bits at i+j+1, two carry passes applied.

    Row i of the product matrix lands at columns i..i+25 of a (26, 53, n)
    buffer through one strided view (the lo halves) and the same view
    shifted by one column (the hi halves); summing the rows gives the
    column sums."""
    n = F.seen(p).shape[-1]
    rows = torch.zeros((N, 2 * N + 1, n), dtype=torch.int64, device=p.device)
    rows.as_strided((N, N, n), ((2 * N + 2) * n, n, 1)).copy_(p & MASK)
    rows.as_strided((N, N, n), ((2 * N + 2) * n, n, 1), n).add_(p >> BITS)
    return F.seen(compress2(F.seen(rows.sum(0)[: 2 * N])))


def _wide_product(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(26, n) x (26, n|1) int64 -> (52, n) schoolbook columns of the split
    32-bit products, two carry passes applied (pallas_fp._wide_product)."""
    return _columns(x[:, None, :] * y[None, :, :])


@functools.lru_cache(maxsize=None)
def _triangle(device: str) -> torch.Tensor:
    """(26, 26, 1) weights of the square's triangle: 2 above the diagonal,
    1 on it, 0 below."""
    w = torch.triu(torch.full((N, N), 2, dtype=torch.int64), 1) + torch.eye(N, dtype=torch.int64)
    return w.reshape(N, N, 1).to(device)


def _wide_square(x: torch.Tensor) -> torch.Tensor:
    """(26, n) int64 -> the (52, n) columns of pallas_fp._wide_square: the
    j >= i triangle, each cross product doubled BEFORE its lo/hi split (the
    column sums differ from _wide_product(x, x)'s), then two carry passes."""
    return _columns(x[:, None, :] * x[None, :, :] * _triangle(str(x.device)))


def _reduce_tail(s: torch.Tensor) -> torch.Tensor:
    """(t + u) / R as strict limbs: the reference's 52-step carry chain,
    keeping limbs 26..51.  After two carry passes the low 26 limbs hold a
    value L below 2^391 that R divides (t + u is a multiple of R), so L is
    0 or exactly R: the carry into limb 26 is 1 iff any low limb is
    nonzero.  Carry passes then finish the high limbs (each pass moves a
    carry of at most 1 one limb up; a second pass is rarely needed)."""
    c = compress2(F.seen(s))
    high = c[N:].clone()
    high[0] += c[:N].ne(0).any(dim=0).to(c.dtype)
    while bool((high >> BITS).any()):
        high = compress1(high)
    return high


def _mont_reduce(t: torch.Tensor) -> torch.Tensor:
    """pallas_fp._mont_reduce of the (52, n) int64 columns t -> strict int32
    limbs: m = low half of t * P', u = m * P, (t + u) / R."""
    m = _wide_product(t[:N], const("PP", t).long())[:N]
    u = _wide_product(m, const("P", t).long())
    return _reduce_tail(t + u).to(torch.int32)


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of kernel 1: the same limbs, computed with
    int64 outer products summed along anti-diagonals."""
    return _mont_reduce(_wide_product(a.long(), b.long()))


def mont_sqr_plain(a: torch.Tensor) -> torch.Tensor:
    """The plain version of the triangle square (pallas_fp._mont_sqr_core,
    csrc/mont.cuh mont_sqr_core): the same limbs as the reference's square,
    which need not be mont_mul_plain(a, a)'s."""
    return _mont_reduce(_wide_square(a.long()))
