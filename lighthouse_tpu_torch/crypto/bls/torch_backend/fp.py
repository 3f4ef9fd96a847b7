"""Batched BLS12-381 base-field arithmetic on PyTorch tensors.

Port of the JAX package's ``jax_backend/limbs.py`` + ``jax_backend/fp.py``.
The representation is the same, so every limb the port produces can be held
against the JAX package's byte for byte:

An Fp element is an ``LFp(limbs, bound)``: 26 x 15-bit limbs, little-endian,
shape ``(26, *batch)`` (the limb axis leads), Montgomery domain with
R = 2^390.  ``bound`` is a static Python float, an upper bound on the value
in units of P.  Limbs are only quasi-normalized (<= QMAX = 2^15 + 2^7);
additions and subtractions are one vector op plus one carry pass, and the
Montgomery product is the only op with a full carry chain.

Storage is ``torch.int32`` on every device: every stored limb fits below
2^31 (quasi limbs <= 32,896, bias limbs <= 65,663, the widest glue sum
``a + bias - b`` <= 98,559) and nothing relies on unsigned wrap-around —
``_k_for`` picks a bias that dominates the subtrahend column by column, so
no subtraction goes negative.  Products exist only inside the Montgomery
kernel (uint32 registers) or inside its plain version (int64).

Op contracts (identical to the JAX package):

* ``fp_add``: value a+b, bound a.bound + b.bound.
* ``fp_sub``: value a - b + k*P with k from ``_k_for(b.bound)``.
* ``mont_mul``: a.bound * b.bound <= 2000; strict limbs out, bound
  prod/625 + 1.1.  Routed to kernel 1 (mont_kernel.py), or to kernel 7
  (mxu_kernel.py) under the MXU arm.
* ``fp_reduce(x) = mont_mul(x, R mod P)``, bound pinned to 2.0.
* ``fp_canon``: canonical limbs (value < P), only at the edges.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
from fractions import Fraction

import numpy as np
import torch

from .. import params

BITS = 15
N = 26  # 26 * 15 = 390 bits >= 381
MASK = (1 << BITS) - 1
QMAX = (1 << BITS) + (1 << 7)  # quasi-normalized limb bound
DTYPE = torch.int32

MAX_MUL_PRODUCT = 2000.0  # max a.bound * b.bound entering mont_mul
MAX_BOUND = 500.0  # max value bound anywhere (keeps the top limb small)
MONT_DIVISOR = 625.0  # mont output bound: prod / 625 + 1.1 (R/P = 630.05)
MONT_EPS = 1.1
REDUCE_PIN = 2.0  # fp_reduce's output label (exact worst case 1.794)

P_INT = params.P
R_INT = 1 << (BITS * N)  # Montgomery radix 2^390
R1_INT = R_INT % P_INT  # 1 in Montgomery form
R2_INT = R_INT * R_INT % P_INT
PPRIME_INT = (-pow(P_INT, -1, R_INT)) % R_INT  # -P^-1 mod R

# Re-derived from first principles (no table is copied from the JAX package;
# tests/test_torch_fp.py holds every table against it).
assert R_INT > 512 * P_INT  # bound-tracking headroom (MAX_BOUND)
assert (PPRIME_INT * P_INT) % R_INT == R_INT - 1  # P * P' == -1 mod R
assert 0 <= R1_INT < P_INT and (R1_INT - R_INT) % P_INT == 0

BIAS_KS = (2, 4, 8, 16, 32, 64, 128, 256)


class LFp:
    """Lazy field element: quasi-normalized limbs + static value bound (in
    units of P)."""

    __slots__ = ("limbs", "bound")

    def __init__(self, limbs: torch.Tensor, bound: float):
        self.limbs = limbs
        self.bound = bound

    def __repr__(self):
        return f"LFp(shape={tuple(self.limbs.shape)}, bound={self.bound})"


# ---------------------------------------------------------------------------
# Host codecs and constant tables (numpy)
# ---------------------------------------------------------------------------


def int_to_limbs(x: int) -> np.ndarray:
    """Non-negative int < 2^390 -> (N,) int32 strict limbs."""
    assert 0 <= x < R_INT
    return np.array([(x >> (BITS * i)) & MASK for i in range(N)], dtype=np.int32)


def limbs_to_int(limbs) -> int:
    arr = np.asarray(limbs, dtype=np.int64)
    return sum(int(v) << (BITS * i) for i, v in enumerate(arr))


def ints_to_limbs(xs) -> np.ndarray:
    """ints -> (N, B) int32 strict limb columns (bytes -> bits -> 15-bit
    groups, vectorized)."""
    B = len(xs)
    if B == 0:
        return np.zeros((N, 0), dtype=np.int32)
    raw = np.frombuffer(
        b"".join(x.to_bytes(49, "little") for x in xs), dtype=np.uint8
    ).reshape(B, 49)
    bits = np.unpackbits(raw, axis=1, bitorder="little")[:, : N * BITS]
    weights = 1 << np.arange(BITS, dtype=np.int32)
    limbs = (bits.reshape(B, N, BITS) * weights[None, None, :]).sum(
        axis=2, dtype=np.int32
    )
    return np.ascontiguousarray(limbs.T)


def limbs_to_ints(limbs) -> list[int]:
    arr = limbs.cpu().numpy() if isinstance(limbs, torch.Tensor) else np.asarray(limbs)
    flat = arr.reshape(N, -1)
    return [limbs_to_int(flat[:, j]) for j in range(flat.shape[1])]


def _biased_kp(k: int) -> np.ndarray:
    """k*P with every non-top limb boosted to >= QMAX by borrowing from the
    limb above, so (a + bias - b) is column-wise non-negative for quasi b.
    The borrow lowers the top limb by one, which is why ``_k_for`` also
    checks top-column domination."""
    limbs = [int(v) for v in int_to_limbs(k * P_INT)]
    for i in range(N - 1):
        while limbs[i] < QMAX:
            limbs[i] += 1 << BITS
            limbs[i + 1] -= 1
    assert limbs[N - 1] >= 0, f"bias top limb underflow for k={k}"
    assert sum(v << (BITS * i) for i, v in enumerate(limbs)) == k * P_INT
    return np.array(limbs, dtype=np.int32)


P_NP = int_to_limbs(P_INT)
PPRIME_NP = int_to_limbs(PPRIME_INT)
ONE_NP = int_to_limbs(R1_INT)
BIAS_NP = {k: _biased_kp(k) for k in BIAS_KS}


def upload(t: torch.Tensor, device) -> torch.Tensor:
    """Host tensor -> ``device`` without a host sync.  A CUDA upload goes
    from pinned memory and does not block (PyTorch keeps the pinned buffer
    alive until the copy has run); a copy from pageable memory would wait
    for the stream to drain, which the device program must never do."""
    device = torch.device(device)
    if device.type == "cuda":
        # A captured copy would read this pinned buffer again on every
        # replay, long after PyTorch has handed it to someone else: every
        # constant is uploaded by the warm-up run, before a capture.
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("upload: a host-to-device copy inside a CUDA graph capture "
                               "(the warm-up run should have cached it)")
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@functools.lru_cache(maxsize=None)
def _const_col(key, device: str) -> torch.Tensor:
    arr = BIAS_NP[key] if isinstance(key, int) else {
        "P": P_NP, "PP": PPRIME_NP, "ONE": ONE_NP}[key]
    return upload(torch.as_tensor(arr, dtype=DTYPE).reshape(N, 1), device)


@functools.lru_cache(maxsize=None)
def int_col(x: int, device: str) -> torch.Tensor:
    """(26, 1) strict limbs of the integer x on ``device``, uploaded once."""
    return upload(torch.as_tensor(int_to_limbs(x)).reshape(N, 1), device)


def const(key, like: torch.Tensor) -> torch.Tensor:
    """Constant limb column (``"P"``, ``"PP"``, ``"ONE"`` or a bias k),
    shaped to broadcast against ``like`` (limbs of shape (26, *batch))."""
    col = _const_col(key, str(like.device))
    return col.reshape((N,) + (1,) * (like.dim() - 1))


def bcast(key, batch_shape, device) -> torch.Tensor:
    col = _const_col(key, str(torch.device(device)))
    shape = tuple(batch_shape)
    return col.reshape((N,) + (1,) * len(shape)).expand((N,) + shape)


def zero_like(a: LFp) -> LFp:
    return LFp(torch.zeros_like(a.limbs), 0.0)


def one_like(a: LFp) -> LFp:
    return LFp(bcast("ONE", a.limbs.shape[1:], a.limbs.device), 1.0)


def batch_shape(a: LFp):
    return tuple(a.limbs.shape[1:])


# ---------------------------------------------------------------------------
# Range probe: the widest intermediate of the plain Montgomery products
# ---------------------------------------------------------------------------

_widest: list | None = None


def seen(x: torch.Tensor) -> torch.Tensor:
    """Record x's largest value while a range_probe is open; returns x."""
    if _widest is not None:
        _widest.append(int(x.max()))
    return x


@contextlib.contextmanager
def range_probe():
    """Record the maximum of every intermediate of the plain products
    (mont_kernel, mxu_kernel) run inside the block; yields the list."""
    global _widest
    prev, _widest = _widest, []
    try:
        yield _widest
    finally:
        _widest = prev


# ---------------------------------------------------------------------------
# Carry handling (raw limb tensors)
# ---------------------------------------------------------------------------


def compress1(cols: torch.Tensor) -> torch.Tensor:
    """One carry pass: each limb keeps its low 15 bits plus the high bits
    of the limb below.  The top limb's carry is dropped (statically zero
    for any value below MAX_BOUND * P)."""
    out = cols & MASK
    out[1:] += cols[:-1] >> BITS
    return out


def compress2(cols: torch.Tensor) -> torch.Tensor:
    return compress1(compress1(cols))


def _shift_up(x: torch.Tensor, d: int) -> torch.Tensor:
    """x[k - d] at row k, zeros (False) in the first d rows."""
    return torch.cat([torch.zeros_like(x[:d]), x[:-d]])


def _carry_prefix(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Parallel prefix (Kogge-Stone) along the limb axis: row k of the
    result is set iff a carry (or borrow) leaves limb k, given the limbs
    that generate one (g) and the limbs that pass one on (p)."""
    d = 1
    while d < g.shape[0]:
        g = g | (p & _shift_up(g, d))
        p = p & _shift_up(p, d)
        d *= 2
    return g


def full_chain(cols: torch.Tensor) -> torch.Tensor:
    """Strict limbs of sum(cols[k] << 15k) mod 2^(15 * len(cols)), for
    columns below 2^30 — what the JAX package's sequential carry scan
    computes (strict limbs of a value are unique).  Two carry passes leave
    every column <= 2^15, so the carry into each limb is 0 or 1 and a
    parallel prefix finds it: a limb generates a carry at 2^15 and passes
    one on at MASK."""
    c = compress2(cols)
    carry_in = _shift_up(_carry_prefix(c > MASK, c == MASK), 1).to(c.dtype)
    return (c + carry_in) & MASK


def sub_chain(x: torch.Tensor, y: torch.Tensor):
    """Limb-wise x - y with borrow (strict inputs): (diff, final borrow).
    The JAX package scans the 26 limbs; here the borrows come from the same
    parallel prefix as ``full_chain`` (a limb generates a borrow where
    x < y and passes one on where x == y).  Same limbs, same borrow."""
    g = _carry_prefix(x < y, x == y)
    diff = (x + (1 << BITS) - y - _shift_up(g, 1).to(x.dtype)) & MASK
    return diff, g[-1]


# ---------------------------------------------------------------------------
# Add / sub / neg (chain-free)
# ---------------------------------------------------------------------------


def _check_bound(b: float, who: str):
    assert b <= MAX_BOUND, f"{who}: value bound {b} exceeds {MAX_BOUND}P"


def fp_add(a: LFp, b: LFp) -> LFp:
    out = a.bound + b.bound
    _check_bound(out, "fp_add")
    return LFp(compress1(a.limbs + b.limbs), out)


def _sub_top_dominates(bound: float, k: int) -> bool:
    """Exact check that the k bias dominates every quasi subtrahend of value
    bound ``bound`` in the top column too (limb 25 of such a value is at
    most floor(bound * P / 2^375))."""
    top = int(BIAS_NP[k][N - 1])
    return Fraction(bound) * P_INT < (top + 1) << (BITS * (N - 1))


@functools.lru_cache(maxsize=None)
def _k_for(bound: float) -> int:
    """Smallest bias constant k with k >= bound AND top-limb domination.
    The glue ops and the fused Miller kernels share it, so both pick the
    same k."""
    for k in BIAS_KS:
        if k >= bound and _sub_top_dominates(bound, k):
            return k
    raise AssertionError(f"no safe bias constant for bound {bound}")


def fp_sub(a: LFp, b: LFp) -> LFp:
    k = _k_for(b.bound)
    out = a.bound + k
    _check_bound(out, "fp_sub")
    return LFp(compress1(a.limbs + const(k, a.limbs) - b.limbs), out)


def fp_neg(a: LFp) -> LFp:
    k = _k_for(a.bound)
    return LFp(compress1(const(k, a.limbs) - a.limbs), float(k))


def fp_dbl(a: LFp) -> LFp:
    return fp_add(a, a)


def fp_select(mask: torch.Tensor, a: LFp, b: LFp) -> LFp:
    """mask over the batch shape: a where mask else b (bound = max)."""
    return LFp(torch.where(mask[None], a.limbs, b.limbs), max(a.bound, b.bound))


def relabel(a: LFp, bound: float) -> LFp:
    """Weaken the bound label (bound may only increase)."""
    assert bound >= a.bound
    return LFp(a.limbs, bound)


# ---------------------------------------------------------------------------
# Multiplication
# ---------------------------------------------------------------------------


def mont_mul(a: LFp, b: LFp) -> LFp:
    """Montgomery product a*b*R^-1 mod P (strict limbs out), one launch of
    kernel 1 on the flattened batch, or of kernel 7 under the MXU arm."""
    from . import mont_kernel, mxu_kernel

    prod = a.bound * b.bound
    assert prod <= MAX_MUL_PRODUCT, (
        f"mont_mul input bound product {prod} > {MAX_MUL_PRODUCT}; "
        "insert fp_reduce on an operand"
    )
    batch = a.limbs.shape[1:]
    kernel = mxu_kernel.mont_mul_mxu if mxu_active() else mont_kernel.mont_mul
    flat = kernel(
        a.limbs.reshape(N, -1).contiguous(), b.limbs.reshape(N, -1).contiguous()
    )
    return LFp(flat.reshape((N,) + batch), prod / MONT_DIVISOR + MONT_EPS)


def mont_sqr(a: LFp) -> LFp:
    return mont_mul(a, a)


def fp_reduce(x: LFp) -> LFp:
    """Value-preserving (mod P) reduction, output bound pinned to
    REDUCE_PIN so loop carries keep a stable static bound."""
    out = mont_mul(x, one_like(x))
    assert out.bound <= REDUCE_PIN
    return LFp(out.limbs, REDUCE_PIN)


def guard_le(x: LFp, m: float) -> LFp:
    """Reduce x iff its bound exceeds m (a static decision)."""
    return fp_reduce(x) if x.bound > m else x


def fp_canon(x: LFp) -> torch.Tensor:
    """Canonical raw limbs (strict, value < P) for equality/serialization."""
    if x.bound > 2.0:
        x = fp_reduce(x)
    limbs = x.limbs
    d, borrow = sub_chain(limbs, const("P", limbs).expand_as(limbs))
    return torch.where(~borrow[None], d, limbs)


def fp_eq(a: LFp, b: LFp) -> torch.Tensor:
    return torch.all(fp_canon(a) == fp_canon(b), dim=0)


def fp_is_zero(a: LFp) -> torch.Tensor:
    return torch.all(fp_canon(a) == 0, dim=0)


# ---------------------------------------------------------------------------
# Arm gates (jax_backend/fp.py:409-467): opt-in, off by default as in the
# reference.  The reference also requires a TPU backend; here the gate means
# "route through the chain and scalar-mul kernels' code", which launches the
# kernels on CUDA tensors and runs their plain versions on CPU tensors.
# ---------------------------------------------------------------------------

_CHAINS_MODE: bool | None = None
_WSM_MODE: bool | None = None
# pinned_arm's (chains, wsm, mxu) on the thread that holds it: it beats every
# process-wide setting there and is invisible to every other thread
_PIN = threading.local()


def _pin():
    return getattr(_PIN, "arm", None)


def chains_enabled() -> bool:
    """LIGHTHOUSE_TPU_CHAINS=1 routes static-exponent chains (fp_pow, so
    fp_inv, and h2c.fp2_pow_static) through kernels 4 and 5."""
    global _CHAINS_MODE
    pin = _pin()
    if pin is not None:
        return pin[0]
    if _CHAINS_MODE is None:
        _CHAINS_MODE = os.environ.get("LIGHTHOUSE_TPU_CHAINS", "") == "1"
    return _CHAINS_MODE


def set_chains(enabled: bool) -> None:
    """In-process toggle of the chain arm."""
    global _CHAINS_MODE
    _CHAINS_MODE = enabled


def chains_active() -> bool:
    """The one gate for chain-kernel routing."""
    return chains_enabled()


def wsm_enabled() -> bool:
    """LIGHTHOUSE_TPU_WSM=1 runs the 64-bit weight scalar muls as one fused
    double-and-add step kernel per bit per curve (kernel 6)."""
    global _WSM_MODE
    pin = _pin()
    if pin is not None:
        return pin[1]
    if _WSM_MODE is None:
        _WSM_MODE = os.environ.get("LIGHTHOUSE_TPU_WSM", "") == "1"
    return _WSM_MODE


def set_wsm(enabled: bool) -> None:
    """In-process toggle of the fused scalar-mul arm."""
    global _WSM_MODE
    _WSM_MODE = enabled


def wsm_fused_active() -> bool:
    """The one gate for the fused scalar-mul step kernels."""
    return wsm_enabled()


# The MXU arm (jax_backend/fp.py:501-584): every Montgomery product -- the
# standalone product, both chains and the Miller steps -- on the 13-bit
# plane (kernel 7 and the MXU variants of kernels 2-5).  The WSM steps stay
# on the 15-bit core, as in the reference.

_MXU_MODE: bool | None = None
_MXU_PLAN: dict | None = None


def mxu_enabled() -> bool:
    """Whether the Montgomery products run on the 13-bit plane.  Precedence:
    this thread's ``pinned_arm`` > the ``set_mxu`` override > the
    LIGHTHOUSE_TPU_MXU env flag (read live, never latched, so a plan
    installed later is not shadowed) > the installed plan's ``"*"`` default
    > off."""
    pin = _pin()
    if pin is not None:
        return pin[2]
    if _MXU_MODE is not None:
        return _MXU_MODE
    env = os.environ.get("LIGHTHOUSE_TPU_MXU")
    if env is not None:
        return env == "1"
    if _MXU_PLAN is not None:
        default = _MXU_PLAN.get("*")
        if default is not None:
            return bool(default)
    return False


def set_mxu(enabled: bool | None) -> bool | None:
    """In-process override; beats the env flag and any plan.  ``None``
    clears it.  Returns the previous override, to restore it exactly."""
    global _MXU_MODE
    prev = _MXU_MODE
    _MXU_MODE = None if enabled is None else bool(enabled)
    return prev


def install_mxu_plan(shapes: dict | None) -> None:
    """Install a per-shape arm plan: padded batch size -> MXU on/off, plus an
    optional ``"*"`` default for other shapes.  ``None`` clears it."""
    global _MXU_PLAN
    _MXU_PLAN = dict(shapes) if shapes else None


def mxu_planned(batch) -> bool | None:
    """The plan's arm for padded batch ``batch``; ``None`` when no plan
    binds it or an override (this thread's pin, set_mxu or the env flag)
    forces one arm for every shape."""
    if (_pin() is not None or _MXU_MODE is not None
            or os.environ.get("LIGHTHOUSE_TPU_MXU") is not None):
        return None
    if _MXU_PLAN is None:
        return None
    routed = _MXU_PLAN.get(batch)
    if routed is None:
        routed = _MXU_PLAN.get("*")
    return None if routed is None else bool(routed)


def mxu_for_batch(batch) -> bool:
    """The arm a verify of padded batch ``batch`` runs under: the planned
    arm where a plan binds, the process-wide gate otherwise."""
    planned = mxu_planned(batch)
    return mxu_enabled() if planned is None else planned


def mxu_active() -> bool:
    """The one gate for routing products to the 13-bit plane."""
    return mxu_enabled()


@contextlib.contextmanager
def pinned_arm(chains: bool, wsm: bool, mxu: bool):
    """Hold the three gates at one arm inside the block, on the calling
    thread only (a program run, traced or captured there is that arm's); the
    process-wide settings are never touched, so another thread dispatching
    meanwhile (a pod shard, the serve pump) keeps its own arm.  Blocks nest;
    the previous pin is restored exactly."""
    prev = _pin()
    _PIN.arm = (bool(chains), bool(wsm), bool(mxu))
    try:
        yield
    finally:
        _PIN.arm = prev


# The fixpoint bound of a pow carry: 4.3 * 4.3 = 18.5 <= 2000 and
# 18.5 / 625 + 1.1 < 4.3, so the label closes under square and multiply.
POW_FIX = MAX_MUL_PRODUCT / MONT_DIVISOR + MONT_EPS


def fp_pow(a: LFp, e: int) -> LFp:
    """a^e for a static exponent.  Under the chain arm (e > 3) the whole
    chain is one launch of kernel 4 (chain_kernel.pow_chain).  Otherwise
    square-and-multiply MSB first: the JAX package scans over the bits and
    selects; the bits are host constants, so here the multiply runs only
    where the bit is set — the same limbs as the select would keep."""
    assert e >= 0
    if e == 0:
        return one_like(a)
    if a.bound > 4.0:
        a = fp_reduce(a)
    if e > 3 and chains_active():
        from . import chain_kernel

        batch = a.limbs.shape[1:]
        flat = chain_kernel.pow_chain(a.limbs.reshape(N, -1).contiguous(), e)
        return LFp(flat.reshape((N,) + batch), POW_FIX)
    acc = relabel(one_like(a), POW_FIX)
    for bit in bin(e)[2:]:
        acc = mont_sqr(acc)
        if bit == "1":
            acc = mont_mul(acc, a)
        acc = relabel(acc, POW_FIX)
    return acc


def fp_inv(a: LFp) -> LFp:
    """Inverse by Fermat: a^(P-2).  a == 0 maps to 0."""
    return fp_pow(a, P_INT - 2)


# ---------------------------------------------------------------------------
# Host codecs (Montgomery domain)
# ---------------------------------------------------------------------------


def encode_mont(xs) -> np.ndarray:
    """ints (standard domain) -> (N, B) canonical Montgomery limbs."""
    return ints_to_limbs([x * R_INT % P_INT for x in xs])


def lfp_encode(xs, device) -> LFp:
    return LFp(upload(torch.as_tensor(encode_mont(xs)), device), 1.0)


def decode_mont(x) -> list[int]:
    """LFp or raw limb tensor (any lazy form) -> standard-domain ints."""
    limbs = x.limbs if isinstance(x, LFp) else x
    rinv = pow(R_INT, -1, P_INT)
    return [v * rinv % P_INT for v in limbs_to_ints(limbs)]
