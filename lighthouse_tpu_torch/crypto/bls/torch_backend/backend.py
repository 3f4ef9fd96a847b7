"""The "torch" BLS backend: batched signature-set verification on the card.

Port of jax_backend/backend.py (JaxBackend and its device programs), the
twin of blst's ``verify_multiple_aggregate_signatures`` behind the reference
client's verify_signature_sets (crypto/bls/src/impls/blst.rs:35-117):

  host:   per-set validation (empty sets, infinity signatures/pubkeys),
          pubkey aggregation, hashing to Fp2 (or full hash-to-curve),
          nonzero 64-bit random weights, limb encoding  -> marshal_sets
  device: G2 subgroup checks, weight scalar muls, signature accumulation,
          batched Miller loops, GT product, one final exponentiation
          -> dispatch (enqueues on the current CUDA stream) / resolve
          (the one host sync, returns the verdict)

Written out, the device program is eager: every field op is a launch, every
Montgomery product one launch of kernel 1, every Miller step one launch of
kernel 2 or 3.  On the card it is captured once per program key into a
CUDA graph (program.py; the counterpart of ``JaxBackend._kernel`` and
``traced_jit``), and ``dispatch`` replays the graph; ``local_verify_fn``
gives the eager program.  The default arm is the TPU default: fused Miller
steps on, the opt-in chain, scalar-mul and MXU kernels off.  The chain-and-WSM
arm (``fp.set_chains(True)``, ``fp.set_wsm(True)`` or LIGHTHOUSE_TPU_CHAINS=1
/ LIGHTHOUSE_TPU_WSM=1) runs every static-exponent chain as one launch of
kernel 4 or 5 and each bit of the weight scalar muls as one launch of
kernel 6 per curve.  The MXU arm (``fp.set_mxu(True)``, LIGHTHOUSE_TPU_MXU=1
or an installed plan, ``fp.install_mxu_plan``) runs every Montgomery
product on the 13-bit plane: kernel 7 and the MXU variants of kernels 2-5,
the WSM steps staying on the 15-bit core as in the reference.

Warm boot (the counterpart of ``enable_compile_cache``, ``attach_aot_store``
and ``install_kernel``): ``enable_compile_cache`` keeps the kernels' nvcc
libraries in a directory that outlives the process; an attached AOT store
(aot.py) records each verify and aggregate key's operand skeleton when the
key is first built, and ``aot.prewarm`` builds those keys at the next boot
through ``install_program``, before the first batch.

Two more device programs, keyed and captured the same way:
``_aggregate_verify_kernel`` (``aggregate_verify``: distinct-message
aggregate verification, blst.rs:244-255, on n padded to a power of two) and
``_epoch_verify_kernel`` (``epoch_program``: committee pubkeys aggregated
on the device by ``_segment_aggregate_g1``, then the batch verify; the
mainnet-epoch attestation batch).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import secrets
import threading
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from .. import params
from ..curve import Fp, G1_GENERATOR, affine_neg, from_jacobian, jac_add, to_jacobian
from ..hash_to_curve import hash_to_field_fp2, hash_to_g2
from ....utils import faults
from ....utils.metrics import COMPILE_CACHE_ERRORS
from . import _build
from . import aot as AOT
from . import chain_kernel as CK
from . import fp as F
from . import miller_kernel as ML
from . import mont_kernel as MK
from . import mxu_kernel as X
from . import pairing as PR
from . import points as P
from . import program as PG
from . import tower as T
from . import wsm_kernel as W


log = logging.getLogger("lighthouse_tpu_torch.backend")


def enable_compile_cache(cache_dir: str) -> bool:
    """Build and load the kernels' nvcc libraries under ``cache_dir`` (made
    if missing), keyed there by ``_build.source_hash()``, so that a restart
    on the same sources starts no nvcc (jax_backend/backend.py:
    enable_compile_cache, which points JAX's compilation cache).  Call it
    before the first kernel loads: the loaded libraries are cached by name,
    so moving the root afterwards is refused.  Never raises: on any failure
    (the root cannot be made or written, or a library is loaded already) it
    returns False, counts ``compile_cache_errors_total`` and logs, and the
    libraries stay where they were."""
    try:
        _build.set_build_root(cache_dir)
        return True
    except Exception as exc:  # noqa: BLE001 — the cache is an optimization,
        # but a dead one re-pays every nvcc build on every boot: count it
        COMPILE_CACHE_ERRORS.inc()
        log.warning("persistent kernel build cache unavailable: cache_dir=%s error=%s",
                    cache_dir, exc)
        return False


# kernel name -> (module, its launch counter)
_COUNTERS = {
    "mont_mul": (MK, "launches"),
    "miller_step_dbl": (ML, "dbl_launches"),
    "miller_step_add": (ML, "add_launches"),
    "fp_chain": (CK, "fp_launches"),
    "fp2_chain": (CK, "fp2_launches"),
    "wsm_step_g1": (W, "g1_launches"),
    "wsm_step_g2": (W, "g2_launches"),
    "mont_mul_mxu": (X, "launches"),
    "miller_step_dbl_mxu": (ML, "dbl_mxu_launches"),
    "miller_step_add_mxu": (ML, "add_mxu_launches"),
    "fp_chain_mxu": (CK, "fp_mxu_launches"),
    "fp2_chain_mxu": (CK, "fp2_mxu_launches"),
}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel (the MXU variants
    under their own names)."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)


def _cat_lfp(x, y):
    """Concatenate two LFp trees along the batch axis."""
    if isinstance(x, F.LFp):
        return F.LFp(torch.cat([x.limbs, y.limbs], dim=-1), max(x.bound, y.bound))
    return tuple(_cat_lfp(a, b) for a, b in zip(x, y))


def _slice_pt(pt, a, b):
    def sl(x):
        if isinstance(x, F.LFp):
            return F.LFp(x.limbs[..., a:b], x.bound)
        if isinstance(x, torch.Tensor):
            return x[..., a:b]
        return tuple(sl(c) for c in x)

    return tuple(sl(c) for c in pt)


def _tree_reduce_g2(pt):
    """Sum a Jacobian G2 batch (X, Y, Z, inf) along the batch axis with the
    COMPLETE addition (the summands are adversarial), padded with infinity
    to a power of two."""
    B = pt[3].shape[-1]
    target = 1 << max(0, (B - 1).bit_length())
    if target != B:
        reps = target - B
        dev = pt[3].device
        one = F.LFp(F.bcast("ONE", (reps,), dev), 1.0)
        zero = F.LFp(torch.zeros((F.N, reps), dtype=F.DTYPE, device=dev), 0.0)
        X, Y, Z, inf = pt
        pt = (
            _cat_lfp(X, (one, zero)),
            _cat_lfp(Y, (one, zero)),
            _cat_lfp(Z, (zero, zero)),
            torch.cat([inf, torch.ones((reps,), dtype=torch.bool, device=dev)]),
        )
    n = target
    while n > 1:
        half = n // 2
        pt = P.jac_add(P.FP2_OPS, _slice_pt(pt, 0, half), _slice_pt(pt, half, 2 * half))
        n = half
    return pt


def _neg_gen_const(device):
    """-G1 generator as a batch-1 affine constant, uploaded once per device."""
    dev = str(torch.device(device))
    return tuple(F.LFp(F.int_col(c.v * F.R_INT % F.P_INT, dev), 1.0)
                 for c in affine_neg(G1_GENERATOR))


def _verify_kernel(pk_aff, sig_aff, h_aff, wbits):
    """The device program; every input has trailing batch axis B.

    pk_aff:  G1 affine (x, y), per-set aggregated pubkey
    sig_aff: G2 affine, per-set signature
    h_aff:   G2 affine, per-set message point H(m)
    wbits:   (64, B) int32, bits of the nonzero random weights, MSB first
    Returns a one-element bool tensor (not synchronised)."""
    # 1. signature subgroup checks (blst.rs:71-81)
    ok_sub = torch.all(P.g2_subgroup_check(sig_aff))
    # 2. weight scalar muls: under the WSM arm one kernel-6 launch per bit
    # per curve, with the bases passed affine (none is at infinity)
    if F.wsm_fused_active():
        no_inf = torch.zeros(wbits.shape[1:], dtype=torch.bool, device=wbits.device)
        wpk = W.scalar_mul_bits_fused(P.FP_OPS, pk_aff, no_inf, wbits)
        wsig = W.scalar_mul_bits_fused(P.FP2_OPS, sig_aff, no_inf, wbits)
    else:
        wpk = P.scalar_mul_bits(P.FP_OPS, P.from_affine(P.FP_OPS, pk_aff), wbits)
        wsig = P.scalar_mul_bits(P.FP2_OPS, P.from_affine(P.FP2_OPS, sig_aff), wbits)
    # 3. S = sum_i [r_i] sig_i
    S = _tree_reduce_g2(wsig)
    # 4. affinize
    wpk_aff = P.to_affine(P.FP_OPS, wpk, F.fp_inv)
    S_aff = P.to_affine(P.FP2_OPS, S, T.fp2_inv)
    # 5. pairs (wpk_i, H_i) for each set plus (-G1, S)
    neg_gen = _neg_gen_const(wbits.device)
    p_side = (_cat_lfp(wpk_aff[0], neg_gen[0]), _cat_lfp(wpk_aff[1], neg_gen[1]))
    q_side = (_cat_lfp(h_aff[0], S_aff[0]), _cat_lfp(h_aff[1], S_aff[1]))
    # 6. Miller loops, GT product, final exponentiation.  An infinite S
    # contributes e(P, O) = 1: mask its pair instead of trusting the
    # garbage affinization.
    f = PR.miller_loop(p_side, q_side)
    B = wbits.shape[-1]
    mask = torch.cat([torch.zeros((B,), dtype=torch.bool, device=wbits.device),
                      S[3].reshape(1)])
    f = T.fp12_select(mask, PR.fp12_one_like_from_fp2(q_side[0]), f)
    return PR.final_exp_is_one(PR.gt_product(f)) & ok_sub


def _verify_kernel_h2c(pk_aff, sig_aff, u0, u1, wbits):
    """_verify_kernel with the map to G2 on the device: takes the
    hash-to-field outputs (u0, u1 Fp2 batches) instead of H(m) points."""
    from . import h2c

    return _verify_kernel(pk_aff, sig_aff, h2c.map_to_g2(u0, u1), wbits)


def _segment_aggregate_g1(pk_aff, pad_inf, positions: int):
    """Sum each set's committee pubkeys on the device.

    Position-major layout: the trailing axis is positions * B, lane
    ``pos * B + set``, so each level of the halving tree adds two contiguous
    lane ranges with the complete ``jac_add`` (B lanes per position), log2
    (positions) levels in all.  ``pad_inf`` marks absent members (lanes of
    committees shorter than ``positions``): their lanes count as infinity,
    the identity of the sum.  ``positions`` must be a power of two: the
    reference halves with ``n // 2`` and so drops the last position of an
    odd level; here such a ``positions`` raises."""
    total = pad_inf.shape[-1]
    if positions < 1 or positions & (positions - 1) or total % positions:
        raise ValueError(f"positions must be a power of two dividing the {total} lanes, "
                         f"not {positions}")
    p = P.from_affine(P.FP_OPS, pk_aff)
    p = (p[0], p[1], p[2], p[3] | pad_inf)
    B = total // positions
    n = positions
    while n > 1:
        half = n // 2
        p = P.jac_add(P.FP_OPS, _slice_pt(p, 0, half * B), _slice_pt(p, half * B, n * B))
        n = half
    return p


def _epoch_verify_kernel(pk_aff, pad_inf, sig_aff, h_aff, wbits, positions: int):
    """The epoch batch program: committee aggregation on the device
    (``_segment_aggregate_g1``), affinized, feeding ``_verify_kernel``
    (host H(m) points, as in the reference)."""
    agg = _segment_aggregate_g1(pk_aff, pad_inf, positions)
    return _verify_kernel(P.to_affine(P.FP_OPS, agg, F.fp_inv), sig_aff, h_aff, wbits)


def encode_committee_pubkeys(committees: list, positions: int):
    """Host marshal of the epoch program's pubkey operand: committees
    (ragged lists of oracle affine G1 points) -> position-major affine (x,
    y) CPU tensors at lane ``pos * B + set`` and the (positions * B,) bool
    padding mask.  Padding lanes hold the generator (any valid point) under
    a True flag.  A committee longer than ``positions`` raises (the
    reference drops its members past ``positions``)."""
    B = len(committees)
    if any(len(c) > positions for c in committees):
        raise ValueError(f"a committee has more than {positions} members")
    flat = []
    mask = np.zeros(positions * B, dtype=bool)
    for pos in range(positions):
        for b, committee in enumerate(committees):
            if pos < len(committee):
                flat.append(committee[pos])
            else:
                flat.append(G1_GENERATOR)
                mask[pos * B + b] = True
    return P.g1_encode(flat, torch.device("cpu")), torch.as_tensor(mask)


def _aggregate_verify_kernel(pk_aff, h_aff, sig_aff, pad=None):
    """Distinct-message aggregate verification (blst.rs:244-255): one G2
    subgroup check on the signature, then prod_i e(pk_i, H(m_i)) *
    e(-G1, sig) == 1 with one final exponentiation; no weights.

    pk_aff, h_aff: G1 and G2 affine batches, one lane per message; sig_aff:
    the batch-1 G2 affine signature.  ``pad`` (bool, one per lane) marks
    padding lanes, whose Miller values are set to one: n messages run in
    the program of the next power of two."""
    ok_sub = torch.all(P.g2_subgroup_check(sig_aff))
    neg_gen = _neg_gen_const(sig_aff[0][0].limbs.device)
    p_side = (_cat_lfp(pk_aff[0], neg_gen[0]), _cat_lfp(pk_aff[1], neg_gen[1]))
    q_side = (_cat_lfp(h_aff[0], sig_aff[0]), _cat_lfp(h_aff[1], sig_aff[1]))
    f = PR.miller_loop(p_side, q_side)
    if pad is not None:
        mask = torch.cat([pad, torch.zeros((1,), dtype=torch.bool, device=pad.device)])
        f = T.fp12_select(mask, PR.fp12_one_like_from_fp2(q_side[0]), f)
    return PR.final_exp_is_one(PR.gt_product(f)) & ok_sub


def _pack_wbits(weights: list[int]) -> torch.Tensor:
    """(64, B) MSB-first weight bits, from two 32-bit halves."""
    w_hi = np.array([(w >> 32) & 0xFFFFFFFF for w in weights], dtype=np.uint32)
    w_lo = np.array([w & 0xFFFFFFFF for w in weights], dtype=np.uint32)
    shifts = np.arange(31, -1, -1, dtype=np.uint32)[:, None]
    hi_bits = (w_hi[None, :] >> shifts) & np.uint32(1)
    lo_bits = (w_lo[None, :] >> shifts) & np.uint32(1)
    return torch.as_tensor(np.concatenate([hi_bits, lo_bits], axis=0).astype(np.int32))


def _seat(device) -> torch.device:
    """``device`` with its index: a bare "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _to_device(x, device):
    if isinstance(x, F.LFp):
        return F.LFp(F.upload(x.limbs, device), x.bound)
    if isinstance(x, torch.Tensor):
        return F.upload(x, device)
    return tuple(_to_device(c, device) for c in x)


@dataclass
class MarshalledBatch:
    """Host-marshalled device operands for one padded batch.  ``args`` are
    the positional operands of the device program, as CPU tensors (the
    ingest engine's all-registry batch carries its pubkey operand gathered
    on the device); ``invalid`` means host validation already rejected the
    batch."""

    n: int  # real (unpadded) set count
    B: int  # padded batch size
    device_h2c: bool
    args: tuple = field(default=())
    invalid: bool = False
    # registry mode (ingest marshal_for_mesh): the (B,) int32 validator-slot
    # vector when the pubkey operand is deferred to a sharded program's
    # registry gather; args then exclude the pubkeys, and only a mesh path
    # may take the batch (``dispatch`` refuses it)
    slots: Any = None
    # a CUDA event recorded after the operands made on the device at marshal
    # time (the registry gather); dispatch's stream waits for it
    ready: Any = None


class TorchBackend:
    """Batch verification on a CUDA card (or, when asked, on the CPU
    through the kernels' plain versions)."""

    name = "torch"

    def __init__(self, device="cuda", min_batch: int = 8, device_h2c: bool = True):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchBackend: CUDA is not available; pass device='cpu' to run "
                "the plain PyTorch versions of the kernels")
        # with its index: a bare "cuda" names the card current now, and a
        # seat made current later (for_device, the pod's threads) must not
        # change which card this backend's programs live on
        self.device = _seat(device)
        self.min_batch = min_batch
        self.device_h2c = device_h2c
        # program key -> program (program.CapturedProgram on the card,
        # program.EagerProgram on the CPU); key -> build record (fingerprint,
        # build seconds, and on the card the warm-up, capture and instantiate
        # seconds, the launches counted at capture, the graph's nodes by
        # type, memory)
        self._programs = {}
        self.builds = {}
        self._pool = None  # the keys' shared graph memory pool, on the card
        self._lock = threading.Lock()  # makes each key's program once
        self._aot_store = None
        self._siblings = {}  # device -> the backend of that device (for_device)

    # -- the compiled programs: one per key (jax_backend/backend.py:_kernel) -

    def _program(self, B: int):
        """The batch-verify program for padded batch ``B`` under the arm in
        force, looked up or made.  Its key is (B, device_h2c, mxu, chains,
        wsm): every gate the program reads while it is traced, the mxu plane
        as ``fp.mxu_for_batch(B)`` resolves it, so flipping an arm never
        replays another arm's graph."""
        chains, wsm, mxu = self._arm(B)
        return self._program_for((B, self.device_h2c, mxu, chains, wsm))

    def _agg_program(self, n: int):
        """The aggregate-verify program for ``n`` lanes (a power of two),
        key ("agg", n, mxu, chains, wsm)."""
        chains, wsm, mxu = self._arm(n)
        return self._program_for(("agg", n, mxu, chains, wsm))

    @staticmethod
    def _spec(key: tuple):
        """(name, device program, arm, fingerprint attributes) of a verify
        key (B, device_h2c, mxu, chains, wsm) or an aggregate key ("agg", n,
        mxu, chains, wsm)."""
        if key[0] == "agg":
            _, n, mxu, chains, wsm = key
            return "_aggregate_verify_kernel", _aggregate_verify_kernel, (chains, wsm, mxu), {
                "n": n}
        B, device_h2c, mxu, chains, wsm = key
        fn = _verify_kernel_h2c if device_h2c else _verify_kernel
        return fn.__name__, fn, (chains, wsm, mxu), {"B": B, "device_h2c": device_h2c}

    def _program_for(self, key: tuple):
        name, fn, arm, attrs = self._spec(key)
        return self._keyed(key, name, fn, arm, **attrs)

    def fingerprint_for(self, key: tuple) -> str:
        """The fingerprint the program of a verify or aggregate key has in
        this process (``program.program_fingerprint``)."""
        name, _, arm, attrs = self._spec(tuple(key))
        return self._fingerprint(name, arm, attrs)

    def _fingerprint(self, name: str, arm: tuple, attrs: dict) -> str:
        chains, wsm, mxu = arm
        return PG.program_fingerprint(name, self.device, **attrs, mxu=mxu, chains=chains, wsm=wsm)

    def epoch_program(self, B: int, positions: int):
        """The epoch batch program for ``B`` sets of ``positions`` committee
        positions (a power of two), key ("epoch", B, positions, mxu, chains,
        wsm): called with the operands (pk_aff, pad_inf, sig_aff, h_aff,
        wbits) as CPU tensors, it returns the in-flight verdict
        (``resolve`` waits for it).  The counterpart of the reference's
        ``jax.jit(_epoch_verify_kernel, static_argnums=5)``, with
        ``positions`` bound into the program."""
        if positions < 1 or positions & (positions - 1):
            raise ValueError(f"positions must be a power of two, not {positions}")
        chains, wsm, mxu = arm = self._arm(B)
        fn = functools.partial(_epoch_verify_kernel, positions=positions)
        return self._keyed(("epoch", B, positions, mxu, chains, wsm), "_epoch_verify_kernel",
                           fn, arm, B=B, positions=positions)

    @staticmethod
    def _arm(batch: int) -> tuple:
        """(chains, wsm, mxu) in force for a program of ``batch`` lanes."""
        return F.chains_active(), F.wsm_fused_active(), F.mxu_for_batch(batch)

    def _keyed(self, key: tuple, name: str, fn, arm: tuple, **attrs):
        """The program under ``key``, looked up or made from ``fn`` (the
        eager device program, named ``name`` in its fingerprint with
        ``attrs`` and the arm).  On the card a ``program.CapturedProgram``
        (its first call captures it; a failed capture raises, nothing falls
        back to the eager program); on the CPU a ``program.EagerProgram``,
        the eager program with its arm pinned.  Either way the first build
        of a program of ``aot.AOT_KERNELS`` is recorded in the attached AOT
        store, if any."""
        with self._lock:
            prog = self._programs.get(key)
            if prog is not None:
                return prog
            rec = {"fingerprint": self._fingerprint(name, arm, attrs)}
            hook = self._aot_capture(key, name)
            if self.device.type == "cuda":
                if self._pool is None:
                    self._pool = PG.GraphPool(self.device)
                prog = PG.CapturedProgram(fn, key, arm, self._pool, rec, launch_counts,
                                          on_build=hook)
            else:
                prog = PG.EagerProgram(fn, key, arm, self.device, rec, on_build=hook)
            self._programs[key] = prog
            self.builds[key] = rec
        return prog

    # -- AOT program store seams (aot.py; jax_backend/backend.py:451-490) --

    def attach_aot_store(self, store) -> None:
        """Attach an ``aot.AotStore``: the first build of each verify and
        aggregate key records the key's operand skeleton in it (the
        counterpart of ``traced_jit``'s capture hook), so normal operation
        fills the store the next boot prewarms from.  The reference also
        looks in the store on a cache miss before it compiles
        (``_install_from_store``); here the store holds no program to load,
        only what a build needs, so a miss builds from the traffic's own
        operands, as without a store.  Keys are built ahead of traffic by
        ``aot.prewarm`` instead."""
        self._aot_store = store

    def _aot_capture(self, key, kernel: str):
        """The first-build hook bound to this key, or None when no store is
        attached or the program is not one of ``aot.AOT_KERNELS``."""
        store = self._aot_store
        if store is None or kernel not in AOT.AOT_KERNELS:
            return None

        def hook(prog, host_args):
            store.capture(prog, key, host_args, kernel=kernel)

        return hook

    def install_program(self, cache_key, fingerprint: str, skeleton) -> None:
        """Build the program of a verify or aggregate key now, from an
        operand skeleton (``aot.AotStore.load``'s tree): zeros of its shapes,
        dtypes and bounds on this backend's device, through the same path as
        traffic (on the card warm-up, capture, instantiate; no replay), and
        without recording it in the store again.  The counterpart of
        ``install_kernel``.  ``fingerprint`` must be the one the key's
        program has here (``fingerprint_for``), else ValueError; a build
        that fails raises."""
        key = tuple(cache_key)
        if self.fingerprint_for(key) != fingerprint:
            raise ValueError(f"program {key} has fingerprint {self.fingerprint_for(key)} "
                             f"here, not {fingerprint}")
        prog = self._program_for(key)
        if not prog.built:
            prog.build(AOT.operands(skeleton, self.device), capture=False)
            self.builds[key]["aot"] = True

    def warm_compile(self, B: int) -> bool:
        """Build the program for padded size ``B`` ahead of traffic (on the
        card: warm-up, capture, instantiate) from one probe set, marshalled
        once and tiled along the batch axis (every operand is batch-last),
        through the same ``_program`` path as traffic.  False for a size
        that is no padded batch size (below ``min_batch`` or not a power of
        two), as in the reference."""
        from ..api import SecretKey, SignatureSet

        if B < self.min_batch or B & (B - 1):
            return False
        sk = SecretKey(2)
        msg = b"lighthouse-tpu warm-compile probe"
        s = SignatureSet(sk.sign(msg), [sk.public_key()], msg)
        mb = self.marshal_sets([s], weights=[1])
        if mb.invalid:
            return False
        self._program(B)(*self.tile_batch(mb, B).args)
        return True

    @staticmethod
    def tile_batch(mb: MarshalledBatch, B: int) -> MarshalledBatch:
        """``mb`` as a batch of padded size ``B``, for a batch whose columns
        are copies of one set (a one-set marshal): its operands tiled along
        the batch axis (every operand is batch-last) when ``B`` is a
        multiple of ``mb.B``, cut to ``B`` columns when smaller (a seat's
        key below ``min_batch``)."""
        if B == mb.B:
            return mb
        if B < mb.B:
            args = PG.map_operands(lambda t, _: t[..., :B].contiguous(), mb.args)
        elif B % mb.B == 0:
            reps = B // mb.B
            args = PG.map_operands(lambda t, _: t.repeat(*([1] * (t.dim() - 1)), reps), mb.args)
        else:
            raise ValueError(f"cannot tile a batch of {mb.B} to {B}")
        return dataclasses.replace(mb, B=B, args=args)

    # -- seats of a mesh (parallel/): one backend per device -------------

    def for_device(self, device) -> "TorchBackend":
        """The backend whose programs run on ``device``: this one for its own
        device, else a sibling made once per device with the same
        ``min_batch`` and ``device_h2c`` and its own programs and graph pool
        (the counterpart of the reference placing one jitted program on any
        device).  Seats that repeat a device share its backend, and so one
        program per key."""
        device = _seat(device)
        if device == self.device:
            return self
        with self._lock:
            sib = self._siblings.get(device)
            if sib is None:
                sib = self._siblings[device] = TorchBackend(
                    device, min_batch=self.min_batch, device_h2c=self.device_h2c)
            return sib

    def seat_program(self, device, B: int):
        """The keyed batch-verify program a seat on ``device`` runs for its
        ``B`` columns (``for_device(device)._program(B)``, a CUDA graph on the
        card): the seam of ``parallel.partition.ShardedVerifyProgram``.  Its
        arm is the one for B, ``fp.mxu_for_batch(B)`` with B the seat's
        batch; the reference's sharded program traces its unpinned
        ``local_verify_fn`` under the global gate instead.  Both compute
        the same function."""
        return self.for_device(device)._program(B)

    def local_verify_fn(self):
        """The raw device program (``_verify_kernel_h2c`` or
        ``_verify_kernel``), run eagerly on operands already on the device:
        the graph's comparison on the card, and the seam for a sharded
        program (jax_backend/backend.py:local_verify_fn)."""
        return _verify_kernel_h2c if self.device_h2c else _verify_kernel

    # -- single-set conveniences over the batch path ----------------------

    def verify(self, pubkey, msg: bytes, sig) -> bool:
        from ..api import SignatureSet

        return self.verify_signature_sets([SignatureSet(sig, [pubkey], msg)])

    def fast_aggregate_verify(self, pubkeys, msg: bytes, sig) -> bool:
        from ..api import SignatureSet

        if not pubkeys:
            return False
        return self.verify_signature_sets([SignatureSet(sig, list(pubkeys), msg)])

    def aggregate_verify(self, pubkeys, msgs, sig) -> bool:
        """Distinct-message aggregate verification (blst.rs:244-255) on the
        device: ``marshal_aggregate``, then the program of the padded size."""
        marshalled = self.marshal_aggregate(pubkeys, msgs, sig)
        if marshalled is None:
            return False
        size, args = marshalled
        return self.resolve(self._agg_program(size)(*args))

    def marshal_aggregate(self, pubkeys, msgs, sig):
        """Host stage of ``aggregate_verify``: None where the reference
        refuses on the host (no pubkeys or a length mismatch, an infinity
        signature, an infinity key or hash), else (size, operands): the n
        pairs, each message hashed to G2, padded to the next power of two
        with repeats of pair 0 that the ``pad`` operand masks."""
        if not pubkeys or len(pubkeys) != len(msgs):
            return None
        if sig.point is None:
            return None
        h_pts = [hash_to_g2(m) for m in msgs]
        pk_pts = [pk.point for pk in pubkeys]
        if any(p is None for p in pk_pts) or any(h is None for h in h_pts):
            return None
        n = len(pk_pts)
        size = 1 << (n - 1).bit_length()
        reps = size - n
        host = torch.device("cpu")
        return size, (P.g1_encode(pk_pts + [pk_pts[0]] * reps, host),
                      P.g2_encode(h_pts + [h_pts[0]] * reps, host),
                      P.g2_encode([sig.point], host),
                      torch.arange(size) >= n)

    @staticmethod
    def registry_pk_wrap(x, y):
        """Canonical Montgomery limb planes gathered from a pubkey registry
        -> the program's pubkey operand (bound 1.0, as ``lfp_encode``'s)."""
        return (F.LFp(x, 1.0), F.LFp(y, 1.0))

    # -- the batch path: verify == resolve(dispatch(marshal_sets)) ---------

    def verify_signature_sets(self, sets) -> bool:
        # the chaos hook: device errors and hung devices are injected here,
        # before the marshal (a no-op unless armed)
        faults.fire("bls.device_verify")
        mb = self.marshal_sets(sets)
        if mb.invalid:
            return False
        return self.resolve(self.dispatch(mb))

    def marshal_sets(self, sets, weights=None) -> MarshalledBatch:
        """Host stage: validation, pubkey aggregation, hashing, limb encode,
        weight packing.  ``weights`` pins the per-set random weights (tests
        only); otherwise each is a fresh nonzero ``secrets.randbits(64)`` —
        predictable weights would break the soundness of the batch check."""
        if not sets:
            return MarshalledBatch(0, 0, self.device_h2c, invalid=True)
        n = len(sets)
        pk_pts, sig_pts, h_pts, ws = [], [], [], []
        for idx, s in enumerate(sets):
            if s.signature.point is None or not s.signing_keys:
                return MarshalledBatch(n, 0, self.device_h2c, invalid=True)
            if len(s.signing_keys) == 1:
                agg = s.signing_keys[0].point
            else:
                acc = to_jacobian(None, Fp)
                for pk in s.signing_keys:
                    acc = jac_add(acc, to_jacobian(pk.point, Fp), Fp)
                agg = from_jacobian(acc, Fp)
            if agg is None:
                return MarshalledBatch(n, 0, self.device_h2c, invalid=True)
            if not self.device_h2c:
                h = hash_to_g2(s.message)
                if h is None:
                    return MarshalledBatch(n, 0, self.device_h2c, invalid=True)
                h_pts.append(h)
            if weights is None:
                r = 0
                while r == 0:
                    r = secrets.randbits(params.RAND_BITS)
            else:
                r = int(weights[idx])
            pk_pts.append(agg)
            sig_pts.append(s.signature.point)
            ws.append(r)

        # Pad to the batch size by replicating entry 0: a valid duplicate
        # cannot flip the conjunction, an invalid one already fails it.
        B = self._padded_size(n)
        reps = B - n
        pk_pts += [pk_pts[0]] * reps
        sig_pts += [sig_pts[0]] * reps
        ws += [ws[0]] * reps
        host = torch.device("cpu")
        pk_aff = P.g1_encode(pk_pts, host)
        sig_aff = P.g2_encode(sig_pts, host)
        wbits = _pack_wbits(ws)
        if self.device_h2c:
            us = [hash_to_field_fp2(s.message, 2) for s in sets]
            us += [us[0]] * reps
            u0 = T.fp2_encode([u[0] for u in us], host)
            u1 = T.fp2_encode([u[1] for u in us], host)
            args = (pk_aff, sig_aff, u0, u1, wbits)
        else:
            h_pts += [h_pts[0]] * reps
            args = (pk_aff, sig_aff, P.g2_encode(h_pts, host), wbits)
        return MarshalledBatch(n, B, self.device_h2c, args)

    def dispatch(self, mb: MarshalledBatch):
        """Device stage: run the key's program on the batch and return the
        in-flight verdict tensor without waiting for it.  On the card that
        is the operands' copies into the graph's static inputs and one
        replay, enqueued on the current stream (``program.CapturedProgram``;
        the key's first dispatch builds it); on the CPU the eager program.
        The arm is resolved for the padded batch (``fp.mxu_for_batch``: this
        thread's ``fp.pinned_arm``, else an override, else the installed
        plan, else the gate) and held around the program on this thread only
        (jax_backend/backend.py:_pin_mxu).  A batch that carries registry
        ``slots`` (``IngestEngine.marshal_for_mesh``) lacks its pubkey
        operand and raises ``ValueError``: only a mesh path may take it."""
        if mb.slots is not None:
            raise ValueError("a MarshalledBatch with registry slots defers its pubkey "
                             "operand to a sharded program's gather; only the mesh "
                             "path may take it, not TorchBackend.dispatch")
        if mb.invalid:
            return False
        if mb.ready is not None:
            # operands gathered on the device, maybe on another stream: order
            # this stream after the gather, and keep their memory from being
            # reused on the gather's stream before this stream has read it
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(mb.ready)
            for t, _ in PG._leaves(mb.args):
                if t.device.type == "cuda":
                    t.record_stream(stream)
        return self._program(mb.B)(*mb.args)

    def resolve(self, handle) -> bool:
        """Wait for an in-flight dispatch and return the verdict."""
        return bool(handle)

    def verify_marshalled(self, mb: MarshalledBatch) -> bool:
        """The verdict of a marshalled batch (False for an invalid one); a
        batch with registry slots raises ``ValueError``, as in ``dispatch``."""
        return self.resolve(self.dispatch(mb))

    def _padded_size(self, n: int) -> int:
        """Next power-of-two batch size >= n."""
        B = self.min_batch
        while B < n:
            B *= 2
        return B


def register() -> TorchBackend:
    """Create the backend on the card and register it as "torch"."""
    from .. import api

    backend = TorchBackend()
    api.register_backend(backend)
    return backend
