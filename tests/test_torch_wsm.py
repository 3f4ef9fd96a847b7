"""Kernel 6, the fused weight-scalar-mul step (torch_backend/wsm_kernel.py).

Fast tier:
* the 64-bit fused driver (plain versions) against the port's
  ``points.scalar_mul_bits`` by canonical value, flags included, and
  against the oracle's ``affine_mul``, with infinity-base lanes;
* the recorded step programs (products, squares, flag outputs);
* ``csrc/wsm_step.cu`` compiled for the host with g++, lane by lane against
  the plain versions (its text is held to codegen's by
  tests/test_torch_miller.py::test_generated_sources_are_committed_text).

Slow tier: the plain step programs byte for byte against the reference's
own Pallas step kernel (``pallas_wsm._step_call``) in interpret mode, one
G1 and one G2 step on 128 lanes.
"""

import random

import numpy as np
import pytest
import torch
import torch_host_cuda as host_cuda

# The plain versions run many small ops: one intra-op thread per process, so
# test processes side by side (pytest-xdist) do not oversubscribe the cores.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lighthouse_tpu_torch.crypto.bls import params  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.curve import (  # noqa: E402
    G1_GENERATOR, G2_GENERATOR, Fp, Fp2, affine_mul)
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import points as P  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import tower as T  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import wsm_kernel as W  # noqa: E402

CURVES = {
    "g1": (P.FP_OPS, G1_GENERATOR, Fp, P.g1_encode),
    "g2": (P.FP2_OPS, G2_GENERATOR, Fp2, P.g2_encode),
}


def _bits(ks, nbits) -> torch.Tensor:
    """(nbits, B) int32 MSB-first bits of the scalars ks."""
    return torch.tensor([[int(c) for c in bin(k)[2:].zfill(nbits)] for k in ks],
                        dtype=torch.int32).T.contiguous()


def _canon(ops, pt) -> tuple:
    """Canonical ints of every coordinate lane, and the flags."""
    coords = [F.limbs_to_ints(F.fp_canon(lane)) for c in pt[:3] for lane in ops.lanes(c)]
    return coords, pt[3].tolist()


def _affine(ops, fld, pt) -> list:
    """Jacobian -> oracle affine points (None under the flag)."""
    def ints(c):
        vals = [F.decode_mont(lane) for lane in ops.lanes(c)]
        return [fld(*v) if fld is Fp2 else fld(v[0]) for v in zip(*vals)]

    out = []
    for X, Y, Z, inf in zip(ints(pt[0]), ints(pt[1]), ints(pt[2]), pt[3].tolist()):
        zi = Z.inv()
        out.append(None if inf else (X * zi * zi, Y * zi * zi * zi))
    return out


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_fused_driver_matches_scalar_mul_bits(curve):
    """64-bit weights (edge and random) on B=4 lanes, one with its base at
    infinity: the fused driver's coordinates and flags equal the port's
    scalar_mul_bits (run with the same base flags) by canonical value, and
    its finite lanes equal the oracle's [k]P."""
    ops, gen, fld, encode = CURVES[curve]
    rng = random.Random(curve)
    pts = [affine_mul(gen, rng.randrange(1, params.R), fld) for _ in range(4)]
    ks = [1, 2, rng.randrange(1, 2**64), 2**63 + 5]
    inf = torch.tensor([False, True, False, False])
    aff = encode(pts, "cpu")
    fused = W.scalar_mul_bits_fused(ops, aff, inf, _bits(ks, 64))
    base = P.from_affine(ops, aff)[:3] + (inf,)
    ref = P.scalar_mul_bits(ops, base, _bits(ks, 64))
    assert _canon(ops, fused) == _canon(ops, ref)
    assert fused[3].tolist() == inf.tolist()
    want = [None if i else affine_mul(p, k, fld) for p, k, i in zip(pts, ks, inf.tolist())]
    assert _affine(ops, fld, fused) == want


def test_step_programs_record_the_reference_formulas():
    """G1 squares with the triangle square (pallas_miller.ksqr); G2's
    k2_sqr uses products only.  Each program writes 3 x ncoords limb planes
    and one flag plane, and every limb output is reduced."""
    counts = {nc: (W.program(nc).n_mul, W.program(nc).n_sqr) for nc in (1, 2)}
    assert counts == {1: (17, 8), 2: (68, 0)}
    for nc in (1, 2):
        prog = W.program(nc)
        assert [(b, p) for b, p, _ in prog.outputs] == (
            [("acc_out", i) for i in range(3 * nc)] + [("inf_out", 0)])
        assert {op.kind for op in prog.ops} <= {
            "in", "one", "zero", "add", "sub", "neg", "mul", "sqr", "sel", "flag", "and",
            "fsel"}


def _planes(rng, planes, n, k=2) -> torch.Tensor:
    return torch.stack([torch.as_tensor(F.ints_to_limbs(
        [rng.randrange(k * F.P_INT) for _ in range(n)])) for _ in range(planes)])


def _flags(rng, n) -> torch.Tensor:
    return torch.tensor([[rng.randrange(2) for _ in range(n)]], dtype=torch.int32)


_HARNESS = r"""
#define HOST_STEP(g)                                                             \
  extern "C" void host_##g(const uint32_t* acc, const uint32_t* ia, const uint32_t* base, \
                           const uint32_t* ib, const uint32_t* bit, uint32_t* ao,          \
                           uint32_t* io, int n) {                                          \
    EACH_LANE(wsm_step_##g##_kernel(acc, ia, base, ib, bit, ao, io, n))                    \
  }
HOST_STEP(g1)
HOST_STEP(g2)
"""


@pytest.fixture(scope="module")
def host_wsm(tmp_path_factory):
    return host_cuda.build(tmp_path_factory.mktemp("hostwsm"), "wsm_step", _HARNESS)


@pytest.mark.parametrize("nc", [1, 2])
def test_host_compiled_wsm_step_matches_plain(host_wsm, nc):
    rng = random.Random(30 + nc)
    n = 9
    acc, base = _planes(rng, 3 * nc, n), _planes(rng, 2 * nc, n)
    ia, ib, bit = _flags(rng, n), _flags(rng, n), _flags(rng, n)
    ao, io = torch.empty_like(acc), torch.empty_like(ia)
    ptr = host_cuda.ptr
    getattr(host_wsm, f"host_g{nc}")(ptr(acc), ptr(ia), ptr(base), ptr(ib), ptr(bit), ptr(ao),
                                     ptr(io), n)
    plain = W.wsm_step_g1_plain if nc == 1 else W.wsm_step_g2_plain
    ra, ri = plain(acc, ia, base, ib, bit)
    assert torch.equal(ao, ra) and torch.equal(io, ri)


def test_wsm_wrappers_check_operands():
    z = torch.zeros((6, F.N, 3), dtype=torch.int32)
    f = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        W.wsm_step_g1(z, f, z[:2].clone(), f, f)
    with pytest.raises(ValueError):
        W.wsm_step_g2(z, f, z[:4].clone(), f, torch.zeros((3,), dtype=torch.int32))
    with pytest.raises(TypeError):
        W.wsm_step_g2(z.long(), f, z[:4].clone(), f, f)


def _live_step_inputs(nc, n, seed):
    """Live points for one step: the acc a Jacobian multiple of the
    generator with a random Z, the base an affine multiple; random bits and
    infinity flags on either side (so every flag state occurs)."""
    rng = random.Random(seed)
    ops, gen, fld, encode = CURVES[f"g{nc}"]
    accs, bases = [], []
    for _ in range(n):
        x, y = affine_mul(gen, rng.randrange(1, params.R), fld)
        z = fld(rng.randrange(1, F.P_INT), rng.randrange(F.P_INT)) if nc == 2 \
            else fld(rng.randrange(1, F.P_INT))
        accs.append((x * z * z, y * z * z * z, z))
        bases.append(affine_mul(gen, rng.randrange(1, params.R), fld))
    if nc == 1:
        acc = [F.lfp_encode([a[i].v for a in accs], "cpu").limbs for i in range(3)]
    else:
        acc = [c.limbs for i in range(3) for c in T.fp2_encode([a[i] for a in accs], "cpu")]
    base = [c.limbs for xy in encode(bases, "cpu") for c in ops.lanes(xy)]
    return (torch.stack(acc), _flags(rng, n), torch.stack(base), _flags(rng, n),
            _flags(rng, n))


@pytest.mark.slow
@pytest.mark.parametrize("nc", [1, 2])
def test_plain_step_matches_pallas_interpret(nc):
    from lighthouse_tpu.crypto.bls.jax_backend import pallas_miller as PM
    from lighthouse_tpu.crypto.bls.jax_backend import pallas_wsm as PW

    n = 128
    acc, ia, base, ib, bit = _live_step_inputs(nc, n, seed=40 + nc)

    def u32(x):
        return jnp.asarray(x.numpy().astype(np.uint32))

    outs = PW._step_call(nc, n, n, True)(
        *[u32(p) for p in acc], u32(ia), *[u32(p) for p in base], u32(ib), u32(bit),
        *PM._const_arrays(n))
    plain = W.wsm_step_g1_plain if nc == 1 else W.wsm_step_g2_plain
    ra, ri = plain(acc, ia, base, ib, bit)
    want = np.stack([np.asarray(o) for o in outs[:-1]]).astype(np.int64)
    np.testing.assert_array_equal(ra.numpy().astype(np.int64), want)
    np.testing.assert_array_equal(ri.numpy().astype(np.int64),
                                  np.asarray(outs[-1]).astype(np.int64))
