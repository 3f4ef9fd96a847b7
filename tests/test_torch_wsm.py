"""Kernel 6, the fused weight-scalar-mul step (torch_backend/wsm_kernel.py).

Fast tier:
* the 64-bit fused driver (plain versions) against the port's
  ``points.scalar_mul_bits`` by canonical value, flags included, and
  against the oracle's ``affine_mul``, with infinity-base lanes;
* the recorded step programs (products, squares, flag outputs);
* ``csrc/wsm_step.cu`` compiled for the host with g++: each curve's form
  (G2 the group form, G1 the cooperative form; wsm_kernel.FORMS) lane by
  lane against the plain versions, the ranks of every phase run upwards
  and downwards, on random reduced planes and on live points (its text is
  held to codegen's by
  tests/test_torch_miller.py::test_generated_sources_are_committed_text);
* the cooperative schedule (codegen.coop_schedule) walked over a model of
  the arrays, and its packed table codes decoded back to the program's ops.

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
from lighthouse_tpu_torch.crypto.bls.torch_backend import _build, codegen  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import miller_kernel as ML  # noqa: E402
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


def _kernel_name(nc) -> str:
    """The kernel of a curve's form (its launcher without ``lh_``)."""
    return W.launcher(nc)[3:] + "_kernel"


_HARNESS = "".join(f"""
extern "C" void host_g{nc}(const uint32_t* acc, const uint32_t* ia, const uint32_t* base,
                          const uint32_t* ib, const uint32_t* bit, uint32_t* ao, uint32_t* io,
                          int n, int down) {{
  lh::host_ranks_down = down;
  EACH_LANE({_kernel_name(nc)}(acc, ia, base, ib, bit, ao, io, n))
}}
""" for nc in (1, 2))


@pytest.fixture(scope="module")
def host_wsm(tmp_path_factory):
    return host_cuda.build(tmp_path_factory.mktemp("hostwsm"), "wsm_step", _HARNESS)


@pytest.mark.parametrize("corpus", ["random", "live"])
@pytest.mark.parametrize("nc", [1, 2])
def test_host_compiled_wsm_step_matches_plain(host_wsm, nc, corpus):
    """Each curve's form at 1 lane and at 33 (G + 1 and past a block of 32
    lanes), its ranks run upwards and downwards in every phase, gives the
    plain version's bytes: on random reduced planes with random flags, and
    on live points where every flag state occurs."""
    n = 33
    if corpus == "random":
        rng = random.Random(30 + nc)
        operands = (_planes(rng, 3 * nc, n), _flags(rng, n), _planes(rng, 2 * nc, n),
                    _flags(rng, n), _flags(rng, n))
    else:
        operands = _live_step_inputs(nc, n, seed=50 + nc)
    plain = W.wsm_step_g1_plain if nc == 1 else W.wsm_step_g2_plain
    ptr = host_cuda.ptr
    for w in (1, n):
        args = tuple(x[..., :w].contiguous() for x in operands)
        ra, ri = plain(*args)
        for down in (0, 1):
            ao, io = torch.empty_like(args[0]), torch.empty_like(args[1])
            getattr(host_wsm, f"host_g{nc}")(*map(ptr, args), ptr(ao), ptr(io), w, down)
            assert torch.equal(ao, ra) and torch.equal(io, ri), (w, down)


def test_forms_are_the_printed_kernels():
    """wsm_kernel.FORMS names what codegen prints: G2's group form at its G
    in blocks of 32 lanes, G1's cooperative form in the shape of the
    printed constants; the launchers the wrapper binds are in the source."""
    src = (_build.CSRC / "wsm_step.cu").read_text()
    assert W.FORMS[2][0] == "group" and W.FORMS[2][2] == 32
    assert W.FORMS[1] == ("coop", codegen.COOP_RANKS, codegen.COOP_LANES)
    assert f"constexpr int kCoopLanes = {codegen.COOP_LANES};" in src
    for nc in (1, 2):
        assert f'extern "C" int {W.launcher(nc)}(' in src


def _walk_coop(prog, sched):
    """Walk the cooperative phases over a model of the arrays: a product
    reads its operands in stage 0 and writes its output in stage 4, a
    linear op reads and writes in its phase.  Every operand must still sit
    in its array when it is read, and no phase may write an array that it
    reads or that another op of the phase writes.  Returns the limb ops in
    the order they complete."""
    held = {}  # array -> value id
    for op in prog.ops:
        if op.kind == "in":
            held[sched.slot[op.out]] = op.out
    order = [op.out for op in prog.ops if op.kind == "in"]
    assert sched.phases[0] == (None, None, ())
    pending = None
    for vid, stage, lin in sched.phases[1:]:
        reads, writes = [], []
        if vid is not None:
            op = prog.ops[vid]
            if stage == 0:
                assert pending is None, "a product starts before the last one ends"
                pending = vid
                reads += list(op.ins)
            else:
                assert pending == vid
            if stage == codegen.COOP_STAGES - 1:
                writes.append(vid)
                pending = None
        for v in lin:
            reads += [i for i in prog.ops[v].ins if prog.ops[i].kind not in ML.FLAGS]
            writes.append(v)
        ws = [sched.slot[v] for v in writes]
        assert len(ws) == len(set(ws)), "two ops of one phase write one array"
        assert not {sched.slot[i] for i in reads} & set(ws), "a phase writes an array it reads"
        for i in reads:
            assert held.get(sched.slot[i]) == i, "an operand was overwritten"
        for v in writes:
            held[sched.slot[v]] = v
        order += writes
    assert pending is None
    return order


@pytest.mark.parametrize("nc", [1, 2])
def test_coop_schedule_never_overwrites_a_live_slot(nc):
    """The cooperative schedule of each step program (G1 ships in it; G2's
    was timed): each limb op runs once, after its operands; products one
    at a time, in five consecutive phases; phases without a product only
    for the outputs' tails; the arrays fit one block's shared memory."""
    prog = W.program(nc)
    sched = codegen.coop_schedule(prog)
    order = _walk_coop(prog, sched)
    assert sorted(order) == [op.out for op in prog.ops if op.kind not in ML.FLAGS]
    products = prog.n_mul + prog.n_sqr
    assert sum(1 for vid, stage, _ in sched.phases if stage == 0) == products
    last = max(p for p, (vid, _, _) in enumerate(sched.phases) if vid is not None)
    assert last == codegen.COOP_STAGES * products
    assert codegen.coop_shared_bytes(sched.n_slots) <= codegen.SHARED_LIMIT


@pytest.mark.parametrize("nc", [1, 2])
def test_coop_codes_round_trip(nc):
    """Every packed word of the cooperative table decodes to what the
    schedule put there: the product's stage (the square's triangle for a
    sqr) and arrays; each linear op's kind, arrays, bias row (k up to 64
    for G1 and 128 for G2: three bits) or flag bit; each output's store
    with its plane."""
    prog = W.program(nc)
    sched = codegen.coop_schedule(prog)
    rows, width = codegen._coop_rows(prog, sched)
    flags = [op.out for op in prog.ops if op.kind in ML.FLAGS]
    planes = {vid: plane for _, plane, vid in prog.outputs}

    def unpack(w):
        return w & 7, w >> 3 & 7, w >> 8 & 255, w >> 16 & 255, w >> 24

    slot = sched.slot
    ks = set()
    for row, (vid, stage, lin) in zip(rows, sched.phases[1:]):
        assert len(row) == width + 1
        code, q, o, a, b = unpack(row[0])
        if vid is None:
            assert row[0] == 0
        else:
            op = prog.ops[vid]
            want = ("sqr" if op.kind == "sqr" else "t") if stage == 0 \
                else codegen.COOP_STAGE[stage + 2]
            assert codegen.COOP_STAGE[code] == want
            assert (o, a, b) == (slot[vid], slot[op.ins[0]], slot[op.ins[-1]])
        words = [w for w in row[1:] if w]
        for v in lin:
            op = prog.ops[v]
            code, q, o, a, b = unpack(words.pop(0))
            assert codegen.COOP_LIN[code] == op.kind and o == slot[v]
            limbs = [i for i in op.ins if prog.ops[i].kind not in ML.FLAGS]
            assert [a, b][:len(limbs)] == [slot[i] for i in limbs]
            if op.kind in ("sub", "neg"):
                assert F.BIAS_KS[q] == op.arg
                ks.add(op.arg)
            elif op.kind == "sel":
                assert flags[q] == op.ins[0]
            if v in planes:
                code, q, o, a, b = unpack(words.pop(0))
                assert (codegen.COOP_LIN[code], o, a) == ("store", slot[v], planes[v])
        assert not words
    assert max(ks) == {1: 64, 2: 128}[nc]


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
