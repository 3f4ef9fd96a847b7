"""The fused Miller steps (torch_backend/miller_kernel.py, kernels 2 and 3).

* The plain dbl and add steps against the JAX package's XLA halves
  (pairing._line_dbl + tower.fp12_sqr + fp12_mul_by_023; _line_add +
  fp12_mul_by_023 + select) on the same reduced inputs, by canonical value
  (the two paths reduce at different places, so only values must agree).
* The committed CUDA sources are exactly what codegen.py prints.
* The CUDA sources' arithmetic, compiled for the host with g++ and run lane
  by lane, gives the plain versions' limbs byte for byte.

The kernels themselves run against the plain versions on a card in
tests/test_torch_cuda.py (jax-free, so it runs where the card is).
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

from lighthouse_tpu.crypto.bls import params  # noqa: E402
from lighthouse_tpu.crypto.bls.curve import (  # noqa: E402
    Fp, Fp2, G1_GENERATOR, G2_GENERATOR, affine_mul)
from lighthouse_tpu.crypto.bls.jax_backend import fp as JF  # noqa: E402
from lighthouse_tpu.crypto.bls.jax_backend import pairing as JPR  # noqa: E402
from lighthouse_tpu.crypto.bls.jax_backend import points as JP  # noqa: E402
from lighthouse_tpu.crypto.bls.jax_backend import tower as JT  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import _build, codegen  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import miller_kernel as ML  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import mont_kernel as MK  # noqa: E402


def _planes(lfps) -> torch.Tensor:
    return torch.stack([torch.as_tensor(np.asarray(x.limbs).astype(np.int32)) for x in lfps])


def _canon_j(x) -> list:
    return JF.limbs_to_ints(np.asarray(JF.fp_canon(x)))


def _canon_t(limbs: torch.Tensor) -> list:
    return F.limbs_to_ints(F.fp_canon(F.LFp(limbs, 2.0)))


@pytest.fixture(scope="module")
def steps():
    """JAX XLA halves on B=2 real pairs: dbl from the loop's initial
    state, then add (both arms) on the live dbl output.  One jit of the
    whole sequence: eager JAX would compile every stacked shape apart."""
    rng = random.Random(0x5EED)
    pairs = [(affine_mul(G1_GENERATOR, rng.randrange(1, params.R), Fp),
              affine_mul(G2_GENERATOR, rng.randrange(1, params.R), Fp2)) for _ in range(2)]
    p_aff = JP.g1_encode([p for p, _ in pairs])
    q_aff = JP.g2_encode([q for _, q in pairs])

    def pin(c):
        return JF.relabel(JF.guard_le(c, 2.0), 2.0)

    def inputs(p_aff, q_aff):
        xp, yp = pin(p_aff[0]), pin(p_aff[1])
        q0 = (pin(q_aff[0][0]), pin(q_aff[0][1]))
        q1 = (pin(q_aff[1][0]), pin(q_aff[1][1]))
        one2 = tuple(JF.relabel(c, 2.0) for c in JT.fp2_one_like(q0))
        zero = JF.zero_like(xp)
        f = ((one2, (zero, zero), (zero, zero)), ((zero, zero),) * 3)
        return f, (q0, q1, one2), xp, yp

    @jax.jit
    def xla_halves(p_aff, q_aff):
        f, Tpt, xp, yp = inputs(p_aff, q_aff)
        line, T2 = JPR._line_dbl(Tpt, xp, yp)
        f_mid = JT.fp12_mul_by_023(JT.fp12_sqr(f), *line)
        line_a, T_add = JPR._line_add(T2, Tpt[:2], xp, yp)
        return f_mid, T2, JT.fp12_mul_by_023(f_mid, *line_a), T_add

    f, Tpt, xp, yp = inputs(p_aff, q_aff)
    q0, q1 = Tpt[:2]
    f_mid, T2, f_add, T_add = xla_halves(p_aff, q_aff)
    lanes = JT._fp12_lanes
    return {
        "in": {"f": _planes(lanes(f)), "t": _planes([c for pt in Tpt for c in pt]),
               "q": _planes([q0[0], q0[1], q1[0], q1[1]]),
               "xp": _planes([xp])[0], "yp": _planes([yp])[0]},
        "f_mid": [_canon_j(x) for x in lanes(f_mid)],
        "t_mid": [_canon_j(c) for pt in T2 for c in pt],
        "f_add": [_canon_j(x) for x in lanes(f_add)],
        "t_add": [_canon_j(c) for pt in T_add for c in pt],
    }


def test_plain_steps_match_jax_xla_halves(steps):
    x = steps["in"]
    f_mid, t_mid = ML.miller_step_dbl(x["f"], x["t"], x["xp"], x["yp"])
    assert [_canon_t(p) for p in f_mid] == steps["f_mid"]
    assert [_canon_t(p) for p in t_mid] == steps["t_mid"]
    n = x["xp"].shape[-1]
    for arm in (0, 1):
        bit = torch.full((n,), arm, dtype=torch.int32)
        f_out, t_out = ML.miller_step_add(f_mid, t_mid, x["q"], x["xp"], x["yp"], bit)
        want_f = steps["f_add"] if arm else [_canon_t(p) for p in f_mid]
        want_t = steps["t_add"] if arm else [_canon_t(p) for p in t_mid]
        assert [_canon_t(p) for p in f_out] == want_f
        assert [_canon_t(p) for p in t_out] == want_t


def test_add_step_selects_per_lane(steps):
    x = steps["in"]
    f_mid, t_mid = ML.miller_step_dbl(x["f"], x["t"], x["xp"], x["yp"])
    bit = torch.tensor([1, 0], dtype=torch.int32)
    f_out, t_out = ML.miller_step_add(f_mid, t_mid, x["q"], x["xp"], x["yp"], bit)
    assert [_canon_t(p)[0] for p in f_out] == [v[0] for v in steps["f_add"]]
    assert [_canon_t(p)[1] for p in f_out] == [_canon_t(p)[1] for p in f_mid]
    assert [_canon_t(p)[0] for p in t_out] == [v[0] for v in steps["t_add"]]


@pytest.mark.parametrize("step", ["dbl", "add"])
def test_programs_record_the_reference_bounds(step):
    prog = ML.program(step)
    assert prog.n_mul == {"dbl": 169, "add": 111}[step]
    assert len(prog.outputs) == 18
    kinds = {op.kind for op in prog.ops}
    assert kinds <= {"in", "bit", "one", "add", "sub", "neg", "mul", "sel"}
    ks = {op.arg for op in prog.ops if op.kind in ("sub", "neg")}
    assert ks <= set(F.BIAS_KS)


@pytest.mark.parametrize("name", sorted(codegen.generate_sources()))
def test_generated_sources_are_committed_text(name):
    assert (_build.CSRC / name).read_text() == codegen.generate_sources()[name]


def test_kfp_bound_asserts_fire_while_recording():
    ctx = ML._Recorder()
    big = ML.KFp(ctx.input("f", 0), 300.0)
    with pytest.raises(AssertionError):
        ML.kmul(ctx, big, big)
    with pytest.raises(AssertionError):
        ML.KFp(0, F.MAX_BOUND + 1)


_HARNESS = r"""
extern "C" void host_mont(const uint32_t* a, const uint32_t* b, uint32_t* o, int n) {
  EACH_LANE(mont_mul_kernel(a, b, o, n))
}
"""

_HARNESS_STEPS = r"""
extern "C" void host_dbl(const uint32_t* f, const uint32_t* t, const uint32_t* xp,
                         const uint32_t* yp, uint32_t* fo, uint32_t* to, int n) {
  EACH_LANE(miller_step_dbl_kernel(f, t, xp, yp, fo, to, n))
}
extern "C" void host_add(const uint32_t* f, const uint32_t* t, const uint32_t* q,
                         const uint32_t* xp, const uint32_t* yp, const int32_t* bit,
                         uint32_t* fo, uint32_t* to, int n) {
  EACH_LANE(miller_step_add_kernel(f, t, q, xp, yp, bit, fo, to, n))
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """csrc/mont.cu and csrc/miller_step.cu compiled for the host
    (torch_host_cuda), each kernel body run once per lane."""
    d = tmp_path_factory.mktemp("hostcuda")
    return {name: host_cuda.build(d, name, harness)
            for name, harness in (("mont", _HARNESS), ("miller_step", _HARNESS_STEPS))}


_ptr = host_cuda.ptr


def _rand_planes(rng, planes, n, k=2):
    return torch.stack([torch.as_tensor(F.ints_to_limbs(
        [rng.randrange(k * F.P_INT) for _ in range(n)])) for _ in range(planes)])


def test_host_compiled_mont_matches_plain(host_kernels):
    rng = random.Random(21)
    n = 33
    a = F.LFp(_rand_planes(rng, 1, n, 1)[0], 1.0)
    b = F.LFp(_rand_planes(rng, 1, n, 1)[0], 1.0)
    t = F.fp_sub(b, a)
    q = torch.full((F.N, n), F.QMAX, dtype=torch.int32)
    for x, y in ((a.limbs, b.limbs), (F.fp_add(a, a).limbs, t.limbs),
                 (t.limbs, F.fp_neg(t).limbs), (q, q)):
        x, y = x.contiguous(), y.contiguous()
        out = torch.empty_like(x)
        host_kernels["mont"].host_mont(_ptr(x), _ptr(y), _ptr(out), n)
        assert torch.equal(out, MK.mont_mul_plain(x, y))


def test_host_compiled_steps_match_plain(host_kernels):
    rng = random.Random(22)
    n = 9
    f, t, q = _rand_planes(rng, 12, n), _rand_planes(rng, 6, n), _rand_planes(rng, 4, n)
    xp, yp = _rand_planes(rng, 1, n)[0], _rand_planes(rng, 1, n)[0]
    bit = torch.tensor([rng.randrange(2) for _ in range(n)], dtype=torch.int32)
    fo, to = torch.empty_like(f), torch.empty_like(t)
    lib = host_kernels["miller_step"]
    lib.host_dbl(_ptr(f), _ptr(t), _ptr(xp), _ptr(yp), _ptr(fo), _ptr(to), n)
    rf, rt = ML.miller_step_dbl_plain(f, t, xp, yp)
    assert torch.equal(fo, rf) and torch.equal(to, rt)
    lib.host_add(_ptr(f), _ptr(t), _ptr(q), _ptr(xp), _ptr(yp), _ptr(bit), _ptr(fo), _ptr(to), n)
    rf, rt = ML.miller_step_add_plain(f, t, q, xp, yp, bit)
    assert torch.equal(fo, rf) and torch.equal(to, rt)


def test_step_wrappers_check_operands():
    z = torch.zeros((12, F.N, 3), dtype=torch.int32)
    t, p = z[:6].clone(), z[0].clone()
    with pytest.raises(ValueError):
        ML.miller_step_dbl(z, t[:5].clone(), p, p)
    with pytest.raises(TypeError):
        ML.miller_step_dbl(z.long(), t.long(), p.long(), p.long())
    with pytest.raises(ValueError):
        ML.miller_step_add(z, t, z[:4].clone(), p, p, torch.zeros(2, dtype=torch.int32))
