"""The fused Miller steps (torch_backend/miller_kernel.py, kernels 2 and 3).

* The plain dbl and add steps against the JAX package's XLA halves
  (pairing._line_dbl + tower.fp12_sqr + fp12_mul_by_023; _line_add +
  fp12_mul_by_023 + select) on the same reduced inputs, by canonical value
  (the two paths reduce at different places, so only values must agree).
* The committed CUDA sources are exactly what codegen.py prints.
* The CUDA sources' arithmetic, compiled for the host with g++ and run lane
  by lane, gives the plain versions' limbs byte for byte: kernel 1 in every
  form of MK.FORMS and kernels 2 and 3 in their group forms, each group's
  ranks run upwards and downwards
  within a phase (a rank that read another's write of the same phase would
  differ).
* The group schedules of kernels 2, 3 and kernel 6's G2 step hand every
  value to a slot that nothing overwrites before its last reader, and no
  phase writes a slot it reads.

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
from lighthouse_tpu_torch.crypto.bls.torch_backend import wsm_kernel as W  # noqa: E402


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
extern "C" void host_mont(const uint32_t* a, const uint32_t* b, uint32_t* o, int n, int group,
                          int lanes, int down) {
  lh::host_ranks_down = down;
  if (group == 16 && lanes == 8) {
    EACH_LANE((mont_mul_group_kernel<16, 8>(a, b, o, n)))
  } else if (group == 16 && lanes == 16) {
    EACH_LANE((mont_mul_group_kernel<16, 16>(a, b, o, n)))
  } else if (group == 4 && lanes == 32) {
    EACH_LANE((mont_mul_group_kernel<4, 32>(a, b, o, n)))
  } else {
    EACH_LANE(mont_mul_kernel(a, b, o, n))
  }
}
"""

_HARNESS_STEPS = r"""
extern "C" void host_dbl(const uint32_t* f, const uint32_t* t, const uint32_t* xp,
                         const uint32_t* yp, uint32_t* fo, uint32_t* to, int n, int down) {
  lh::host_ranks_down = down;
  EACH_LANE(miller_step_dbl_g16_kernel(f, t, xp, yp, fo, to, n))
}
extern "C" void host_add(const uint32_t* f, const uint32_t* t, const uint32_t* q,
                         const uint32_t* xp, const uint32_t* yp, const int32_t* bit,
                         uint32_t* fo, uint32_t* to, int n, int down) {
  lh::host_ranks_down = down;
  EACH_LANE(miller_step_add_g16_kernel(f, t, q, xp, yp, bit, fo, to, n))
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
    """Every form of kernel 1 on the strict, lazy and all-QMAX corpora: the
    one-thread form at 33 lanes, the group forms at 1, 3 and 9 lanes with
    their ranks run both ways."""
    rng = random.Random(21)
    n = 33
    a = F.LFp(_rand_planes(rng, 1, n, 1)[0], 1.0)
    b = F.LFp(_rand_planes(rng, 1, n, 1)[0], 1.0)
    t = F.fp_sub(b, a)
    q = torch.full((F.N, n), F.QMAX, dtype=torch.int32)
    runs = [((1, 128), n, 0)] + [(form, w, down) for form in MK.FORMS if form[0] > 1
                                 for w in (1, 3, 9) for down in (0, 1)]
    for x, y in ((a.limbs, b.limbs), (F.fp_add(a, a).limbs, t.limbs),
                 (t.limbs, F.fp_neg(t).limbs), (q, q)):
        for (group, lanes), w, down in runs:
            xw, yw = x[:, :w].contiguous(), y[:, :w].contiguous()
            out = torch.empty_like(xw)
            host_kernels["mont"].host_mont(_ptr(xw), _ptr(yw), _ptr(out), w, group, lanes, down)
            assert torch.equal(out, MK.mont_mul_plain(xw, yw)), (group, lanes, w, down)


def test_host_compiled_steps_match_plain(host_kernels):
    """The group forms of kernels 2 and 3 at 1 lane and at 17 (G + 1 for
    G = 16), random addition bits, ranks run both ways."""
    rng = random.Random(22)
    n = 1 + max(ML.DBL_GROUP, ML.ADD_GROUP)
    f, t, q = _rand_planes(rng, 12, n), _rand_planes(rng, 6, n), _rand_planes(rng, 4, n)
    xp, yp = _rand_planes(rng, 1, n)[0], _rand_planes(rng, 1, n)[0]
    bit = torch.tensor([rng.randrange(2) for _ in range(n)], dtype=torch.int32)
    lib = host_kernels["miller_step"]
    forms = [(ML.DBL_GROUP, lib.host_dbl, ML.miller_step_dbl_plain, (f, t, xp, yp)),
             (ML.ADD_GROUP, lib.host_add, ML.miller_step_add_plain, (f, t, q, xp, yp, bit))]
    for g, kern, plain, operands in forms:
        for w in (1, n):
            args = tuple(x[..., :w].contiguous() for x in operands)
            rf, rt = plain(*args)
            for down in (0, 1):
                fw, tw = torch.empty_like(args[0]), torch.empty_like(args[1])
                kern(*map(_ptr, args), _ptr(fw), _ptr(tw), w, down)
                assert torch.equal(fw, rf) and torch.equal(tw, rt), (plain.__name__, g, w, down)


def _run_schedule(prog, sched):
    """Walk the phases over a model of the slots: every operand must still
    sit in its slot when its phase starts, and no phase may write a slot
    that it reads or that another op of the phase writes.  Returns the ops
    run, in order."""
    held = {}  # slot -> value id
    order = []
    for ranks in sched.phases:
        vids = [v for r in ranks for v in r]
        reads = {sched.slot[i] for v in vids for i in prog.ops[v].ins if i in sched.slot}
        writes = [sched.slot[v] for v in vids]
        assert len(writes) == len(set(writes)), "two ops of one phase write one slot"
        assert not reads & set(writes), "a phase writes a slot it reads"
        for v in vids:
            for i in prog.ops[v].ins:
                if prog.ops[i].kind not in ML.FLAGS:
                    assert held.get(sched.slot[i]) == i, "an operand was overwritten"
        for v in vids:
            held[sched.slot[v]] = v
        order += vids
    return order


@pytest.mark.parametrize("step, group, mxu", [
    pytest.param("dbl", 8, False, id="8"),
    pytest.param("dbl", ML.DBL_GROUP, False, id=str(ML.DBL_GROUP)),
    pytest.param("dbl", ML.DBL_MXU_GROUP, True, id=f"dbl-mxu-{ML.DBL_MXU_GROUP}"),
    pytest.param("add", 8, False, id="add-8"),
    pytest.param("add", ML.ADD_GROUP, False, id=f"add-{ML.ADD_GROUP}"),
    pytest.param("add", ML.ADD_MXU_GROUP, True, id=f"add-mxu-{ML.ADD_MXU_GROUP}"),
    pytest.param("wsm_g2", 8, False, id="wsm-g2-8"),
    pytest.param("wsm_g2", W.FORMS[2][1], False, id=f"wsm-g2-{W.FORMS[2][1]}")])
def test_group_schedule_never_overwrites_a_live_slot(step, group, mxu):
    """The group schedules of kernels 2, 2m, 3, 3m and 6's G2 step (at its
    G and at 8, the other G timed) on the recorded programs (no compiler):
    each limb op runs once, after its operands, in a phase that does not
    write what it reads; a round holds at most one product per rank; the
    outputs are stored from their own slots; the slots fit in one block's
    shared memory, and the printed launcher asserts that they do with the
    MXU form's DMMA staging (nvcc checks it)."""
    prog = W.program(2) if step == "wsm_g2" else ML.program(step)
    sched = codegen.group_schedule(prog, group)
    order = _run_schedule(prog, sched)
    limb_ops = [op.out for op in prog.ops if op.kind not in ML.FLAGS]
    assert sorted(order) == limb_ops
    for ranks in sched.phases:
        kinds = {prog.ops[v].kind in ML.PRODUCTS for r in ranks for v in r}
        assert len(kinds) == 1  # a round of products, or linear ops
        if kinds == {True}:
            assert all(len(r) <= 1 for r in ranks)
    rounds = sum(prog.ops[next(v for r in ph for v in r)].kind in ML.PRODUCTS
                 for ph in sched.phases)
    assert rounds == sched.n_rounds
    # the level-parallel bound: no more rounds than dealing each level alone
    levels = [len(item) for kind, item in prog.stages if kind in ML.PRODUCTS]
    assert sched.n_rounds <= sum(-(-c // group) for c in levels)
    assert sched.n_slots * F.N * 2 * 32 <= codegen.SHARED_LIMIT
    launcher = codegen._kernel(prog, mxu=mxu, group=group).split('extern "C"')[1]
    assert f"static_assert(kShared <= {codegen.SHARED_LIMIT}," in launcher
    assert ("sizeof(lh::MxuShared" in launcher.split("static_assert")[0]) == mxu


def test_step_wrappers_check_operands():
    z = torch.zeros((12, F.N, 3), dtype=torch.int32)
    t, p = z[:6].clone(), z[0].clone()
    with pytest.raises(ValueError):
        ML.miller_step_dbl(z, t[:5].clone(), p, p)
    with pytest.raises(TypeError):
        ML.miller_step_dbl(z.long(), t.long(), p.long(), p.long())
    with pytest.raises(ValueError):
        ML.miller_step_add(z, t, z[:4].clone(), p, p, torch.zeros(2, dtype=torch.int32))


def test_mont_forms_are_checked_and_picked_by_width():
    p = torch.zeros((F.N, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        MK.mont_mul(p, p, form=(2, 32))
    widest = 0
    for form, width in zip(MK.FORMS, MK.FORM_MAX_WIDTH):
        assert MK.form_for(widest + 1) == MK.form_for(width) == form
        widest = width
    assert MK.form_for(widest + 1) == MK.FORMS[-1] == (1, 128)
    # CPU tensors take the plain version whatever the form asked for
    for form in MK.FORMS:
        assert torch.equal(MK.mont_mul(p, p, form=form), MK.mont_mul_plain(p, p))
