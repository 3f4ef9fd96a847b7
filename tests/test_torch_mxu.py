"""Kernel 7 and the MXU arm (torch_backend/mxu_kernel.py, the MXU variants of
kernels 2-5) against the JAX package's pallas_mxu, on the CPU.

Fast tier (byte equality unless stated):
* ``to13_plain`` / ``to15_plain`` against ``pallas_mxu._to13`` / ``_to15``
  (plain jnp) on the boundary and random corpora of test_pallas_fp.py, and
  the 13-bit constants: to13 of the 15-bit P and P' are the strict 13-bit
  limbs of P and P' (limbs.SPEC13), limb for limb;
* ``mont_mul_mxu_plain`` against ``pallas_mxu.mont_mul_limbs(...,
  interpret=True)`` on one lane-concatenated corpus (strict, fp_add / fp_sub
  lazy operands, all-QMAX, a * a lanes: kernel 9's body), and by canonical
  value against kernel 1's plain version on the in-contract lanes;
* the gates' precedence, set_mxu > LIGHTHOUSE_TPU_MXU > plan > off (the
  twin of test_autotune.py's, without the tuner);
* routing on CPU tensors under set_mxu(True): fp.mont_mul, fp_pow and
  h2c.fp2_pow_static (chains on) reach the MXU plain versions; the WSM
  step does not;
* csrc/mxu.cuh's per-lane parts, and the MXU kernels of mxu.cu, chain.cu
  and miller_step_mxu.cu (kernel 7 in both forms, both chains and both
  Miller steps in their group forms, ranks run both ways), compiled with
  g++ and held against the
  plain versions lane by lane (the DMMA products come from the host
  stand-in in torch_host_cuda.py); mxu_coop.cuh's mont_group_mxu_core alone
  at G = 8 and 16, and the bound behind its carry maps;
* B=8 verify through TorchBackend(device="cpu") under chains + WSM + MXU
  equals the oracle, with the MXU variants on every product path (Miller
  63 + 63, Fp chain 12, Fp2 chain 4) and the 15-bit core for the WSM steps.

Slow tier: the one-invalid verdict under the arm; the MXU Fp chain and
Miller steps against the Pallas kernels built with mxu=True, in interpret
mode.
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

from lighthouse_tpu.crypto.bls import api as japi  # noqa: E402
from lighthouse_tpu.crypto.bls.jax_backend import limbs as LB  # noqa: E402
from lighthouse_tpu.crypto.bls.jax_backend import pallas_fp as PF  # noqa: E402
from lighthouse_tpu.crypto.bls.jax_backend import pallas_mxu as PMX  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import api as tapi  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import backend as TB  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import chain_kernel as CK  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import h2c  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import miller_kernel as ML  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import mont_kernel as MK  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import mxu_kernel as X  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import wsm_kernel as W  # noqa: E402

P = F.P_INT


def _u32(t: torch.Tensor):
    return jnp.asarray(t.numpy().astype(np.uint32))


def _i64(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


# -- the plane converters and constants ------------------------------------------

_BOUNDARY = [0, 1, P - 1, P, LB.R_INT - 1, LB.R1_INT, LB.R2_INT]


def _quasi15_corpus() -> np.ndarray:
    """test_pallas_fp._quasi15_corpus: strict boundary values, random quasi
    columns and the all-QMAX column, (26, 17) uint32."""
    nrng = np.random.default_rng(0x13B)
    cols = [LB.SPEC15.int_to_limbs(v) for v in _BOUNDARY]
    cols += [nrng.integers(0, F.QMAX + 1, size=26, dtype=np.uint32) for _ in range(9)]
    cols.append(np.full(26, F.QMAX, dtype=np.uint32))
    return np.stack(cols, axis=1).astype(np.uint32)


def test_to13_and_to15_match_the_reference_converters():
    a15 = _quasi15_corpus()
    got13 = X.to13_plain(torch.as_tensor(a15.astype(np.int32)))
    np.testing.assert_array_equal(got13.numpy(), _i64(PMX._to13(jnp.asarray(a15))))
    assert int(got13.max()) <= 8193 < X.QMAX13
    rng = random.Random(0x15)
    vals = [v % LB.R_INT for v in _BOUNDARY] + [rng.randrange(LB.R_INT) for _ in range(20)]
    a13 = np.stack([LB.SPEC13.int_to_limbs(v) for v in vals], axis=1).astype(np.uint32)
    got15 = X.to15_plain(torch.as_tensor(a13.astype(np.int32)))
    np.testing.assert_array_equal(got15.numpy(), _i64(PMX._to15(jnp.asarray(a13))))
    np.testing.assert_array_equal(got15.numpy(), np.stack(
        [LB.SPEC15.int_to_limbs(v) for v in vals], axis=1).astype(np.int64))


def test_13_bit_constants_are_the_reference_relimbing():
    """The kernel re-limbs P and P' with to13 of the 15-bit constants, as the
    reference does in-kernel; for these two integers that equals their strict
    13-bit limbs, and P13's spill limb is zero (so m * P has 30 x 30 terms)."""
    c = X.constants13()
    ref = {"P13": PMX._to13(jnp.asarray(PF._P_COLS)), "PP13": PMX._to13(jnp.asarray(PF._PP_COLS))}
    for name, spec_limbs in (("P13", LB.SPEC13.p_limbs), ("PP13", LB.SPEC13.pprime_limbs)):
        np.testing.assert_array_equal(c[name], _i64(ref[name])[:, 0])
        np.testing.assert_array_equal(c[name], _i64(spec_limbs))
    assert c["P13"][30] == 0 and c["PP13"][30] == 0


# -- kernel 7's plain version against the reference ----------------------------------


def _corpus():
    """(x, y, in_contract) on 228 lanes: random strict values, the
    test_pallas_fp.py lazy operands (s = a + a, t = b - a, their negation),
    all-QMAX limbs (out of the value contract) and a * a lanes."""
    rng = random.Random(0xA11A)
    n = 32
    a = F.lfp_encode([rng.randrange(P) for _ in range(n)], "cpu")
    b = F.lfp_encode([rng.randrange(P) for _ in range(n)], "cpu")
    s, t = F.fp_add(a, a), F.fp_sub(b, a)
    d = F.fp_neg(t)
    q = torch.full((F.N, 4), F.QMAX, dtype=torch.int32)
    pairs = [(a.limbs, b.limbs, True), (s.limbs, t.limbs, True), (t.limbs, s.limbs, True),
             (t.limbs, d.limbs, True), (q, q, False), (a.limbs, a.limbs, True),
             (s.limbs, s.limbs, True), (t.limbs, t.limbs, True)]
    x = torch.cat([p[0] for p in pairs], dim=1).contiguous()
    y = torch.cat([p[1] for p in pairs], dim=1).contiguous()
    ok = torch.cat([torch.full((p[0].shape[1],), p[2]) for p in pairs])
    return x, y, ok


def test_plain_mxu_product_matches_pallas_interpret(record_property):
    x, y, in_contract = _corpus()
    got = X.mont_mul_mxu_plain(x, y)
    assert got.dtype == torch.int32
    want = _i64(PMX.mont_mul_limbs(_u32(x), _u32(y), interpret=True))
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    assert int(got.max()) <= F.MASK  # strict out
    # by value, against kernel 1's plain version on the in-contract lanes
    vpu = MK.mont_mul_plain(x, y)
    lanes = in_contract.nonzero().flatten()
    assert [v % P for v in F.limbs_to_ints(got[:, lanes])] == [
        v % P for v in F.limbs_to_ints(vpu[:, lanes])]
    # reported, not asserted: lanes whose bytes differ from kernel 1's
    differ = int((got != vpu).any(dim=0).sum())
    record_property("lanes_differing_from_15_bit_core", differ)
    print(f"mont_mul_mxu_plain vs mont_mul_plain: {differ} of {x.shape[1]} lanes differ in bytes")


# -- the gates ---------------------------------------------------------------------


@pytest.fixture
def clean_gates(monkeypatch):
    monkeypatch.delenv("LIGHTHOUSE_TPU_MXU", raising=False)
    monkeypatch.setattr(F, "_MXU_MODE", None)
    monkeypatch.setattr(F, "_MXU_PLAN", None)
    yield monkeypatch
    F.set_mxu(None)
    F.install_mxu_plan(None)


def test_gate_precedence_override_env_plan(clean_gates):
    monkeypatch = clean_gates
    assert F.mxu_enabled() is False and F.mxu_for_batch(8) is False
    F.install_mxu_plan({8: True, 4096: False, "*": True})
    assert F.mxu_for_batch(8) is True and F.mxu_for_batch(4096) is False
    assert F.mxu_for_batch(16) is True  # the plan's "*" default
    assert F.mxu_enabled() is True  # the gate reads the "*" default too
    monkeypatch.setenv("LIGHTHOUSE_TPU_MXU", "0")
    assert F.mxu_for_batch(8) is False and F.mxu_planned(8) is None  # env beats plan
    monkeypatch.setenv("LIGHTHOUSE_TPU_MXU", "1")
    assert F.mxu_for_batch(4096) is True
    monkeypatch.delenv("LIGHTHOUSE_TPU_MXU")
    assert F.mxu_for_batch(8) is True and F.mxu_for_batch(4096) is False  # plan resumes
    monkeypatch.setenv("LIGHTHOUSE_TPU_MXU", "1")
    prev = F.set_mxu(False)
    assert prev is None
    assert F.mxu_for_batch(8) is False and F.mxu_active() is False  # override beats both
    assert F.set_mxu(prev) is False
    assert F.mxu_for_batch(8) is True
    F.install_mxu_plan(None)
    monkeypatch.delenv("LIGHTHOUSE_TPU_MXU")
    assert F.mxu_enabled() is False and F.mxu_planned(8) is None


# -- routing on CPU tensors ----------------------------------------------------------


def _spy(monkeypatch, module, attr, log, key=None):
    orig = getattr(module, attr)

    def wrapped(*args, **kw):
        name = key(args, kw) if key else attr
        log[name] = log.get(name, 0) + 1
        return orig(*args, **kw)

    monkeypatch.setattr(module, attr, wrapped)


def _arg(i, name):
    """The mxu flag of a plain version called positionally or by keyword."""
    def key(args, kw):
        return f"{name}_mxu" if (args[i] if len(args) > i else kw.get("mxu", False)) else name
    return key


def _spy_paths(monkeypatch):
    log = {}
    _spy(monkeypatch, X, "mont_mul_mxu", log)
    _spy(monkeypatch, MK, "mont_mul", log)
    _spy(monkeypatch, CK, "pow_chain_plain", log, _arg(2, "fp_chain"))
    _spy(monkeypatch, CK, "fp2_pow_chain_plain", log, _arg(3, "fp2_chain"))
    _spy(monkeypatch, ML, "miller_step_dbl_plain", log, _arg(4, "dbl"))
    _spy(monkeypatch, ML, "miller_step_add_plain", log, _arg(6, "add"))
    _spy(monkeypatch, W, "run_plain", log, _arg(2, "wsm"))
    return log


@pytest.fixture
def mxu_on(clean_gates):
    F.set_chains(True)
    F.set_wsm(True)
    F.set_mxu(True)
    yield clean_gates
    F.set_chains(False)
    F.set_wsm(False)


def test_mxu_routes_products_and_chains_but_not_wsm(mxu_on):
    log = _spy_paths(mxu_on)
    rng = random.Random(31)
    a = F.fp_add(F.lfp_encode([rng.randrange(1, P) for _ in range(2)], "cpu"),
                 F.lfp_encode([rng.randrange(P) for _ in range(2)], "cpu"))
    vals = F.decode_mont(a)
    assert F.decode_mont(F.mont_mul(a, a)) == [v * v % P for v in vals]
    assert F.decode_mont(F.fp_pow(a, 0x305)) == [pow(v, 0x305, P) for v in vals]
    x = (F.lfp_encode([rng.randrange(P) for _ in range(2)], "cpu"),
         F.lfp_encode([rng.randrange(P) for _ in range(2)], "cpu"))
    arm = h2c.fp2_pow_static(x, [1, 0, 1, 1, 0, 1])
    W.wsm_step_g1(*_wsm_operands(rng))  # stays on the 15-bit core
    assert log.pop("mont_mul_mxu") > 0
    assert log == {"fp_chain_mxu": 1, "fp2_chain_mxu": 1, "wsm": 1}
    F.set_mxu(False)
    default = h2c.fp2_pow_static(x, [1, 0, 1, 1, 0, 1])
    assert [F.limbs_to_ints(F.fp_canon(c)) for c in arm] == [
        F.limbs_to_ints(F.fp_canon(c)) for c in default]


def _wsm_operands(rng):
    n = 3

    def planes(k):
        return torch.stack([torch.as_tensor(F.ints_to_limbs(
            [rng.randrange(2 * P) for _ in range(n)])) for _ in range(k)])

    def flags():
        return torch.tensor([[rng.randrange(2) for _ in range(n)]], dtype=torch.int32)

    return planes(3), flags(), planes(2), flags(), flags()


# -- host builds of the MXU sources --------------------------------------------------

_HARNESS_MXU = r"""
#define LANES_OF(rows, src) for (int i = 0; i < rows; ++i) src[i] = in[i * n + l]
extern "C" void host_to13(const uint32_t* in, uint32_t* out, int n) {
  for (int l = 0; l < n; ++l) {
    uint32_t a[lh::NL], o[lh::NL13];
    LANES_OF(lh::NL, a);
    lh::to13(a, o);
    for (int i = 0; i < lh::NL13; ++i) out[i * n + l] = o[i];
  }
}
extern "C" void host_to15(const uint32_t* in, uint32_t* out, int n) {
  for (int l = 0; l < n; ++l) {
    uint32_t a[lh::NL13], o[lh::NL];
    LANES_OF(lh::NL13, a);
    lh::to15(a, o);
    for (int i = 0; i < lh::NL; ++i) out[i * n + l] = o[i];
  }
}
extern "C" void host_cols13(const uint32_t* in, const uint32_t* in2, uint32_t* out, int n) {
  for (int l = 0; l < n; ++l) {
    uint32_t a[lh::NL13], b[lh::NL13], t[lh::NC13];
    LANES_OF(lh::NL13, a);
    for (int i = 0; i < lh::NL13; ++i) b[i] = in2[i * n + l];
    lh::cols13(a, b, t);
    for (int i = 0; i < lh::NC13; ++i) out[i * n + l] = t[i];
  }
}
extern "C" void host_compress13(const uint32_t* in, uint32_t* out, int n) {
  for (int l = 0; l < n; ++l) {
    uint32_t c[lh::NC13];
    LANES_OF(lh::NC13, c);
    lh::compress13(c);
    for (int i = 0; i < lh::NC13; ++i) out[i * n + l] = c[i];
  }
}
extern "C" void host_finish(const uint32_t* in, const uint32_t* in2, uint32_t* out, int n) {
  for (int l = 0; l < n; ++l) {
    uint32_t t[lh::NC13], u[lh::NC13], o[lh::NL];
    LANES_OF(lh::NC13, t);
    for (int i = 0; i < lh::NC13; ++i) u[i] = in2[i * n + l];
    lh::mxu_finish(t, u, o);
    for (int i = 0; i < lh::NL; ++i) out[i * n + l] = o[i];
  }
}
extern "C" void host_mont_mxu_thread(const uint32_t* a, const uint32_t* b, uint32_t* o, int n) {
  EACH_LANE(mont_mul_mxu_kernel(a, b, o, n))
}
extern "C" void host_mont_mxu(const uint32_t* a, const uint32_t* b, uint32_t* o, int n,
                              int down) {
  lh::host_ranks_down = down;
  EACH_LANE(mont_mul_mxu_group_kernel<kMontMxuGroup>(a, b, o, n))
}
"""

_HARNESS_CHAIN = r"""
extern "C" void host_fp_chain_mxu(const int32_t* tape, int nd, const uint32_t* b, uint32_t* o,
                                  int n, int down) {
  lh::host_ranks_down = down;
  EACH_LANE(fp_chain_mxu_group_kernel<kFpMxuGroup>(tape, nd, b, o, n))
}
extern "C" void host_fp2_chain_mxu(const int32_t* tape, int nd, const uint32_t* a0,
                                   const uint32_t* a1, uint32_t* o0, uint32_t* o1, int n,
                                   int down) {
  lh::host_ranks_down = down;
  EACH_LANE(fp2_chain_mxu_group_kernel<kFp2MxuGroup>(tape, nd, a0, a1, o0, o1, n))
}
// mont_group_mxu_core alone at G ranks: a and b into a lane's shared arrays,
// the product stored to a (26, n) plane.
template <int G>
void core13(const uint32_t* a, const uint32_t* b, uint32_t* o, int n) {
  namespace c13 = lh::coop13;
  for (int l = 0; l < n; ++l) {
    alignas(16) uint32_t sm[c13::kTabWords + c13::kWorkWords<G> + 2 * NP];
    const c13::Work w{sm + c13::kTabWords};
    const Lane xa{sm + c13::kTabWords + c13::kWorkWords<G>, 1}, xb{xa.p + NP, 1};
    double* const tab = reinterpret_cast<double*>(sm);
    LH_RANKS(G, c13::clear_sums<G>(r, w); c13::fill_tables<G>(r, tab);
             for (int i = r; i < NL; i += G) {
               xa(i) = a[i * n + l];
               xb(i) = b[i * n + l];
             })
    const auto none = [](int) {};
    c13::mont_group_mxu_core<G>(xa, xb, w, tab, lh::coop::Plane{o, n, l}, true, none, none);
  }
}
extern "C" void host_core13(const uint32_t* a, const uint32_t* b, uint32_t* o, int n, int g,
                            int down) {
  lh::host_ranks_down = down;
  if (g == 8) {
    core13<8>(a, b, o, n);
  } else {
    core13<16>(a, b, o, n);
  }
}
"""


_HARNESS_STEPS = f"""
extern "C" void host_dbl(const uint32_t* f, const uint32_t* t, const uint32_t* xp,
                         const uint32_t* yp, uint32_t* fo, uint32_t* to, int n, int down) {{
  lh::host_ranks_down = down;
  EACH_LANE(miller_step_dbl_mxu_g{ML.DBL_MXU_GROUP}_kernel(f, t, xp, yp, fo, to, n))
}}
extern "C" void host_add(const uint32_t* f, const uint32_t* t, const uint32_t* q,
                         const uint32_t* xp, const uint32_t* yp, const int32_t* bit,
                         uint32_t* fo, uint32_t* to, int n, int down) {{
  lh::host_ranks_down = down;
  EACH_LANE(miller_step_add_mxu_g{ML.ADD_MXU_GROUP}_kernel(f, t, q, xp, yp, bit, fo, to, n))
}}
"""


@pytest.fixture(scope="module")
def host_mxu(tmp_path_factory):
    d = tmp_path_factory.mktemp("hostmxu")
    return {"mxu": host_cuda.build(d, "mxu", _HARNESS_MXU),
            "chain": host_cuda.build(d, "chain", _HARNESS_CHAIN),
            "miller_step_mxu": host_cuda.build(d, "miller_step_mxu", _HARNESS_STEPS)}


def test_host_compiled_mxu_helpers_match_plain(host_mxu):
    """to13, the a * b columns, a 13-bit carry pass, the 61-step carry with
    to15, and to15 alone, lane by lane; then both forms of kernel 7 (the
    one-thread form's DMMA products and the group form's tile pairs from the
    host stand-in) against mont_mul_mxu_plain."""
    lib, ptr = host_mxu["mxu"], host_cuda.ptr
    x, y, _ = _corpus()
    n = x.shape[1]

    def run(fn, out_rows, *ins):
        out = torch.empty((out_rows, n), dtype=torch.int32)
        fn(*[ptr(t.contiguous()) for t in ins], ptr(out), n)
        return out

    a13 = X.to13_plain(x).int()
    b13 = X.to13_plain(y).int()
    assert torch.equal(run(lib.host_to13, 31, x), a13)
    t = X.dot_cols_plain(a13.long(), b13.long()).int()
    assert torch.equal(run(lib.host_cols13, 61, a13, b13), t)
    rng = np.random.default_rng(0x61)
    raw = torch.as_tensor(rng.integers(0, 1 << 31, size=(61, n)).astype(np.int32))
    assert torch.equal(run(lib.host_compress13, 61, raw), X.compress13(raw.long()).int())
    u = torch.as_tensor(rng.integers(0, 8193, size=(61, n)).astype(np.int32))
    u[50:] = 0  # (t + u) / R below 2^390
    want = X.to15_plain(X._strict13(t.long() + u.long())[X.NLOW:]).int()
    assert torch.equal(run(lib.host_finish, 26, t, u), want)
    strict13 = X._strict13(u.long())[:31].int()
    assert torch.equal(run(lib.host_to15, 26, strict13), X.to15_plain(strict13).int())
    want = X.mont_mul_mxu_plain(x, y)
    assert torch.equal(run(lib.host_mont_mxu_thread, 26, x, y), want)
    out = torch.empty_like(x)
    lib.host_mont_mxu(ptr(x), ptr(y), ptr(out), n, 0)
    assert torch.equal(out, want)


@pytest.mark.parametrize("corpus", ["lanes", "quasi15"])
def test_host_compiled_mxu_group_product_matches_plain(host_mxu, corpus):
    """Kernel 7's group form (X.MXU_FORM ranks, operands read from the
    global planes in the core's first phase) at 1 and 33 lanes, each phase's
    ranks run up and down: byte-equal to mont_mul_mxu_plain on _corpus's
    strict, lazy, all-QMAX and a * a lanes, and on _quasi15_corpus's edge
    limbs against themselves and their neighbours."""
    lib, ptr = host_mxu["mxu"], host_cuda.ptr
    if corpus == "lanes":
        x, y, _ = _corpus()
    else:
        edge = torch.as_tensor(_quasi15_corpus().astype(np.int32))
        x, y = torch.cat([edge, edge], dim=1), torch.cat([edge, edge.roll(1, 1)], dim=1)
    for w in (1, 33):
        a, b = x[:, :w].contiguous(), y[:, :w].contiguous()
        want = X.mont_mul_mxu_plain(a, b)
        for down in (0, 1):
            out = torch.empty_like(a)
            lib.host_mont_mxu(ptr(a), ptr(b), ptr(out), w, down)
            assert torch.equal(out, want), (w, down)


def test_host_compiled_mxu_chains_match_plain(host_mxu):
    """The group forms of kernels 4m (FP_MXU_FORM, its squares full
    products) and 5m (FP2_MXU_FORM), both on mont_group_mxu_core, at 1 and
    G + 1 lanes with each phase's ranks run up and down, on short exponents
    with a 0 digit."""
    lib, ptr = host_mxu["chain"], host_cuda.ptr
    rng = random.Random(41)
    n = max(CK.FP_MXU_FORM[0], CK.FP2_MXU_FORM[0]) + 1
    a = F.lfp_encode([rng.randrange(P) for _ in range(n)], "cpu").limbs
    b = F.lfp_encode([rng.randrange(P) for _ in range(n)], "cpu").limbs
    e = 0x305
    tape = torch.tensor(CK.window_digits(bin(e)[2:]), dtype=torch.int32)
    for w in (1, CK.FP_MXU_FORM[0] + 1):
        x = a[:, :w].contiguous()
        want = CK.pow_chain_plain(x, e, mxu=True)
        for down in (0, 1):
            out = torch.empty_like(x)
            lib.host_fp_chain_mxu(ptr(tape), len(tape), ptr(x), ptr(out), w, down)
            assert torch.equal(out, want), (w, down)
    bits = [1, 0, 0, 0, 0, 0, 0, 1, 0, 1]
    tape = torch.tensor(CK.window_digits("".join(map(str, bits))), dtype=torch.int32)
    for w in (1, CK.FP2_MXU_FORM[0] + 1):
        x, y = a[:, :w].contiguous(), b[:, :w].contiguous()
        r0, r1 = CK.fp2_pow_chain_plain(x, y, bits, mxu=True)
        for down in (0, 1):
            o0, o1 = torch.empty_like(x), torch.empty_like(y)
            lib.host_fp2_chain_mxu(ptr(tape), len(tape), ptr(x), ptr(y), ptr(o0), ptr(o1), w,
                                   down)
            assert torch.equal(o0, r0) and torch.equal(o1, r1), (w, down)


@pytest.mark.parametrize("group", [8, 16])
def test_host_group_mxu_core_matches_plain(host_mxu, group):
    """mont_group_mxu_core (csrc/mxu_coop.cuh) alone at G = 8 and 16 ranks,
    each phase's ranks run up and down, its DMMA tile pairs from the host
    stand-in's row-range form: byte-equal to mont_mul_mxu_plain on the
    strict, lazy, all-QMAX and a * a lanes of _corpus and on the edge limbs
    of _quasi15_corpus (boundary values, random quasi limbs, all-QMAX)
    against their neighbours."""
    lib, ptr = host_mxu["chain"], host_cuda.ptr
    x, y, _ = _corpus()
    edge = torch.as_tensor(_quasi15_corpus().astype(np.int32))
    x = torch.cat([x, edge, edge], dim=1).contiguous()
    y = torch.cat([y, edge, edge.roll(1, 1)], dim=1).contiguous()
    want = X.mont_mul_mxu_plain(x, y)
    for down in (0, 1):
        out = torch.empty_like(x)
        lib.host_core13(ptr(x), ptr(y), ptr(out), x.shape[1], group, down)
        assert torch.equal(out, want), down


def test_group_mxu_carry_ins_stay_below_three():
    """The carry maps of mont_group_mxu_core's 61-step carry record carry-ins
    0, 1 and 2 only.  From the bounds: a column of t = a13 * b13 sums at
    most 31 products of to13 limbs (<= 8193), a column of u = m * P13 at
    most 30 products of m's limbs after three passes and P13's limbs; three
    13-bit passes take each below 2^13 + 1; the carry into column k + 1 is
    (t_k + u_k + carry) >> 13, at most 2 if the carry into column k is."""
    c13 = X.constants13()

    def passes(bound):
        for _ in range(3):
            bound = X.M13 + (bound >> X.BITS13)
        return bound

    t_raw = X.NL13 * 8193 ** 2
    t_max = passes(t_raw)
    m_raw = X.NLOW * t_max * int(c13["PP13"].max())
    m_max = passes(m_raw)
    u_raw = X.NLOW * m_max * int(c13["P13"].max())
    u_max = passes(u_raw)
    assert max(t_raw, m_raw, u_raw) < 1 << 31  # exact in uint32 and in a double
    assert t_max == m_max == u_max == 1 << X.BITS13
    c_max = 0  # the largest carry into any column, by induction over the columns
    while (t_max + u_max + c_max) >> X.BITS13 > c_max:
        c_max = (t_max + u_max + c_max) >> X.BITS13
    assert set(range(c_max + 1)) == {0, 1, 2}  # two bits per carry-in, three per map


def test_host_compiled_mxu_miller_steps_match_plain(host_mxu):
    """The group forms of kernels 2m and 3m at 1 and G + 1 lanes, ranks run
    both ways, kernel 3m with random addition bits, byte for byte against
    the plain versions with mxu=True."""
    lib, ptr = host_mxu["miller_step_mxu"], host_cuda.ptr
    rng = random.Random(43)
    n = max(ML.DBL_MXU_GROUP, ML.ADD_MXU_GROUP) + 1

    def planes(k):
        return torch.stack([torch.as_tensor(F.ints_to_limbs(
            [rng.randrange(2 * P) for _ in range(n)])) for _ in range(k)])

    f, t, q = planes(12), planes(6), planes(4)
    xp, yp = planes(1)[0], planes(1)[0]
    for w in (1, n):
        args = tuple(x[..., :w].contiguous() for x in (f, t, xp, yp))
        rf, rt = ML.miller_step_dbl_plain(*args, mxu=True)
        for down in (0, 1):
            fw, tw = torch.empty_like(args[0]), torch.empty_like(args[1])
            lib.host_dbl(*map(ptr, args), ptr(fw), ptr(tw), w, down)
            assert torch.equal(fw, rf) and torch.equal(tw, rt), (w, down)
    bit = torch.tensor([rng.randrange(2) for _ in range(n)], dtype=torch.int32)
    for w in (1, n):
        args = tuple(x[..., :w].contiguous() for x in (f, t, q, xp, yp, bit))
        rf, rt = ML.miller_step_add_plain(*args, mxu=True)
        for down in (0, 1):
            fo, to = torch.empty_like(args[0]), torch.empty_like(args[1])
            lib.host_add(*map(ptr, args), ptr(fo), ptr(to), w, down)
            assert torch.equal(fo, rf) and torch.equal(to, rt), (w, down)


def test_mxu_launcher_asserts_the_shared_limit():
    """Kernel 7's launcher builds the forms mxu_kernel lists, the group form
    MXU_FORM (G ranks, blocks of 32 lanes) and the one-thread form, and
    checks the group form's dynamic shared memory (the Toeplitz tables and
    the core's work rows) against the limit the other group launchers use;
    form_for takes the group form up to its widest width."""
    from lighthouse_tpu_torch.crypto.bls.torch_backend import codegen

    src = (host_cuda._build.CSRC / "mxu.cu").read_text()
    assert f"static_assert(kShared <= {codegen.SHARED_LIMIT}," in src
    assert f"constexpr int kMontMxuGroup = {X.MXU_FORM[0]};" in src and X.MXU_FORM[1] == 32
    assert X.FORMS == (X.MXU_FORM, (1, 64)) and "constexpr int kBlock = 64;" in src
    assert src.count("__global__") == 2
    widest = X.FORM_MAX_WIDTH[0]
    assert [X.form_for(n) for n in (1, 2, widest, widest + 1)] == [X.MXU_FORM] * 3 + [(1, 64)]


def test_mxu_wrapper_checks_its_operands():
    z = torch.zeros((F.N, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        X.mont_mul_mxu(z.long(), z.long())
    with pytest.raises(ValueError):
        X.mont_mul_mxu(z, z[:, :2].contiguous())
    with pytest.raises(ValueError):
        X.mont_mul_mxu(z.t().contiguous().t(), z)
    with pytest.raises(ValueError):
        X.mont_mul_mxu(z, z, form=(16, 32))
    assert X.launches == 0  # CPU calls take the plain version and count nothing
    X.mont_mul_mxu(z, z)
    assert X.launches == 0


# -- the arm end to end --------------------------------------------------------------


def _sets(api, corpus: str):
    """Five signed sets (one of three signers on one message) from a seeded
    spec; in "one_invalid" the third is signed under another key."""
    rng = random.Random(f"mxu-{corpus}")
    spec = []
    for _ in range(4):
        sk = rng.randrange(2, 10**12)
        spec.append(([sk], rng.randbytes(32), sk))
    multi = [rng.randrange(2, 10**12) for _ in range(3)]
    spec.append((multi, b"\x33" * 32, sum(multi)))
    if corpus == "one_invalid":
        sks, msg, signer = spec[2]
        spec[2] = (sks, msg, signer + 1)
    return [api.SignatureSet(api.SecretKey(signer).sign(msg),
                             [api.SecretKey(k).public_key() for k in sks], msg)
            for sks, msg, signer in spec]


@pytest.mark.parametrize("corpus", [
    "valid", pytest.param("one_invalid", marks=pytest.mark.slow)])
def test_mxu_arm_verdicts_match_oracle(mxu_on, corpus):
    want = japi.cpu_backend().verify_signature_sets(_sets(japi, corpus))
    assert want is (corpus == "valid")
    log = _spy_paths(mxu_on)
    backend = TB.TorchBackend(device="cpu", min_batch=8)
    assert backend.verify_signature_sets(_sets(tapi, corpus)) is want
    assert log.pop("mont_mul_mxu") > 0
    assert log == {"dbl_mxu": 63, "add_mxu": 63, "fp_chain_mxu": 12, "fp2_chain_mxu": 4,
                   "wsm": 128}
    assert F.set_mxu(True) is True  # dispatch restored the override it found


# -- slow: the MXU chain and Miller steps against the Pallas kernels ------------------


@pytest.mark.slow
def test_mxu_fp_chain_plain_matches_pallas_interpret():
    """pallas_fp.pow_chain_limbs(..., mxu=True) in interpret mode (digits 3,
    0, 5: the table, a 0 digit, squares as full products) on 128 lanes."""
    rng = random.Random(17)
    a = F.lfp_encode([rng.randrange(P) for _ in range(128)], "cpu").limbs
    want = PF.pow_chain_limbs(_u32(a), 0x305, interpret=True, mxu=True)
    np.testing.assert_array_equal(
        CK.pow_chain_plain(a, 0x305, mxu=True).numpy().astype(np.int64), _i64(want))


@pytest.mark.slow
def test_mxu_miller_steps_match_pallas_interpret():
    """pallas_miller._dbl_call / _add_call built with mxu=True, in interpret
    mode, on 128 lanes of reduced random planes."""
    from lighthouse_tpu.crypto.bls.jax_backend import pallas_miller as PM

    rng = random.Random(19)
    n = 128

    def planes(k):
        return torch.stack([torch.as_tensor(F.ints_to_limbs(
            [rng.randrange(2 * P) for _ in range(n)])) for _ in range(k)])

    f, t, q = planes(12), planes(6), planes(4)
    xp, yp = planes(1)[0], planes(1)[0]
    bit = torch.tensor([rng.randrange(2) for _ in range(n)], dtype=torch.int32)
    consts = PM._const_arrays(n)
    outs = PM._dbl_call(n, n, True, True)(*[_u32(p) for p in f], *[_u32(p) for p in t],
                                          _u32(xp), _u32(yp), *consts)
    rf, rt = ML.miller_step_dbl_plain(f, t, xp, yp, mxu=True)
    np.testing.assert_array_equal(torch.cat([rf, rt]).numpy().astype(np.int64),
                                  np.stack([_i64(o) for o in outs]))
    outs = PM._add_call(n, n, True, True)(
        *[_u32(p) for p in f], *[_u32(p) for p in t], *[_u32(p) for p in q], _u32(xp),
        _u32(yp), jnp.asarray(bit.numpy().astype(np.uint32)).reshape(1, n), *consts)
    rf, rt = ML.miller_step_add_plain(f, t, q, xp, yp, bit, mxu=True)
    np.testing.assert_array_equal(torch.cat([rf, rt]).numpy().astype(np.int64),
                                  np.stack([_i64(o) for o in outs]))
