"""The triangle square and kernels 4 and 5 (torch_backend/chain_kernel.py).

Fast tier:
* ``mont_sqr_plain`` against the JAX package's ``pallas_fp._mont_sqr_core``
  (jitted), byte for byte, on strict, lazy and all-QMAX limbs;
* the full p-2 and (p^2+7)/16 chains (plain versions) against host ``pow``
  and the oracle's ``Fp2.pow``, by canonical value, and the arm's routing of
  ``fp.fp_inv`` and ``h2c.fp2_pow_static`` through them;
* ``csrc/chain.cu`` compiled for the host with g++, lane by lane against
  the plain versions: the group chains (kernels 4 and 5) with each phase's
  ranks run up and down, and the group triangle square alone against
  ``mont_sqr_plain`` and the JAX ``_mont_sqr_core``;
* the triangle square's column sums below 2^21 at QMAX limbs.

Slow tier: the plain versions byte for byte against the reference's own
Pallas chain kernels run in interpret mode (one interpret compile each).
"""

import random
import re

import numpy as np
import pytest
import torch
import torch_host_cuda as host_cuda

# The plain versions run many small ops: one intra-op thread per process, so
# test processes side by side (pytest-xdist) do not oversubscribe the cores.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lighthouse_tpu.crypto.bls.fields import Fp2 as OFp2  # noqa: E402
from lighthouse_tpu.crypto.bls.jax_backend import pallas_fp as PF  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import chain_kernel as CK  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import h2c  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import mont_kernel as MK  # noqa: E402

P = F.P_INT


def _limbs(kind: str, n: int, seed: int) -> torch.Tensor:
    """(26, n) int32 limbs: strict values below P, lazy values (bound 4,
    the largest the Fp chain takes without a reduction) or every limb at
    QMAX."""
    rng = random.Random(seed)
    if kind == "qmax":
        return torch.full((F.N, n), F.QMAX, dtype=torch.int32)
    a = F.lfp_encode([rng.randrange(P) for _ in range(n)], "cpu")
    if kind == "strict":
        return a.limbs
    b = F.lfp_encode([rng.randrange(P) for _ in range(n)], "cpu")
    lazy = F.fp_add(F.fp_sub(b, a), a)  # bound 1 + 2 + 1
    assert lazy.bound <= 4.0
    return lazy.limbs.contiguous()


def _mont_ints(limbs) -> list:
    return F.decode_mont(limbs)


@pytest.fixture(scope="module")
def jax_sqr():
    """The reference's triangle square, jitted once for (26, 128) operands."""
    consts = [jnp.broadcast_to(jnp.asarray(c, jnp.uint32), (26, 128))
              for c in (PF._P_COLS, PF._PP_COLS)]
    fn = jax.jit(PF._mont_sqr_core)
    return lambda a: np.asarray(fn(jnp.asarray(a.numpy().astype(np.uint32)), *consts))


@pytest.mark.parametrize("kind", ["strict", "lazy", "qmax"])
def test_mont_sqr_plain_matches_jax_triangle_square(jax_sqr, kind):
    a = _limbs(kind, 128, seed=len(kind))
    got = MK.mont_sqr_plain(a)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), jax_sqr(a).astype(np.int64))


def test_fp_chain_plain_full_exponent_matches_host_pow():
    """The Fermat p-2 chain (96 digits), strict and lazy bases."""
    e = P - 2
    assert len(CK.window_digits(bin(e)[2:])) == 96
    for kind in ("strict", "lazy"):
        a = _limbs(kind, 2, seed=11)
        got = CK.pow_chain(a, e)
        assert _mont_ints(got) == [pow(x, e, P) for x in _mont_ints(a)]


def test_fp2_chain_plain_full_exponent_matches_oracle():
    """The (p^2+7)/16 square-root chain (190 digits) on reduced inputs."""
    rng = random.Random(12)
    c0 = [rng.randrange(P) for _ in range(2)]
    c1 = [rng.randrange(P) for _ in range(2)]
    a0, a1 = F.lfp_encode(c0, "cpu"), F.lfp_encode(c1, "cpu")
    assert len(CK.window_digits("".join(map(str, h2c.SQRT_EXP_BITS)))) == 190
    r0, r1 = CK.fp2_pow_chain(a0.limbs, a1.limbs, h2c.SQRT_EXP_BITS)
    got = [(x % P, y % P) for x, y in zip(_mont_ints(r0), _mont_ints(r1))]
    want = [OFp2(x, y).pow(h2c.SQRT_EXP) for x, y in zip(c0, c1)]
    assert got == [(w.c0, w.c1) for w in want]


@pytest.fixture
def chains_on():
    F.set_chains(True)
    yield
    F.set_chains(False)


def test_arm_routes_fp_inv_and_fp2_pow_static(chains_on, monkeypatch):
    """Under the arm fp_inv and fp2_pow_static go through the chain wrappers,
    with the reference's output labels, and give the default arm's values."""
    calls = {"fp": 0, "fp2": 0}
    pow_chain, fp2_pow_chain = CK.pow_chain, CK.fp2_pow_chain

    def spy_fp(*a):
        calls["fp"] += 1
        return pow_chain(*a)

    def spy_fp2(*a):
        calls["fp2"] += 1
        return fp2_pow_chain(*a)

    monkeypatch.setattr(CK, "pow_chain", spy_fp)
    monkeypatch.setattr(CK, "fp2_pow_chain", spy_fp2)
    rng = random.Random(13)
    a = F.fp_add(F.lfp_encode([rng.randrange(1, P) for _ in range(3)], "cpu"),
                 F.lfp_encode([rng.randrange(P) for _ in range(3)], "cpu"))
    inv = F.fp_inv(a)
    assert inv.bound == F.POW_FIX
    assert _mont_ints(inv.limbs) == [pow(x, P - 2, P) for x in _mont_ints(a.limbs)]
    x = (F.lfp_encode([rng.randrange(P) for _ in range(2)], "cpu"),
         F.lfp_encode([rng.randrange(P) for _ in range(2)], "cpu"))
    bits = [1, 0, 1, 1, 0, 1]
    arm = h2c.fp2_pow_static(x, bits)
    assert calls == {"fp": 1, "fp2": 1}
    assert arm[0].bound == arm[1].bound == 2.0
    F.set_chains(False)
    default = h2c.fp2_pow_static(x, bits)
    assert [F.limbs_to_ints(F.fp_canon(c)) for c in arm] == [
        F.limbs_to_ints(F.fp_canon(c)) for c in default]
    # short exponents keep the square-and-multiply path, as in the reference
    F.set_chains(True)
    h2c.fp2_pow_static(x, [1, 1, 1])
    F.fp_pow(a, 3)
    assert calls == {"fp": 1, "fp2": 1}


_HARNESS = r"""
#define FP_CHAIN(L) (fp_chain_group_kernel<L>(tape, nd, b, o, n))
#define FP2_CHAIN(L) (fp2_chain_group_kernel<L>(tape, nd, a0, a1, o0, o1, n))
extern "C" void host_fp_chain(const int32_t* tape, int nd, const uint32_t* b, uint32_t* o,
                              int n, int down) {
  lh::host_ranks_down = down;
  EACH_LANE(FP_CHAIN(16))
}
extern "C" void host_fp2_chain(const int32_t* tape, int nd, const uint32_t* a0,
                               const uint32_t* a1, uint32_t* o0, uint32_t* o1, int n, int down) {
  lh::host_ranks_down = down;
  EACH_LANE(FP2_CHAIN(kFp2Lanes))
}
// The column sums of t before the carry passes, as mont_group_sqr_core
// (square) or mont_group_core(a, a) formed and left them.
extern "C" void host_t_cols(const uint32_t* a, uint32_t* cols, int n, int square, int down) {
  lh::host_ranks_down = down;
  for (int l = 0; l < n; ++l) {
    uint32_t sm[2 * NP + kWorkWords + 2 * NP];
    const Arena<8> ar{sm};
    uint32_t* const pp = sm + 2 * NP + kWorkWords;
    const Group<8> g{ar, ar.work(2 * NP), pp, pp + NP};
    g.setup(2, [&](int r) {
      for (int i = r; i < NL; i += kG) ar.arr(0)(i) = a[i * n + l];
    });
    const auto none = [](int) {};
    if (square) {
      lh::coop::mont_group_sqr_core<kG, 8>(ar.arr(0), g.w, pp, pp + NP, ar.arr(1), true, none,
                                           none);
    } else {
      lh::coop::mont_group_core<kG, 8>(ar.arr(0), ar.arr(0), g.w, pp, pp + NP, ar.arr(1), true,
                                       none, none);
    }
    for (int k = 0; k < NW; ++k) cols[k * n + l] = g.w.tsums(k);
  }
}
// The group triangle square alone: a into a lane's shared array, its square
// by the 16 ranks, the result stored.
extern "C" void host_sqr(const uint32_t* a, uint32_t* o, int n, int down) {
  lh::host_ranks_down = down;
  for (int l = 0; l < n; ++l) {
    uint32_t sm[2 * NP + kWorkWords + 2 * NP];
    const Arena<8> ar{sm};
    uint32_t* const pp = sm + 2 * NP + kWorkWords;
    const Group<8> g{ar, ar.work(2 * NP), pp, pp + NP};
    g.setup(2, [&](int r) {
      for (int i = r; i < NL; i += kG) ar.arr(0)(i) = a[i * n + l];
    });
    g.sqr(ar.arr(1), ar.arr(0));
    g.store(o, n, l, true, ar.arr(1));
  }
}
"""


@pytest.fixture(scope="module")
def host_chain(tmp_path_factory):
    return host_cuda.build(tmp_path_factory.mktemp("hostchain"), "chain", _HARNESS)


def _tape(bits: str) -> torch.Tensor:
    return torch.tensor(CK.window_digits(bits), dtype=torch.int32)


# (exponent, Fp2 bits): the full chains, and short ones whose digits hold a
# 0 (3, 0, 5 and 2, 0, 5)
_FP_EXPONENTS = (P - 2, 0x305)
_FP2_BITS = (tuple(h2c.SQRT_EXP_BITS), (1, 0, 0, 0, 0, 0, 0, 1, 0, 1))


def test_host_compiled_chains_match_plain(host_chain):
    """csrc/chain.cu's group chains (kernels 4 and 5, 16 threads per lane),
    run lane by lane on the host with each phase's ranks up and then down,
    give the plain versions' limbs: the p-2 chain and a short exponent with a
    0 digit on strict, lazy (bound 4) and all-QMAX bases; the Fp2 square-root
    chain and a short one with a 0 digit on strict elements.  On the host a
    block holds one lane, so the Fp chain's forms (FP_FORMS, which differ
    only in lanes per block) build the same code here and one of them runs;
    the card test test_cuda_group_chains_match_plain_versions and
    chip_smoke.py hold each form."""
    ptr = host_cuda.ptr
    for down in (0, 1):
        for e in _FP_EXPONENTS:
            tape = _tape(bin(e)[2:])
            for kind in ("strict", "lazy", "qmax"):
                a = _limbs(kind, 3, seed=14)
                want = CK.pow_chain_plain(a, e)
                out = torch.empty_like(a)
                host_chain.host_fp_chain(ptr(tape), len(tape), ptr(a), ptr(out), 3, down)
                assert torch.equal(out, want), (hex(e), kind, down)
        for bits in _FP2_BITS:
            tape = _tape("".join(map(str, bits)))
            a0, a1 = _limbs("strict", 2, seed=15), _limbs("strict", 2, seed=16)
            o0, o1 = torch.empty_like(a0), torch.empty_like(a1)
            host_chain.host_fp2_chain(ptr(tape), len(tape), ptr(a0), ptr(a1), ptr(o0), ptr(o1),
                                      2, down)
            r0, r1 = CK.fp2_pow_chain_plain(a0, a1, bits)
            assert torch.equal(o0, r0) and torch.equal(o1, r1), (len(bits), down)


@pytest.mark.parametrize("kind", ["strict", "lazy", "qmax"])
def test_host_group_square_matches_plain_and_jax(host_chain, jax_sqr, kind):
    """The group triangle square (mont_coop.cuh mont_group_sqr_core) alone,
    ranks run up and down, on the cases of
    test_mont_sqr_plain_matches_jax_triangle_square: byte-equal to
    mont_sqr_plain and to the reference's _mont_sqr_core."""
    a = _limbs(kind, 128, seed=len(kind))
    want = MK.mont_sqr_plain(a)
    np.testing.assert_array_equal(want.numpy().astype(np.int64), jax_sqr(a).astype(np.int64))
    for down in (0, 1):
        out = torch.empty_like(a)
        host_chain.host_sqr(host_cuda.ptr(a), host_cuda.ptr(out), 128, down)
        assert torch.equal(out, want), down


def _raw_columns(a: torch.Tensor, square: bool) -> torch.Tensor:
    """(52, n) column sums of t before the carry passes: every product
    a_i * a_j split into lo (column i + j) and hi (i + j + 1); with
    ``square`` the j >= i triangle, cross products doubled before the split
    (pallas_fp._wide_square)."""
    x = a.long()
    cols = torch.zeros((2 * F.N + 1, x.shape[1]), dtype=torch.int64)
    for i in range(F.N):
        for j in range(i if square else 0, F.N):
            p = x[i] * x[j] * (2 if square and j > i else 1)
            cols[i + j] += p & F.MASK
            cols[i + j + 1] += p >> F.BITS
    return cols[:2 * F.N]


# Limbs 0 and 1 chosen (the rest zero) so that the triangle square's t and
# the product a * a's t still differ after both carry passes: limbs 3 and 4
# hold 2^15 and v in one, 0 and v + 1 in the other.
_PINNED = (32769, 32767) + (0,) * (F.N - 2)


def test_group_square_follows_the_triangle_not_the_product(host_chain):
    """mont_group_sqr_core forms _wide_square's column sums for t, not those
    of the product a * a (mont_group_core(a, a)), ranks run up and down, on strict, lazy and
    all-QMAX limbs and on _PINNED, where the two t's differ even after both
    carry passes.  A square whose t phase is swapped for the product's fails
    here.
    (No input was found on which the final limbs differ: mont_sqr_plain(a)
    and mont_mul_plain(a, a) agree on _PINNED and on every input tried.)"""
    pinned = torch.tensor(_PINNED, dtype=torch.int32)[:, None]
    x = pinned.long()
    assert not torch.equal(MK._wide_square(x), MK._wide_product(x, x))
    ptr = host_cuda.ptr
    for a in (pinned, _limbs("strict", 4, 21), _limbs("lazy", 4, 22), _limbs("qmax", 2, 0)):
        a = a.contiguous()
        n = a.shape[1]
        want = {1: _raw_columns(a, True), 0: _raw_columns(a, False)}
        assert not torch.equal(want[0], want[1])
        for square in (1, 0):
            for down in (0, 1):
                cols = torch.empty((2 * F.N, n), dtype=torch.int32)
                host_chain.host_t_cols(ptr(a), ptr(cols), n, square, down)
                assert torch.equal(cols.long(), want[square]), (square, down)


def test_triangle_square_column_sums_stay_exact():
    """The square's t columns before the carry passes, each lo half at its
    most (MASK) and each hi half at its most for QMAX limbs: a doubled cross
    product fits 32 bits, and every column sum stays below 2^21, as mont.cuh
    states for the product, so the ranks' shared atomics add them exactly."""
    q = F.QMAX
    assert 2 * q * q < 1 << 32
    cols = [0] * (2 * F.N + 1)
    for i in range(F.N):
        for j in range(i, F.N):
            cols[i + j] += F.MASK
            cols[i + j + 1] += (q * q * (2 if j > i else 1)) >> F.BITS
    assert max(cols) == 1_284_608 < 1 << 21


def test_group_chain_launcher_asserts_the_shared_limit():
    """The group chains' launcher checks each form's dynamic shared memory
    against the one limit the Miller launchers use (nvcc evaluates it), and
    launches only the forms chain_kernel lists: FP_FORMS for the Fp chain,
    FP2_FORM for the Fp2 chain."""
    from lighthouse_tpu_torch.crypto.bls.torch_backend import codegen

    src = (host_cuda._build.CSRC / "chain.cu").read_text()
    assert f"static_assert(kShared <= {codegen.SHARED_LIMIT}," in src
    assert all(g == 16 for g, _ in CK.FP_FORMS + (CK.FP2_FORM,))
    assert sorted(int(x) for x in re.findall(r"case (\d+):", src)) == sorted(
        lanes for _, lanes in CK.FP_FORMS)
    assert f"constexpr int kFp2Lanes = {CK.FP2_FORM[1]};" in src
    assert re.findall(r"launch_group<(\w+),", src) == ["8", "16", "kFp2Lanes"]


def test_chain_counts_and_operand_checks():
    assert CK.products_per_lane(96)["fp"] == {"mul": 14 + 95, "sqr": 4 * 95}
    assert CK.products_per_lane(190)["fp2"] == {"mul": 3 * 14 + 189 * 11, "sqr": 0}
    a = torch.zeros((F.N, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        CK.pow_chain(a.long(), 5)
    with pytest.raises(ValueError):
        CK.pow_chain(a[:, :2].t().contiguous(), 5)
    with pytest.raises(ValueError):
        CK.fp2_pow_chain(a, a, [0, 1, 1])
    with pytest.raises(ValueError):
        CK.fp2_pow_chain(a, a[:, :2].contiguous(), [1, 1])
    with pytest.raises(ValueError):
        CK.pow_chain(a, 5, form=(16, 32))
    assert CK.form_for(1) == CK.form_for(3072) == (16, 8)
    assert CK.form_for(3073) == CK.form_for(4096) == (16, 16)
    assert all(CK.form_for(n) in CK.FP_FORMS for n in (1, 1024, 1025, 1 << 20))


@pytest.mark.slow
def test_fp_chain_plain_matches_pallas_interpret():
    """pallas_fp.pow_chain_limbs in interpret mode (digits 3, 0, 5: the
    table, a 0 digit and the triangle squares) on 128 lanes."""
    a = _limbs("strict", 128, seed=17)
    want = np.asarray(PF.pow_chain_limbs(jnp.asarray(a.numpy().astype(np.uint32)), 0x305,
                                         interpret=True, mxu=False))
    np.testing.assert_array_equal(CK.pow_chain_plain(a, 0x305).numpy().astype(np.int64),
                                  want.astype(np.int64))


@pytest.mark.slow
def test_fp2_chain_plain_matches_pallas_interpret():
    """pallas_fp.fp2_pow_chain in interpret mode (digits 2, 0, 5: the table,
    a 0 digit and the Fp2 square core) on 128 lanes."""
    a0, a1 = _limbs("strict", 128, seed=18), _limbs("strict", 128, seed=19)
    bits = (1, 0, 0, 0, 0, 0, 0, 1, 0, 1)
    w0, w1 = PF.fp2_pow_chain(jnp.asarray(a0.numpy().astype(np.uint32)),
                              jnp.asarray(a1.numpy().astype(np.uint32)), bits,
                              interpret=True, mxu=False)
    r0, r1 = CK.fp2_pow_chain_plain(a0, a1, bits)
    np.testing.assert_array_equal(r0.numpy().astype(np.int64), np.asarray(w0).astype(np.int64))
    np.testing.assert_array_equal(r1.numpy().astype(np.int64), np.asarray(w1).astype(np.int64))
