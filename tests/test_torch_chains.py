"""The triangle square and kernels 4 and 5 (torch_backend/chain_kernel.py).

Fast tier:
* ``mont_sqr_plain`` against the JAX package's ``pallas_fp._mont_sqr_core``
  (jitted), byte for byte, on strict, lazy and all-QMAX limbs;
* the full p-2 and (p^2+7)/16 chains (plain versions) against host ``pow``
  and the oracle's ``Fp2.pow``, by canonical value, and the arm's routing of
  ``fp.fp_inv`` and ``h2c.fp2_pow_static`` through them;
* ``csrc/chain.cu`` compiled for the host with g++, lane by lane against
  the plain versions.

Slow tier: the plain versions byte for byte against the reference's own
Pallas chain kernels run in interpret mode (one interpret compile each).
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
extern "C" void host_fp_chain(const int32_t* tape, int nd, const uint32_t* b, uint32_t* o,
                              int n) {
  EACH_LANE(fp_chain_kernel(tape, nd, b, o, n))
}
extern "C" void host_fp2_chain(const int32_t* tape, int nd, const uint32_t* a0,
                               const uint32_t* a1, uint32_t* o0, uint32_t* o1, int n) {
  EACH_LANE(fp2_chain_kernel(tape, nd, a0, a1, o0, o1, n))
}
"""


@pytest.fixture(scope="module")
def host_chain(tmp_path_factory):
    return host_cuda.build(tmp_path_factory.mktemp("hostchain"), "chain", _HARNESS)


def test_host_compiled_chains_match_plain(host_chain):
    """csrc/chain.cu's kernels, run lane by lane on the host, give the plain
    versions' limbs: the p-2 chain on strict and lazy bases, the Fp2 square
    root chain, and a short exponent with 0 digits."""
    ptr = host_cuda.ptr
    for e in (P - 2, 0x305):
        tape = torch.tensor(CK.window_digits(bin(e)[2:]), dtype=torch.int32)
        for kind in ("strict", "lazy", "qmax"):
            a = _limbs(kind, 3, seed=14)
            out = torch.empty_like(a)
            host_chain.host_fp_chain(ptr(tape), len(tape), ptr(a), ptr(out), 3)
            assert torch.equal(out, CK.pow_chain_plain(a, e))
    for bits in (h2c.SQRT_EXP_BITS, [1, 0, 0, 0, 0, 0, 0, 1, 0, 1]):
        tape = torch.tensor(CK.window_digits("".join(map(str, bits))), dtype=torch.int32)
        a0, a1 = _limbs("strict", 2, seed=15), _limbs("strict", 2, seed=16)
        o0, o1 = torch.empty_like(a0), torch.empty_like(a1)
        host_chain.host_fp2_chain(ptr(tape), len(tape), ptr(a0), ptr(a1), ptr(o0), ptr(o1), 2)
        r0, r1 = CK.fp2_pow_chain_plain(a0, a1, bits)
        assert torch.equal(o0, r0) and torch.equal(o1, r1)


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
