"""The port's base field (torch_backend/fp.py, mont_kernel.py) against the
JAX package's: the plain Montgomery product must give the JAX package's
limbs exactly (scan path and Pallas kernel in interpret mode), the glue ops
the same limbs, and every re-derived constant table the same integers."""

import random

import numpy as np
import pytest
import torch

# The plain versions run many small ops: one intra-op thread per process, so
# test processes side by side (pytest-xdist) do not oversubscribe the cores.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lighthouse_tpu.crypto.bls import endo as jendo  # noqa: E402
from lighthouse_tpu.crypto.bls import fields as jfields  # noqa: E402
from lighthouse_tpu.crypto.bls.jax_backend import backend as JB  # noqa: E402
from lighthouse_tpu.crypto.bls.jax_backend import fp as JF  # noqa: E402
from lighthouse_tpu.crypto.bls.jax_backend import h2c as JH  # noqa: E402
from lighthouse_tpu.crypto.bls.jax_backend import pallas_fp as PF  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import convert  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import mont_kernel as MK  # noqa: E402


def _pair(values, bound=1.0):
    """The same limbs as a JAX LFp and a port LFp (CPU)."""
    limbs = JF.ints_to_limbs(values)
    return (JF.LFp(jnp.asarray(limbs), bound),
            F.LFp(torch.as_tensor(limbs.astype(np.int32)), bound))


def _corpus(kind: str, n: int, seed: int):
    """(x, y) operand pairs, each as (jax LFp, port LFp): strict values,
    lazy add/sub/neg outputs, or every limb at QMAX."""
    rng = random.Random(seed)
    if kind == "qmax":
        limbs = np.full((JF.N, n), JF.QMAX, dtype=np.uint32)
        q = (JF.LFp(jnp.asarray(limbs), 1.0),
             F.LFp(torch.as_tensor(limbs.astype(np.int32)), 1.0))
        return [(q, q)]
    a = _pair([rng.randrange(JF.P_INT) for _ in range(n)])
    b = _pair([rng.randrange(JF.P_INT) for _ in range(n)])
    if kind == "strict":
        return [(a, b)]
    s = (JF.fp_add(a[0], a[0]), F.fp_add(a[1], a[1]))
    t = (JF.fp_sub(b[0], a[0]), F.fp_sub(b[1], a[1]))
    d = (JF.fp_neg(t[0]), F.fp_neg(t[1]))
    return [(s, t), (t, d), ((JF.fp_dbl(s[0]), F.fp_dbl(s[1])), b)]


def _ints(x) -> list:
    if isinstance(x, torch.Tensor):
        return F.limbs_to_ints(x)
    return JF.limbs_to_ints(np.asarray(x))


@pytest.mark.parametrize("n", [1, 5, 128, 131])
@pytest.mark.parametrize("kind", ["strict", "lazy", "qmax"])
def test_plain_mont_mul_matches_jax_scan(kind, n):
    for (jx, tx), (jy, ty) in _corpus(kind, n, seed=n * 7 + len(kind)):
        assert tx.bound == jx.bound and ty.bound == jy.bound
        ref = JF.mont_mul(jx, jy)
        got = MK.mont_mul(tx.limbs.contiguous(), ty.limbs.contiguous())
        assert _ints(got) == _ints(ref.limbs)
        assert F.mont_mul(tx, ty).bound == ref.bound


@pytest.mark.parametrize("kind", ["strict", "lazy", "qmax"])
def test_plain_mont_mul_matches_pallas_interpret(kind):
    for (jx, tx), (jy, ty) in _corpus(kind, 5, seed=99):
        ref = PF.mont_mul_limbs(jx.limbs, jy.limbs, interpret=True)
        got = MK.mont_mul_plain(tx.limbs.contiguous(), ty.limbs.contiguous())
        assert _ints(got) == _ints(ref)


def test_mont_mul_wrapper_checks_its_operands():
    a = torch.zeros((F.N, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        MK.mont_mul(a.long(), a.long())
    with pytest.raises(ValueError):
        MK.mont_mul(a, a[:, :3].contiguous())
    with pytest.raises(ValueError):
        MK.mont_mul(a.t().contiguous().t(), a)
    before = MK.launches
    MK.mont_mul(a, a)  # CPU tensors: the plain version, no launch counted
    assert MK.launches == before


_GLUE = {
    "add": (JF.fp_add, F.fp_add),
    "sub": (JF.fp_sub, F.fp_sub),
    "neg": (lambda a, b: JF.fp_neg(b), lambda a, b: F.fp_neg(b)),
    "dbl": (lambda a, b: JF.fp_dbl(a), lambda a, b: F.fp_dbl(a)),
    "sub_lazy": (lambda a, b: JF.fp_sub(a, JF.fp_add(b, b)),
                 lambda a, b: F.fp_sub(a, F.fp_add(b, b))),
    "reduce": (lambda a, b: JF.fp_reduce(JF.fp_add(a, b)),
               lambda a, b: F.fp_reduce(F.fp_add(a, b))),
}


@pytest.mark.parametrize("op", sorted(_GLUE))
def test_glue_ops_match_jax_limbs_and_bounds(op):
    rng = random.Random(op)
    a = _pair([rng.randrange(2 * JF.P_INT) for _ in range(7)], 2.0)
    b = _pair([rng.randrange(2 * JF.P_INT) for _ in range(7)], 2.0)
    jfn, tfn = _GLUE[op]
    ref, got = jfn(a[0], b[0]), tfn(a[1], b[1])
    assert got.bound == ref.bound
    assert _ints(got.limbs) == _ints(ref.limbs)


@pytest.mark.parametrize("bound", [1.0, 2.0, 4.3, 40.0, 250.0])
def test_canon_eq_is_zero_match_jax(bound):
    rng = random.Random(int(bound * 10))
    vals = [rng.randrange(int(bound * JF.P_INT)) for _ in range(6)]
    vals[0] = 0
    vals[1] = JF.P_INT  # == 0 mod P
    j, t = _pair(vals, bound)
    assert _ints(F.fp_canon(t)) == _ints(JF.fp_canon(j))
    assert F.fp_is_zero(t).tolist() == np.asarray(JF.fp_is_zero(j)).tolist()
    jb, tb = _pair([v % JF.P_INT for v in vals], 1.0)
    assert F.fp_eq(t, tb).all()
    assert np.asarray(JF.fp_eq(j, jb)).all()


def test_full_and_sub_chain_match_sequential_carries():
    rng = random.Random(5)
    cols = torch.tensor([[rng.randrange(1 << 17) for _ in range(9)] for _ in range(52)])
    ref = JF.full_chain(jnp.asarray(cols.numpy().astype(np.uint32)))
    assert F.full_chain(cols).numpy().tolist() == np.asarray(ref).tolist()
    x = torch.as_tensor(F.ints_to_limbs([rng.randrange(2 * F.P_INT) for _ in range(9)]))
    y = torch.as_tensor(F.ints_to_limbs([rng.randrange(2 * F.P_INT) for _ in range(9)]))
    d_ref, b_ref = JF.sub_chain(jnp.asarray(x.numpy().astype(np.uint32)),
                                jnp.asarray(y.numpy().astype(np.uint32)))
    d, b = F.sub_chain(x, y)
    assert d.numpy().tolist() == np.asarray(d_ref).tolist()
    assert b.numpy().astype(int).tolist() == np.asarray(b_ref).astype(int).tolist()


def test_fp_inv_and_pow_match_jax():
    rng = random.Random(11)
    j, t = _pair([rng.randrange(JF.P_INT) for _ in range(3)] + [0])
    assert _ints(F.fp_inv(t).limbs) == _ints(JF.fp_inv(j).limbs)
    assert _ints(F.fp_pow(t, 0b1011001).limbs) == _ints(JF.fp_pow(j, 0b1011001).limbs)
    inv = F.decode_mont(F.fp_inv(t))
    for x, y in zip(F.decode_mont(t), inv):
        assert x * y % F.P_INT == (1 if x else 0)


def test_codecs_round_trip_and_match_jax():
    rng = random.Random(3)
    xs = [rng.randrange(F.P_INT) for _ in range(17)] + [0, F.P_INT - 1]
    assert F.encode_mont(xs).tolist() == JF.encode_mont(xs).astype(np.int64).tolist()
    assert F.decode_mont(F.lfp_encode(xs, "cpu")) == xs
    assert F.limbs_to_ints(F.ints_to_limbs(xs)) == xs


_PORT_TABLES = convert.port_constants()
_JAX_TABLES = convert.constants_from_jax(JF, jfields, jendo, JH, JB)


@pytest.mark.parametrize("name", sorted(_PORT_TABLES))
def test_constant_table_matches_jax(name):
    assert set(_PORT_TABLES) == set(_JAX_TABLES)
    assert np.array_equal(_PORT_TABLES[name], _JAX_TABLES[name]), name


def test_bias_selection_matches_jax():
    for bound in (0.5, 1.0, 1.1, 2.0, 2.5, 4.3, 7.9, 16.0, 31.0, 64.0, 120.0, 250.0):
        assert F._k_for(bound) == JF._k_for(bound)
