"""The port's tower, point and map-to-curve layers (tower.py, points.py,
h2c.py) at small batch against the JAX package's pure-Python oracle (the
reference its own device tests are held to), on the plain kernel versions."""

import random

import pytest
import torch

# The plain versions run many small ops: one intra-op thread per process, so
# test processes side by side (pytest-xdist) do not oversubscribe the cores.
torch.set_num_threads(1)

from lighthouse_tpu.crypto.bls import curve as OC
from lighthouse_tpu.crypto.bls import fields as O
from lighthouse_tpu.crypto.bls import params
from lighthouse_tpu.crypto.bls.endo import psi as o_psi
from lighthouse_tpu.crypto.bls.hash_to_curve import hash_to_field_fp2, hash_to_g2
from lighthouse_tpu_torch.crypto.bls import fields as PF
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F
from lighthouse_tpu_torch.crypto.bls.torch_backend import h2c
from lighthouse_tpu_torch.crypto.bls.torch_backend import points as P
from lighthouse_tpu_torch.crypto.bls.torch_backend import tower as T

B = 3


def _rand_fp12(rng):
    return O.Fp12(*(O.Fp6(*(O.Fp2(rng.randrange(params.P), rng.randrange(params.P))
                            for _ in range(3))) for _ in range(2)))


def _to_port(v):
    """Oracle (JAX package) field value -> the port's oracle class."""
    if isinstance(v, O.Fp2):
        return PF.Fp2(v.c0, v.c1)
    if isinstance(v, O.Fp6):
        return PF.Fp6(*(_to_port(c) for c in (v.c0, v.c1, v.c2)))
    return PF.Fp12(_to_port(v.c0), _to_port(v.c1))


def _key(v):
    if isinstance(v, (O.Fp2, PF.Fp2)):
        return (v.c0, v.c1)
    if isinstance(v, (O.Fp6, PF.Fp6)):
        return tuple(_key(c) for c in (v.c0, v.c1, v.c2))
    return (_key(v.c0), _key(v.c1))


def _enc12(vals):
    return T.fp12_encode([_to_port(v) for v in vals], "cpu")


_FP12_OPS = {
    "mul": (lambda a, b: T.fp12_mul(a, b), lambda a, b: a * b),
    "sqr": (lambda a, b: T.fp12_sqr(a), lambda a, b: a.square()),
    "inv": (lambda a, b: T.fp12_inv(a), lambda a, b: a.inv()),
    "conj": (lambda a, b: T.fp12_conj(a), lambda a, b: a.conjugate()),
    "frobenius": (lambda a, b: T.fp12_frobenius(a), lambda a, b: a.frobenius()),
    "frobenius2": (lambda a, b: T.fp12_frobenius_n(a, 2), lambda a, b: a.frobenius_n(2)),
    "pow": (lambda a, b: T.fp12_pow(a, 0b1101001), lambda a, b: a.pow(0b1101001)),
    "mul_by_023": (
        lambda a, b: T.fp12_mul_by_023(a, b[0][0], b[0][2], b[1][0]),
        lambda a, b: a.mul_by_023(b.c0.c0, b.c0.c2, b.c1.c0)),
}


@pytest.mark.parametrize("op", sorted(_FP12_OPS))
def test_fp12_op_matches_oracle(op):
    rng = random.Random(op)
    a = [_rand_fp12(rng) for _ in range(B)]
    b = [_rand_fp12(rng) for _ in range(B)]
    port_fn, oracle_fn = _FP12_OPS[op]
    got = T.fp12_decode(port_fn(_enc12(a), _enc12(b)))
    assert [_key(g) for g in got] == [_key(oracle_fn(x, y)) for x, y in zip(a, b)]


def test_gt_product_and_is_one():
    from lighthouse_tpu_torch.crypto.bls.torch_backend import pairing as TP

    rng = random.Random(9)
    a = [_rand_fp12(rng) for _ in range(3)]
    prod = T.fp12_decode(TP.gt_product(_enc12(a)))[0]
    assert _key(prod) == _key(a[0] * a[1] * a[2])
    flags = T.fp12_is_one(_enc12([O.Fp12.one(), a[0]]))
    assert flags.tolist() == [True, False]


def _g2_points(rng, n):
    return [OC.affine_mul(OC.G2_GENERATOR, rng.randrange(1, params.R), O.Fp2) for _ in range(n)]


def _g2_port(points):
    return P.g2_encode([(_to_port(x), _to_port(y)) for x, y in points], "cpu")


def _non_subgroup_point(rng):
    """A point of E2(Fp2) outside G2 (almost every random point)."""
    while True:
        x = O.Fp2(rng.randrange(params.P), rng.randrange(params.P))
        y = (x.square() * x + OC.B2).sqrt()
        if y is not None and not OC.g2_subgroup_check((x, y)):
            return (x, y)


def test_g2_subgroup_check_valid_and_outside():
    rng = random.Random(4)
    pts = _g2_points(rng, 2) + [_non_subgroup_point(rng)]
    assert P.g2_subgroup_check(_g2_port(pts)).tolist() == [True, True, False]


def _jac_to_oracle(p):
    return [None if q is None else (O.Fp2(q[0].c0, q[0].c1), O.Fp2(q[1].c0, q[1].c1))
            for q in P.g2_decode_jac(p)]


def test_scalar_mul_bits_per_lane_and_shared():
    rng = random.Random(5)
    pts = _g2_points(rng, B)
    ks = [rng.getrandbits(64) | 1 for _ in range(B)]
    bits = torch.tensor([[(k >> (63 - i)) & 1 for k in ks] for i in range(64)], dtype=torch.int32)
    base = P.from_affine(P.FP2_OPS, _g2_port(pts))
    got = _jac_to_oracle(P.scalar_mul_bits(P.FP2_OPS, base, bits))
    assert got == [OC.affine_mul(p, k, O.Fp2) for p, k in zip(pts, ks)]
    shared = P.scalar_mul_bits(P.FP2_OPS, base, P.X_ABS_BITS)
    assert _jac_to_oracle(shared) == [OC.affine_mul(p, abs(params.X), O.Fp2) for p in pts]


def test_to_affine_g1_and_psi():
    rng = random.Random(6)
    pts = [OC.affine_mul(OC.G1_GENERATOR, rng.randrange(1, params.R), O.Fp) for _ in range(B)]
    g1 = P.g1_encode([(PF.Fp(x.v), PF.Fp(y.v)) for x, y in pts], "cpu")
    doubled = P.jac_double(P.FP_OPS, P.from_affine(P.FP_OPS, g1))
    x, y = P.to_affine(P.FP_OPS, doubled, F.fp_inv)
    want = [OC.affine_add(p, p, O.Fp) for p in pts]
    assert list(zip(F.decode_mont(x), F.decode_mont(y))) == [(p[0].v, p[1].v) for p in want]
    g2 = _g2_points(rng, 2)
    px, py = P.psi_affine(_g2_port(g2))
    got = [(_key(a), _key(b)) for a, b in zip(T.fp2_decode(px), T.fp2_decode(py))]
    assert got == [(_key(q[0]), _key(q[1])) for q in map(o_psi, g2)]


def test_complete_add_doubles_and_cancels():
    rng = random.Random(8)
    p, q = _g2_points(rng, 2)
    neg_p = (p[0], -p[1])
    a = P.from_affine(P.FP2_OPS, _g2_port([p, p, p]))
    b = P.from_affine(P.FP2_OPS, _g2_port([q, p, neg_p]))
    got = _jac_to_oracle(P.jac_add(P.FP2_OPS, a, b))
    assert got == [OC.affine_add(p, q, O.Fp2), OC.affine_add(p, p, O.Fp2), None]


def test_map_to_g2_matches_host_hash_to_curve():
    msgs = [b"\x01" * 32, b"lighthouse"]
    us = [hash_to_field_fp2(m, 2) for m in msgs]
    u0 = T.fp2_encode([_to_port(u[0]) for u in us], "cpu")
    u1 = T.fp2_encode([_to_port(u[1]) for u in us], "cpu")
    hx, hy = h2c.map_to_g2(u0, u1)
    got = [(_key(a), _key(b)) for a, b in zip(T.fp2_decode(hx), T.fp2_decode(hy))]
    assert got == [(_key(h[0]), _key(h[1])) for h in map(hash_to_g2, msgs)]
