"""The epoch batch program of TorchBackend (torch_backend/backend.py:
encode_committee_pubkeys, _segment_aggregate_g1, _epoch_verify_kernel,
epoch_program) against the JAX package.

* encode_committee_pubkeys leaf for leaf against the JAX package's;
* _segment_aggregate_g1's sums against the JAX function's and the host
  oracle's, on ragged committees;
* the reference's fault pinned: its _segment_aggregate_g1 drops the last
  position when ``positions`` is not a power of two (and its
  encode_committee_pubkeys the members past ``positions``); the port
  raises;
* the epoch program at B = 4, positions = 4 accepts the corpus of
  tests/test_epoch_attestation.py (CPU, the plain versions);
* slow: a corrupted member rejects, and the program against the JAX
  package's jitted _epoch_verify_kernel on the same operands.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from lighthouse_tpu.crypto.bls import api as japi  # noqa: E402
from lighthouse_tpu.crypto.bls.jax_backend import backend as JB  # noqa: E402
from lighthouse_tpu.crypto.bls.jax_backend import points as JP  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import api as tapi  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import params  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.curve import Fp, from_jacobian, jac_add, to_jacobian  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.hash_to_curve import hash_to_g2  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import backend as TB  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import convert  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import points as P  # noqa: E402

SIZES = [4, 1, 3, 2]


def _committees(api, sizes):
    pks = [api.SecretKey(500 + i).public_key().point for i in range(16)]
    return [[pks[(s * 3 + j) % 16] for j in range(size)] for s, size in enumerate(sizes)]


def _oracle_sum(points):
    acc = to_jacobian(None, Fp)
    for p in points:
        acc = jac_add(acc, to_jacobian(p, Fp), Fp)
    return from_jacobian(acc, Fp)


def _as_ints(point):
    return None if point is None else (int(point[0].v), int(point[1].v))


def _jax_segment_sums(enc, mask, positions):
    """The JAX package's _segment_aggregate_g1, jitted with ``positions``
    static and XLA's backend optimisation off (the same integer program;
    the CPU compile takes half as long), decoded to oracle points."""
    lowered = jax.jit(JB._segment_aggregate_g1, static_argnums=2).lower(enc, mask, positions)
    compiled = lowered.compile({"xla_backend_optimization_level": 0,
                                "xla_llvm_disable_expensive_passes": True})
    return JP.g1_decode_jac(compiled(enc, mask))


def test_encode_committee_pubkeys_matches_jax_leaf_by_leaf():
    (jx, jy), jmask = JB.encode_committee_pubkeys(_committees(japi, SIZES), 4)
    (tx, ty), tmask = TB.encode_committee_pubkeys(_committees(tapi, SIZES), 4)
    for t, j in ((tx, jx), (ty, jy)):
        assert t.bound == float(j.bound) == 1.0
        assert np.array_equal(t.limbs.numpy().astype(np.int64), np.asarray(j.limbs).astype(np.int64))
    assert tmask.dtype == torch.bool and tmask.tolist() == np.asarray(jmask).tolist()
    # position-major: lane pos * B + set
    assert tmask.tolist() == [pos >= size for pos in range(4) for size in SIZES]


def test_segment_aggregation_matches_jax_and_the_oracle():
    """Two levels of complete additions at 8 and 4 lanes; the JAX side
    jitted (unjitted, the tree compiles each op per shape on the CPU)."""
    committees = _committees(tapi, SIZES)
    enc, mask = TB.encode_committee_pubkeys(committees, 4)
    with torch.inference_mode():
        got = P.g1_decode_jac(TB._segment_aggregate_g1(enc, mask, 4))
    jenc, jmask = JB.encode_committee_pubkeys(_committees(japi, SIZES), 4)
    ref = _jax_segment_sums(jenc, jmask, 4)
    want = [_oracle_sum(c) for c in committees]
    assert got == want
    assert [_as_ints(p) for p in ref] == [_as_ints(p) for p in want]


def test_reference_drops_the_last_position_the_port_raises():
    """The reference's _segment_aggregate_g1 (jax_backend/backend.py:246-272)
    halves with n // 2: at positions = 3 a committee of three keys sums to
    the first two keys only, so a signature by two members would pass for
    the three (its encode_committee_pubkeys, :285-306, likewise drops the
    members past ``positions``).  The port refuses both.  The JAX side runs
    jitted (``positions`` static: the halving is the same Python either
    way; unjitted, each op compiles on its own and the call takes 14 s)."""
    three = _committees(japi, [3])
    enc, mask = JB.encode_committee_pubkeys(three, 3)
    (ref,) = _jax_segment_sums(enc, mask, 3)
    port_three = _committees(tapi, [3])[0]
    assert _as_ints(ref) == _as_ints(_oracle_sum(port_three[:2]))
    assert _as_ints(ref) != _as_ints(_oracle_sum(port_three))
    enc, mask = JB.encode_committee_pubkeys(_committees(japi, [5]), 4)
    assert np.asarray(mask).tolist() == [False] * 4  # the fifth member is gone
    tenc, tmask = TB.encode_committee_pubkeys([port_three], 4)
    for positions in (3, 6, 0):
        with pytest.raises(ValueError, match="power of two"):
            TB._segment_aggregate_g1(tenc, tmask[:positions] if positions else tmask, positions)
    with pytest.raises(ValueError, match="more than 4 members"):
        TB.encode_committee_pubkeys(_committees(tapi, [5]), 4)
    with pytest.raises(ValueError, match="power of two"):
        TB.TorchBackend(device="cpu").epoch_program(4, 3)


def _epoch_corpus(api, n_sets=4, committee=3, pool=8):
    """tools/epoch_attestation_bench.py's build_epoch_batch, in either
    package: committees of pooled keys, each set signed with the sum of its
    members' secret keys, the tool's fixed weights."""
    committees, sigs, msgs = [], [], []
    for s in range(n_sets):
        members = [(s * 7 + j * 3) % pool for j in range(committee)]
        committees.append([api.SecretKey(1000 + m).public_key().point for m in members])
        msg = s.to_bytes(8, "big") * 4
        sigs.append(api.SecretKey(sum(1000 + m for m in members) % params.R).sign(msg).point)
        msgs.append(msg)
    weights = [0x9E3779B97F4A7C15 ^ (i * 0x2545F4914F6CDD1D) or 1 for i in range(n_sets)]
    return committees, sigs, msgs, weights


def _epoch_operands(committees, sigs, msgs, weights, positions=4):
    cpu = torch.device("cpu")
    pk, mask = TB.encode_committee_pubkeys(committees, positions)
    return (pk, mask, P.g2_encode(sigs, cpu), P.g2_encode([hash_to_g2(m) for m in msgs], cpu),
            TB._pack_wbits(weights))


def test_epoch_program_accepts_the_corpus():
    bk = TB.TorchBackend(device="cpu")
    args = _epoch_operands(*_epoch_corpus(tapi))
    assert bk.resolve(bk.epoch_program(4, 4)(*args)) is True
    assert list(bk.builds) == [("epoch", 4, 4, False, False, False)]


@pytest.mark.slow
def test_epoch_program_rejects_a_corrupted_member():
    committees, sigs, msgs, weights = _epoch_corpus(tapi)
    committees[2][1] = tapi.SecretKey(31337).public_key().point
    bk = TB.TorchBackend(device="cpu")
    assert bk.resolve(bk.epoch_program(4, 4)(
        *_epoch_operands(committees, sigs, msgs, weights))) is False


@pytest.mark.slow
@pytest.mark.parametrize("corrupt", [False, True])
def test_program_matches_jax_epoch_verify_kernel(corrupt):
    """JAX's jitted _epoch_verify_kernel and the port's on the same operands
    (the JAX package's, carried over with convert.operands_from_jax)."""
    from lighthouse_tpu.crypto.bls.hash_to_curve import hash_to_g2 as jh2g

    committees, sigs, msgs, weights = _epoch_corpus(japi)
    if corrupt:
        committees[2][1] = japi.SecretKey(31337).public_key().point
    pk, mask = JB.encode_committee_pubkeys(committees, 4)
    jargs = (pk, mask, JP.g2_encode(sigs), JP.g2_encode([jh2g(m) for m in msgs]),
             JB._pack_wbits(weights))
    want = bool(jax.jit(JB._epoch_verify_kernel, static_argnums=5)(*jargs, 4))
    assert want is not corrupt
    targs = convert.operands_from_jax(jargs, "cpu")
    targs = targs[:1] + (targs[1].bool(),) + targs[2:]
    with torch.inference_mode():
        assert bool(TB._epoch_verify_kernel(*targs, 4)) is want
