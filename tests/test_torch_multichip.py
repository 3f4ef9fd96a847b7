"""The port's multi-seat verify (lighthouse_tpu_torch/crypto/bls/
torch_backend/multichip.py): twins of tests/test_multichip.py, on meshes of
CPU seats (``make_mesh(n, device="cpu")``).

Fast tier: the pad helpers against the reference's, and the programs'
orchestration (split, per-seat work under each seat's ``seat_context``, the
combine on the lead seat, the pair padding mask) with the field code
stubbed by integer arithmetic whose "pairing equation" holds exactly when
every set is valid.

``slow``: the real kernels' plain versions on 2- and 8-seat meshes against
the reference's jitted ``make_verify_sharded``, ``_verify_kernel`` and
``make_pair_sharded_aggregate_verify`` on its 8-device mesh, on the same
seeded inputs (the reference's marshalled arrays, converted), and the
byte-identity class of tests/test_partition.py through the port's
``ShardedVerifyProgram`` over the backend's seat programs.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F
from lighthouse_tpu_torch.crypto.bls.torch_backend import multichip as MC
from lighthouse_tpu_torch.parallel import mesh as M


def test_pad_tail_cols_and_trailing_extent():
    """Fast unit: the non-divisible-batch pad helpers (no kernel), as the
    reference's on the same tree."""
    import jax.numpy as jnp

    from lighthouse_tpu.crypto.bls.jax_backend import multichip as JMC

    tree = (torch.arange(12).reshape(2, 6), torch.arange(6))
    assert MC._trailing_extent(tree) == 6
    padded = MC._pad_tail_cols(tree, 2)
    assert MC._trailing_extent(padded) == 8
    a, b = padded
    assert a.shape == (2, 8)
    # every pad column is a copy of column 0 (real, well-formed data)
    assert bool((a[:, 6] == a[:, 0]).all()) and bool((a[:, 7] == a[:, 0]).all())
    assert bool((b[6:] == b[0]).all())
    assert MC._pad_tail_cols(tree, 0) is tree  # pad=0 is the identity
    ref = JMC._pad_tail_cols((jnp.arange(12).reshape(2, 6), jnp.arange(6)), 2)
    assert all(np.array_equal(np.asarray(r), p.numpy()) for r, p in zip(ref, padded))
    lfp = MC._pad_tail_cols((F.LFp(torch.ones((F.N, 3), dtype=F.DTYPE), 2.5),), 1)[0]
    assert lfp.limbs.shape == (F.N, 4) and lfp.bound == 2.5


# ---------------------------------------------------------------------------
# Orchestration with the field code stubbed: set i is (pk_i, sig_i, h_i, w_i)
# integers; the stub pairing equation is sum_i w_i (pk_i h_i - sig_i) == 0,
# which a set with sig_i != pk_i h_i breaks
# ---------------------------------------------------------------------------


@pytest.fixture()
def stubbed(monkeypatch):
    """multichip's field code as integer stand-ins; the returned log records,
    for each stand-in call, whether it ran inside a seat_context."""
    depth = [0]
    log = []
    real = M.seat_context

    @contextlib.contextmanager
    def spy(device):
        depth[0] += 1
        log.append("enter")
        try:
            with real(device):
                yield
        finally:
            depth[0] -= 1

    def rec(fn):
        def wrapped(*a):
            log.append(depth[0] > 0)
            return fn(*a)
        return wrapped

    monkeypatch.setattr(M, "seat_context", spy)
    stub_p = types.SimpleNamespace(
        FP_OPS="g1", FP2_OPS="g2",
        g2_subgroup_check=rec(lambda sig: sig >= 0),
        from_affine=lambda ops, xy: xy,
        scalar_mul_bits=rec(lambda ops, p, bits: p * bits),
        to_affine=lambda ops, p, inv: p[0] if isinstance(p, tuple) else p)
    stub_pr = types.SimpleNamespace(
        miller_loop=rec(lambda p, q: (p * q).reshape(1, 1, -1)),
        gt_product=lambda f: f.sum(-1, keepdim=True),
        fp12_one_like_from_fp2=lambda x: torch.zeros((), dtype=torch.int64),
        final_exp_is_one=lambda x: (x == 0).reshape(1))
    stub_t = types.SimpleNamespace(fp12_select=torch.where, fp12_mul=lambda a, b: a + b,
                                   fp2_inv=None)

    def tree_reduce(w):
        """A batch of weighted signatures, or of gathered sums, to one sum."""
        s = (w[0] if isinstance(w, tuple) else w).sum(-1, keepdim=True)
        return (s, s, s, torch.zeros(s.shape, dtype=torch.bool))

    monkeypatch.setattr(MC, "P", stub_p)
    monkeypatch.setattr(MC, "PR", stub_pr)
    monkeypatch.setattr(MC, "T", stub_t)
    monkeypatch.setattr(MC, "_tree_reduce_g2", tree_reduce)
    monkeypatch.setattr(MC, "_neg_gen_const", lambda device: torch.tensor([-1]))
    return log


def _stub_sets(n, bad=()):
    g = torch.Generator().manual_seed(n)
    pk = torch.randint(1, 50, (n,), generator=g)
    h = torch.randint(1, 50, (n,), generator=g)
    w = torch.randint(1, 1000, (n,), generator=g)
    sig = pk * h
    for i in bad:
        sig[i] += 1
    return pk, sig, h, w


@pytest.mark.parametrize("width,n", [(4, 8), (4, 6), (8, 8), (2, 5)])
@pytest.mark.parametrize("bad", [(), (1,)])
def test_verify_sharded_splits_runs_each_seat_and_combines(stubbed, width, n, bad):
    mesh = M.make_mesh(width, device="cpu")
    pk, sig, h, w = _stub_sets(n, bad)
    got = MC.make_verify_sharded(mesh)(pk, sig, h, w)
    assert got.shape == (1,) and bool(got) is (not bad)
    # every stand-in ran under a seat's context: per seat and on the lead
    calls = [e for e in stubbed if e != "enter"]
    assert calls and all(calls)
    assert stubbed.count("enter") == 2 * width + 1  # placement, work, epilogue


@pytest.mark.parametrize("width,n", [(4, 8), (4, 6), (8, 3)])
@pytest.mark.parametrize("bad", [(), (2,)])
def test_pair_sharded_masks_the_padding_and_rings_the_partials(stubbed, width, n, bad):
    """The aggregate verify's pairs over the seats: padded pairs are masked
    to the identity before the local product (a duplicated pair would
    otherwise count twice), the partials fold around the ring (width - 1
    hops on every seat) and the lead seat finishes."""
    mesh = M.make_mesh(width, device="cpu")
    pk, _, h, _ = _stub_sets(n)
    agg = (pk * h).sum().reshape(1) + (1 if bad else 0)
    got = MC.make_pair_sharded_aggregate_verify(mesh)(pk, h, agg)
    assert bool(got) is (not bad)
    calls = [e for e in stubbed if e != "enter"]
    assert calls and all(calls)
    assert stubbed.count("enter") == 2 * width + width * (width - 1) + 1


# ---------------------------------------------------------------------------
# Real kernels (plain versions on the CPU) against the reference
# ---------------------------------------------------------------------------


def _port_tree(x):
    """A reference operand tree (jax arrays, its LFp) as the port's (int32
    tensors, F.LFp): the same limb bits."""
    if hasattr(x, "limbs"):
        return F.LFp(torch.from_numpy(np.asarray(x.limbs).astype(np.int32)), x.bound)
    if isinstance(x, (tuple, list)):
        return tuple(_port_tree(e) for e in x)
    return torch.from_numpy(np.asarray(x).astype(np.int32))


@pytest.mark.slow
@pytest.mark.parametrize("width", [2, 8])
def test_sharded_matches_single_chip(width):
    """The port's make_verify_sharded on the reference's example batch (8
    valid sets, host H(m)) and with the message points replaced: the
    reference's jitted sharded program and single-device kernel agree."""
    import jax
    from jax.sharding import Mesh

    import __graft_entry__ as graft
    from lighthouse_tpu.crypto.bls.hash_to_curve import hash_to_g2
    from lighthouse_tpu.crypto.bls.jax_backend import points as JP
    from lighthouse_tpu.crypto.bls.jax_backend.backend import _verify_kernel
    from lighthouse_tpu.crypto.bls.jax_backend.multichip import make_verify_sharded

    graft._enable_compile_cache(jax)
    args = graft._example_batch(8)
    bad_h = JP.g2_encode([hash_to_g2(b"\xEE" * 32)] * 8)
    bad = (args[0], args[1], bad_h, args[3])
    ref = make_verify_sharded(Mesh(np.array(jax.devices()[:8]), ("batch",)))
    single = jax.jit(_verify_kernel)
    port = MC.make_verify_sharded(M.make_mesh(width, device="cpu"))
    for a, want in ((args, True), (bad, False)):
        assert bool(ref(*a)) is bool(single(*a)) is want
        assert bool(port(*_port_tree(a))) is want


@pytest.mark.slow
@pytest.mark.parametrize("n_pairs", [8, 6])
def test_pair_sharded_aggregate_verify_ring(n_pairs):
    """The pairs of one aggregate verify over 8 seats (6 pairs: two padded
    lanes masked), accept and reject, as the reference's ring program."""
    import jax
    from jax.sharding import Mesh

    import __graft_entry__ as graft
    from lighthouse_tpu.crypto.bls.api import AggregateSignature, SecretKey
    from lighthouse_tpu.crypto.bls.hash_to_curve import hash_to_g2
    from lighthouse_tpu.crypto.bls.jax_backend import points as JP
    from lighthouse_tpu.crypto.bls.jax_backend.multichip import (
        make_pair_sharded_aggregate_verify,
    )

    graft._enable_compile_cache(jax)
    sks = [SecretKey(8000 + i) for i in range(n_pairs)]
    msgs = [bytes([40 + i]) * 32 for i in range(n_pairs)]
    sig = AggregateSignature.aggregate([sk.sign(m) for sk, m in zip(sks, msgs)])
    pk_enc = JP.g1_encode([sk.public_key().point for sk in sks])
    h_enc = JP.g2_encode([hash_to_g2(m) for m in msgs])
    sig_enc = JP.g2_encode([sig.signature.point])
    bad = [sk.public_key().point for sk in sks]
    bad[2] = SecretKey(515151).public_key().point
    ref = make_pair_sharded_aggregate_verify(Mesh(np.array(jax.devices()[:8]), ("batch",)))
    port = MC.make_pair_sharded_aggregate_verify(M.make_mesh(8, device="cpu"))
    for pk, want in ((pk_enc, True), (JP.g1_encode(bad), False)):
        assert bool(ref(pk, h_enc, sig_enc)) is want
        assert bool(port(*_port_tree((pk, h_enc, sig_enc)))) is want


@pytest.mark.slow
@pytest.mark.parametrize("width", [2, 8])
def test_sharded_program_over_seat_programs_matches_single_device(width):
    """tests/test_partition.py's byte-identity class through the port: the
    ShardedVerifyProgram over TorchBackend's seat programs on CPU seats, on
    a valid corpus and with set 5 bad: its conjunction equals the
    single-device verdict and exactly the shard owning set 5 fails."""
    from lighthouse_tpu_torch.crypto.bls.api import SecretKey, SignatureSet
    from lighthouse_tpu_torch.crypto.bls.torch_backend.backend import TorchBackend
    from lighthouse_tpu_torch.parallel.partition import ShardedVerifyProgram

    sks = [SecretKey(9000 + i) for i in range(8)]
    msgs = [b"epoch-%d" % i for i in range(8)]
    sets = [SignatureSet(sk.sign(m), [sk.public_key()], m) for sk, m in zip(sks, msgs)]
    bad = list(sets)
    bad[5] = SignatureSet(sks[5].sign(b"other"), [sks[5].public_key()], msgs[5])
    bk = TorchBackend(device="cpu", min_batch=1)
    prog = ShardedVerifyProgram(M.make_mesh(width, device="cpu"), seat_program=bk.seat_program,
                                pk_wrap=bk.registry_pk_wrap)
    mb = bk.marshal_sets(sets)
    assert bk.verify_marshalled(mb) is True
    assert prog.verdict_vector(mb.args).all()
    mb = bk.marshal_sets(bad)
    v = prog.verdict_vector(mb.args)
    owner = next(i for i, (a, b) in enumerate(prog.shard_bounds(8)) if a <= 5 < b)
    assert not v[owner] and all(v[i] for i in range(width) if i != owner)
    assert bk.verify_marshalled(mb) is False
