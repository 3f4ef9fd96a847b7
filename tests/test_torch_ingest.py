"""The port's ingest engine (lighthouse_tpu_torch/ingest) against the JAX package's: differential.

The differential family of tests/test_ingest.py, on the port: the engine's
``MarshalledBatch`` equals the port's scalar ``TorchBackend.marshal_sets``
byte for byte, and the JAX ``IngestEngine``'s leaf for leaf, on the corpora
of ``TestDifferential`` (random message lengths including empty ones,
repeated messages, duplicate signers, committees, off-registry keys,
padding, invalid sets), in both h2c modes, cold and warm, with the device
gather on and off (the "device" here is the CPU); ``marshal_for_mesh``'s
slots equal the reference's, and ``dispatch`` refuses a batch with slots.
The batched SHA lanes equal hashlib.  Cache, pool, chaos and budget:
tests/test_torch_ingest_cache.py; one verdict through the whole path:
tests/test_torch_ingest_verify.py.
"""

import numpy as np
import pytest
import torch

# the plain versions and numpy stages: one intra-op thread per process
torch.set_num_threads(1)

pytest.importorskip("jax")

from torch_ingest_corpus import (  # noqa: E402
    N_KEYS, PORT, REF, FakeRegistry, assert_mb_equal, assert_mb_matches_jax, draw_weights,
    engines, make_sets, port_backend, port_leaves, rand_spec)

from lighthouse_tpu_torch.ingest import IngestEngine  # noqa: E402
from lighthouse_tpu_torch.ingest import sha  # noqa: E402


# ---------------------------------------------------------------------------
# differential: the engine == the scalar marshal == the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device_h2c", [True, False])
def test_randomized_corpus(device_h2c):
    rng = np.random.default_rng(0xA11CE + device_h2c)
    pb, eng, _, jeng = engines(device_h2c, device_gather=False)
    # n=3 pads to 8, n=13 to 16, n=8 exactly
    for n, multi in [(1, False), (3, False), (8, True), (13, True)]:
        spec, ws = rand_spec(rng, n, multi), draw_weights(rng, n)
        psets = make_sets(PORT, spec)
        oracle = pb.marshal_sets(psets, ws)
        cold = eng.marshal_sets(psets, ws)
        warm = eng.marshal_sets(psets, ws)  # the cache-hit path
        assert_mb_equal(oracle, cold, f"cold n={n}")
        assert_mb_equal(oracle, warm, f"warm n={n}")
        assert_mb_matches_jax(cold, jeng.marshal_sets(make_sets(REF, spec), ws), f"jax n={n}")


def test_empty_and_repeated_messages():
    pb, eng, _, jeng = engines()
    msgs = [b"", b"", b"x" * 200, b"shared-root", b"shared-root", b"y"]
    spec = [([i % 4], m) for i, m in enumerate(msgs)]
    ws = draw_weights(np.random.default_rng(1), len(spec))
    mb = eng.marshal_sets(make_sets(PORT, spec), ws)
    assert_mb_equal(pb.marshal_sets(make_sets(PORT, spec), ws), mb, "msgs")
    assert_mb_matches_jax(mb, jeng.marshal_sets(make_sets(REF, spec), ws), "msgs jax")


def test_duplicate_signers_in_one_set():
    pb, eng, _, jeng = engines()
    spec = [([0, 0, 1], b"dup"), ([2] * 4, b"dup2")]  # the doubling path
    ws = draw_weights(np.random.default_rng(2), 2)
    mb = eng.marshal_sets(make_sets(PORT, spec), ws)
    assert_mb_equal(pb.marshal_sets(make_sets(PORT, spec), ws), mb, "dups")
    assert_mb_matches_jax(mb, jeng.marshal_sets(make_sets(REF, spec), ws), "dups jax")


def test_off_registry_keys():
    pb, eng, _, jeng = engines(registry=range(8), device_gather=False)  # keys 8+ off it
    spec = [([i], b"m%d" % i) for i in range(16)]
    ws = draw_weights(np.random.default_rng(3), 16)
    mb = eng.marshal_sets(make_sets(PORT, spec), ws)
    assert_mb_equal(pb.marshal_sets(make_sets(PORT, spec), ws), mb, "off-registry")
    assert_mb_matches_jax(mb, jeng.marshal_sets(make_sets(REF, spec), ws), "off-registry jax")
    # off-registry singles live in the LRU tier, not the registry
    assert eng.cache.registry_size() == 8 and eng.cache.lru_size() == 8


def test_invalid_sets_match_oracle():
    pb, eng, _, jeng = engines()
    for keys in (PORT, REF):
        x, y = keys.pks[0].point
        keys.neg = keys.api.PublicKey((x, -y))
    for make in (lambda k: [k.api.SignatureSet(k.api.Signature(None), [k.pks[0]], b"x")],
                 lambda k: [k.api.SignatureSet(k.sig, [], b"x")],
                 lambda k: [k.api.SignatureSet(k.sig, [k.pks[0], k.neg], b"x")],  # to infinity
                 lambda k: []):
        psets = make(PORT)
        ws = [5] * len(psets)
        o, v = pb.marshal_sets(psets, ws), eng.marshal_sets(psets, ws)
        assert o.invalid and v.invalid
        assert_mb_equal(o, v, "invalid")
        assert_mb_matches_jax(v, jeng.marshal_sets(make(REF), ws), "invalid jax")
    assert eng.cache.lru_size() == 0  # an invalid aggregate must not poison the cache


@pytest.mark.parametrize("device_h2c", [True, False])
def test_device_gather_matches_host_assembly(device_h2c):
    pb, dg, _, jeng = engines(device_h2c, registry=range(N_KEYS), device_gather=True)
    hg = IngestEngine(pb, pubkey_cache=FakeRegistry(PORT.pks), device_gather=False)
    spec = [([i % N_KEYS], b"g%d" % i) for i in range(12)]
    ws = draw_weights(np.random.default_rng(4), 12)
    psets = make_sets(PORT, spec)
    oracle = pb.marshal_sets(psets, ws)
    for warm in (False, True):
        g = dg.marshal_sets(psets, ws)
        assert_mb_equal(oracle, g, f"device-gather warm={warm}")
        assert_mb_equal(oracle, hg.marshal_sets(psets, ws), f"host-gather warm={warm}")
        assert_mb_matches_jax(g, jeng.marshal_sets(make_sets(REF, spec), ws), "gather jax")
    # the gathering engine built the registry's mirror; the host one did not
    assert dg.cache._dev is not None and hg.cache._dev is None


def test_device_gather_defaults_to_the_backend_device():
    eng = IngestEngine(port_backend())
    assert eng.cache.device == torch.device("cpu")
    assert eng._use_device_gather() is False  # the CPU: host assembly

    class OnCard:  # only the device is read
        device = torch.device("cuda")

    assert IngestEngine(OnCard())._use_device_gather() is True


def test_marshal_for_mesh_slots_match_the_reference():
    pb, eng, _, jeng = engines(registry=range(N_KEYS))
    order = [5, 17, 0, 23, 9]  # scattered slots; pads to 8 with slot 5
    spec = [([i], b"mesh%d" % i) for i in order]
    ws = draw_weights(np.random.default_rng(5), len(spec))
    mb = eng.marshal_for_mesh(make_sets(PORT, spec), ws)
    ref = jeng.marshal_for_mesh(make_sets(REF, spec), ws)
    assert mb.slots.dtype == torch.int32 and tuple(mb.slots.shape) == (8,)
    assert np.array_equal(mb.slots.numpy(), ref.slots)
    assert mb.slots.tolist() == order + [5] * 3
    assert_mb_matches_jax(mb, ref, "mesh")  # args leave the pubkeys out
    full = pb.marshal_sets(make_sets(PORT, spec), ws)
    assert port_leaves(mb.args) and len(port_leaves(mb.args)) == len(
        port_leaves(full.args)) - 2
    # a set off the registry: no slots, the ordinary batch
    spec2 = spec + [([0, 1], b"committee")]
    ws2 = ws + [3]
    mixed = eng.marshal_for_mesh(make_sets(PORT, spec2), ws2)
    assert mixed.slots is None
    assert_mb_equal(pb.marshal_sets(make_sets(PORT, spec2), ws2), mixed, "mesh mixed")
    assert jeng.marshal_for_mesh(make_sets(REF, spec2), ws2).slots is None


def test_a_batch_with_slots_is_refused_by_dispatch():
    """Only a mesh path may take a batch whose pubkey operand is deferred to
    a registry gather: dispatch and verify_marshalled raise ValueError
    before anything runs (jax_backend/backend.py:726-729)."""
    pb, eng, _, _ = engines(registry=range(N_KEYS))
    mb = eng.marshal_for_mesh(make_sets(PORT, [([i], b"s%d" % i) for i in range(3)]), [1, 2, 3])
    assert mb.slots is not None and not mb.invalid
    with pytest.raises(ValueError, match="mesh path"):
        pb.dispatch(mb)
    with pytest.raises(ValueError, match="mesh path"):
        pb.verify_marshalled(mb)


def test_sha_lanes_match_hashlib():
    import hashlib

    from lighthouse_tpu_torch.crypto.bls.hash_to_curve import expand_message_xmd, \
        hash_to_field_fp2

    rng = np.random.default_rng(6)
    for m in (0, 1, 55, 56, 64, 119, 200):
        data = rng.integers(0, 256, (3, m), dtype=np.uint8)
        assert [bytes(r) for r in sha.sha256_batch(data)] == [
            hashlib.sha256(bytes(row)).digest() for row in data]
        out = sha.expand_message_xmd_batch(data, b"DST-test", 256)
        assert [bytes(r) for r in out] == [expand_message_xmd(bytes(row), b"DST-test", 256)
                                           for row in data]
    msgs = [b"", b"a", b"b" * 77, b"a", b"c" * 300]  # lengths of 1 to 6 blocks, in one run
    got = sha.hash_to_field_fp2_batch(msgs, 2)
    for m, us in zip(msgs, got):
        want = hash_to_field_fp2(m, 2)
        assert [(u.c0, u.c1) for u in us] == [(u.c0, u.c1) for u in want]
