"""The port's ingest engine (lighthouse_tpu_torch/ingest): cache, pool, chaos and budget.

The other families of tests/test_ingest.py, on the port:

* cache: hit, miss and eviction counters, the epoch boundary, the LRU bound,
  the incremental sync, and one registry loaded into both packages' caches
  gathering the same columns; the mirror is replaced on growth and uploads
  through ``fp.upload`` (so never inside a CUDA graph capture);
* pool and chaos: the ``ingest.marshal`` fault site and the degradation
  ladder, and the JAX package's ``PipelinedVerifier`` marshalling through
  the port's engine; the marshal's spans;
* budget: the >= 10x gate of the committee fan-out shape.
"""

import time

import numpy as np
import pytest
import torch

# the plain versions and numpy stages: one intra-op thread per process
torch.set_num_threads(1)

pytest.importorskip("jax")

from torch_ingest_corpus import (  # noqa: E402
    N_KEYS, PORT, REF, FakeRegistry, assert_mb_equal, draw_weights, engines, make_sets,
    port_backend, rand_spec)

from lighthouse_tpu_torch.crypto.bls import api as tapi  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import convert  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F  # noqa: E402
from lighthouse_tpu_torch.ingest import IngestEngine, MarshalPool, PubkeyLimbCache  # noqa: E402
from lighthouse_tpu_torch.utils import faults  # noqa: E402
from lighthouse_tpu_torch.utils import metrics as M  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_injector():
    faults.INJECTOR.disarm()
    yield
    faults.INJECTOR.disarm()



# ---------------------------------------------------------------------------
# cache behaviour
# ---------------------------------------------------------------------------


def test_hit_counters_prove_encode_skipped():
    """On a warm cache the whole batch resolves as hits: no miss means no
    aggregation and no limb encode."""
    rng = np.random.default_rng(7)
    _, eng, _, _ = engines()
    psets = make_sets(PORT, rand_spec(rng, 16, multi=True))
    m0 = M.INGEST_CACHE_MISSES.value()
    eng.marshal_sets(psets, draw_weights(rng, 16))
    assert M.INGEST_CACHE_MISSES.value() - m0 > 0
    h1, m1 = M.INGEST_CACHE_HITS.value(), M.INGEST_CACHE_MISSES.value()
    eng.marshal_sets(psets, draw_weights(rng, 16))
    assert M.INGEST_CACHE_MISSES.value() == m1
    assert M.INGEST_CACHE_HITS.value() - h1 == 16


def test_epoch_boundary_invalidates_aggregates():
    pb, eng, _, _ = engines(registry=range(8), device_gather=False)
    psets = make_sets(PORT, [([1, 2, 3], b"c")])
    eng.marshal_sets(psets, [7])
    assert eng.cache.lru_size() == 1
    ev0 = M.INGEST_CACHE_EVICTIONS.value()
    eng.begin_epoch(5)
    assert eng.cache.lru_size() == 0 and eng.cache.registry_size() == 8
    assert eng.cache.epoch == 5
    assert M.INGEST_CACHE_EVICTIONS.value() - ev0 == 1
    eng.begin_epoch(5)  # the same epoch: a no-op
    assert M.INGEST_CACHE_EVICTIONS.value() - ev0 == 1
    assert_mb_equal(pb.marshal_sets(psets, [9]), eng.marshal_sets(psets, [9]), "post-epoch")
    assert eng.cache.lru_size() == 1


def test_lru_bound_evicts_oldest():
    _, eng, _, _ = engines(device_gather=False, lru_capacity=4)
    ev0 = M.INGEST_CACHE_EVICTIONS.value()
    for i in range(6):  # six committees through a four-entry LRU
        eng.marshal_sets(make_sets(PORT, [([i, i + 1], b"c%d" % i)]), [3])
    assert eng.cache.lru_size() <= 4
    assert M.INGEST_CACHE_EVICTIONS.value() - ev0 >= 2
    assert M.INGEST_CACHE_KEYS.value() == eng.cache.lru_size()


def test_sync_registry_is_incremental_and_the_mirror_is_replaced():
    reg = FakeRegistry(PORT.pks[:4])
    cache = PubkeyLimbCache(device="cpu")
    assert cache.sync_registry(reg) == 4
    assert cache.sync_registry(reg) == 0  # a no-op when nothing is new
    old_x, old_y = cache.registry_device()
    old_copy = old_x.clone()
    reg.append(PORT.pks[4])
    assert cache.sync_registry(reg) == 1 and cache.registry_size() == 5
    assert cache.device_bytes() == 2 * F.N * 4 * 5
    new_x, _ = cache.registry_device()
    assert new_x is not old_x and tuple(new_x.shape) == (F.N, 5)
    assert torch.equal(old_x, old_copy) and tuple(old_x.shape) == (F.N, 4)  # never written
    for dt in (np.int64, np.int32):
        slots = np.array([0, 3, 4, 0], dtype=dt)
        hx, hy = cache.registry_columns(slots)
        dx, dy = cache.gather_device(slots)
        assert dx.dtype == F.DTYPE and np.array_equal(hx, dx.numpy())
        assert np.array_equal(hy, dy.numpy())


def test_one_registry_in_both_caches_gathers_the_same_columns():
    """The JAX cache's registry columns, carried over by
    convert.registry_from_jax, equal the port's, and the two device gathers
    agree at scattered slots."""
    from lighthouse_tpu.ingest import PubkeyLimbCache as JaxCache

    pc, jc = PubkeyLimbCache(device="cpu"), JaxCache()
    assert pc.sync_registry(FakeRegistry(PORT.pks)) == jc.sync_registry(
        FakeRegistry(REF.pks)) == N_KEYS
    every = np.arange(N_KEYS)
    jx, jy = jc.registry_columns(every)
    assert jx.dtype == np.uint32
    cx, cy = convert.registry_from_jax(jx, jy)
    px, py = pc.registry_columns(every)
    assert cx.dtype == px.dtype == np.int32
    assert cx.tobytes() == px.tobytes() and cy.tobytes() == py.tobytes()
    slots = np.array([23, 0, 7, 7, 12, 1])
    gx, gy = pc.gather_device(slots)
    rx, ry = convert.registry_from_jax(*(np.asarray(a) for a in jc.gather_device(slots)))
    assert gx.numpy().tobytes() == rx.tobytes() and gy.numpy().tobytes() == ry.tobytes()
    with pytest.raises(ValueError):
        convert.registry_from_jax(jx[:5], jy)


def test_the_mirror_uploads_through_fp_upload(monkeypatch):
    """The mirror and the slots go to the device through fp.upload, which
    refuses a host-to-device copy inside a CUDA graph capture: the marshal
    runs outside the program, and a gather inside a capture would raise."""
    cache = PubkeyLimbCache(device="cuda")  # no card needed: upload raises first
    cache.sync_registry(FakeRegistry(PORT.pks[:3]))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        cache.gather_device(np.array([0, 1]))
    calls = []
    monkeypatch.setattr(F, "upload", lambda t, device: calls.append(tuple(t.shape)) or t)
    cache.gather_device(np.array([2, 0, 1]))
    assert calls == [(F.N, 3), (F.N, 3), (3,)]  # x, y mirror, then the slots


# ---------------------------------------------------------------------------
# pool and chaos
# ---------------------------------------------------------------------------


def test_pool_shards_preserve_order_and_refuse_non_elementwise():
    pool = MarshalPool(workers=4, min_shard=1)
    try:
        items = list(range(23))
        assert pool.map_shards(lambda xs: [x * 2 for x in xs], items) == [x * 2 for x in items]
        assert M.INGEST_POOL_DEPTH.value() == 4
    finally:
        pool.close()
    with pytest.raises(ValueError):
        MarshalPool(workers=1).map_shards(lambda xs: xs[:-1], [1, 2, 3])
    small = MarshalPool(workers=8, min_shard=256)
    assert small.shard_count(100) == 1 and small._pool is None  # never spun up


def test_pool_workers_from_the_environment(monkeypatch):
    """The port's pool runs inline unless asked; the reference's takes one
    thread per core, whose shards queue on the GIL (ingest/pool.py)."""
    import os

    from lighthouse_tpu.ingest import pool as ref_pool
    from lighthouse_tpu_torch.ingest import pool

    monkeypatch.delenv("LIGHTHOUSE_TPU_INGEST_WORKERS", raising=False)
    assert MarshalPool().workers == 1
    assert ref_pool.MarshalPool().workers == max(1, os.cpu_count() or 1)
    monkeypatch.setenv("LIGHTHOUSE_TPU_INGEST_WORKERS", "3")
    assert MarshalPool().workers == 3
    assert pool.MIN_SHARD == 256


@pytest.mark.chaos
def test_armed_fault_degrades_to_scalar_byte_equal():
    rng = np.random.default_rng(8)
    pb, eng, _, _ = engines()
    psets, ws = make_sets(PORT, rand_spec(rng, 5)), draw_weights(rng, 5)
    f0 = M.INGEST_FALLBACKS.value()
    faults.INJECTOR.arm("ingest.marshal", "error", times=1)
    mb = eng.marshal_sets(psets, ws)  # must not raise
    assert M.INGEST_FALLBACKS.value() - f0 == 1
    assert not mb.invalid
    assert_mb_equal(pb.marshal_sets(psets, ws), mb, "chaos-fallback")
    assert ("ingest.marshal", "error") in faults.INJECTOR.fired


@pytest.mark.chaos
def test_double_failure_yields_invalid_batch_not_exception():
    rng = np.random.default_rng(9)
    pb, eng, _, _ = engines()

    def broken(sets, weights=None):
        raise RuntimeError("scalar path down")

    eng._backend = type("B", (), {"marshal_sets": staticmethod(broken), "device_h2c": True,
                                  "_padded_size": pb._padded_size, "device": pb.device})()
    f0 = M.INGEST_FALLBACKS.value()
    faults.INJECTOR.arm("ingest.marshal", "error", times=1)
    mb = eng.marshal_sets(make_sets(PORT, rand_spec(rng, 3)), draw_weights(rng, 3))
    assert mb.invalid
    assert M.INGEST_FALLBACKS.value() - f0 == 2
    # marshal_for_mesh degrades through the same ladder
    faults.INJECTOR.arm("ingest.marshal", "error", times=2)
    assert eng.marshal_for_mesh(make_sets(PORT, rand_spec(rng, 3)), [1, 2, 3]).invalid


@pytest.mark.chaos
def test_pipelined_verifier_uses_engine_marshal():
    """The port's PipelinedVerifier.for_backend(ingest=...) wires the port's
    engine as its marshal stage in front of the port's backend."""
    from lighthouse_tpu_torch.beacon.processor import PipelinedVerifier

    rng = np.random.default_rng(10)
    be = port_backend()
    eng = IngestEngine(be)
    seen = []
    orig = eng.marshal_sets

    def spying(sets, weights=None):
        seen.append(len(sets))
        return orig(sets, weights)

    eng.marshal_sets = spying
    pv = PipelinedVerifier.for_backend(None, be, ingest=eng)
    mb = pv._marshal(make_sets(PORT, rand_spec(rng, 4)))
    assert seen == [4] and not mb.invalid and mb.B == 8


def test_spans_of_the_marshal():
    from lighthouse_tpu_torch.obs.tracer import TRACER

    rng = np.random.default_rng(11)
    _, eng, _, _ = engines()
    last = max((r.sid for r in TRACER.snapshot()), default=0)
    eng.marshal_sets(make_sets(PORT, rand_spec(rng, 3)), [1, 2, 3])
    spans = {r.name: r for r in TRACER.snapshot(last)}
    assert set(spans) == {"ingest.marshal", "ingest.encode", "ingest.expand"}
    top = spans["ingest.marshal"]
    assert spans["ingest.encode"].parent == spans["ingest.expand"].parent == top.sid
    assert dict(top.fields) == {"sets": 3}
    with pytest.raises(ValueError):
        TRACER.span("not.a.span")


# ---------------------------------------------------------------------------
# the budget gate: >= 10x on the committee fan-out shape
# ---------------------------------------------------------------------------


def test_vectorized_beats_scalar_10x_on_committee_shape():
    """The epoch-processing shape (K = 128 signers a set, repeat committees,
    warm cache): the vectorized marshal holds >= 10x over the port's per-set
    scalar loop, the threshold of tests/test_ingest.py.  A slip below it
    means per-set Python came back into the marshal's hot loop."""
    K, n_c, B, pool_k = 128, 16, 256, 16
    spec = [([(c * 5 + j) % pool_k for j in range(K)], (c).to_bytes(32, "big"))
            for c in range(n_c)]
    committees = [[PORT.pks[i] for i in idx] for idx, _ in spec]
    sets = [tapi.SignatureSet(PORT.sig, committees[i % n_c], spec[i % n_c][1])
            for i in range(B)]
    pb, eng, _, _ = engines()
    ws = draw_weights(np.random.default_rng(12), B)
    assert not eng.marshal_sets(sets, ws).invalid  # populate the cache, untimed

    # the best of three vectorized calls (each ~0.1 s, so a scheduler hiccup
    # is a large share of one) against one scalar call (~1.4 s)
    t_vec = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        mb = eng.marshal_sets(sets, ws)
        t_vec = min(t_vec, time.perf_counter() - t0)
    t0 = time.perf_counter()
    oracle = pb.marshal_sets(sets, ws)
    t_scalar = time.perf_counter() - t0

    assert_mb_equal(oracle, mb, "budget-shape")
    speedup = t_scalar / t_vec
    assert speedup >= 10.0, (
        f"vectorized marshal only {speedup:.1f}x scalar (scalar {B / t_scalar:.0f} sets/s, "
        f"vectorized {B / t_vec:.0f} sets/s)")
