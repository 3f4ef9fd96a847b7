"""The port's rule-driven sharded program (lighthouse_tpu_torch/parallel/
partition.py): twins of tests/test_partition.py, on a mesh of 8 CPU seats
(``make_mesh(8, device="cpu")``, the counterpart of the reference's 8
virtual CPU devices).  Families:

* rule table: operand naming binds the live marshal output (the port's
  ingest engine) to the literal ``OPERAND_LEAVES``, every leaf resolves
  through ``PARTITION_RULES``, an unmatched leaf is a hard error;
* program: stub-kernel dispatch over the seats (all-true verdicts, a
  poisoned column condemns exactly its shard, non-divisible batches pad
  with AND-safe duplicates), and a cross-check against the reference's
  ``ShardedVerifyProgram`` on its 8-device mesh;
* partitioned registry: the masked take + sum over the seats reconstructs
  the pubkey columns byte for byte from the sharded mirror;
* pod: the sharded fast path through ``PodVerifier``;
* epoch stream: in-flight chunks bounded, peak host memory O(chunk)
  (tracemalloc-pinned);
* registry mirror: ``registry_device_sharded`` shrinks per-seat bytes by
  the width.

The reference's two shim tests (``compat_shard_map``,
``compat_jit_sharded``) have no twin: the port has no jax-version shims.
The real-kernel byte-identity runs are in tests/test_torch_multichip.py
under ``slow``.
"""

import threading
import tracemalloc

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu_torch.beacon.processor import CircuitBreaker, ResilientVerifier
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F
from lighthouse_tpu_torch.parallel import mesh as M
from lighthouse_tpu_torch.parallel import partition as P
from lighthouse_tpu_torch.parallel.pod import PodVerifier
from lighthouse_tpu_torch.utils import faults
from lighthouse_tpu_torch.utils.faults import FaultInjector

N_LIMBS = 26


@pytest.fixture(autouse=True)
def _clean_global_injector():
    faults.INJECTOR.disarm()
    yield
    faults.INJECTOR.disarm()


# ---------------------------------------------------------------------------
# Stub operands: real tree shapes (F.LFp nodes), no field math: the kernel
# is a conjunction over the wbits plane, so a set's verdict is encoded by
# zeroing its wbits column.
# ---------------------------------------------------------------------------


def _lfp(B, val=1):
    return F.LFp(torch.full((N_LIMBS, B), val, dtype=torch.int32), 1.0)


def _point2(B):
    return ((_lfp(B), _lfp(B)), (_lfp(B), _lfp(B)))


def _stub_wbits(verdicts):
    wb = np.ones((4, len(verdicts)), dtype=np.int32)
    for i, v in enumerate(verdicts):
        if not v:
            wb[:, i] = 0
    return wb


def _stub_args(verdicts):
    """Non-h2c operand tuple (pk, sig, h, wbits) for a bool batch."""
    B = len(verdicts)
    return ((_lfp(B), _lfp(B)), _point2(B), _point2(B), torch.from_numpy(_stub_wbits(verdicts)))


def _stub_kernel(pk, sig, h, wbits):
    return torch.all(wbits > 0)


@pytest.fixture(scope="module")
def mesh8():
    return M.make_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def program8(mesh8):
    return P.ShardedVerifyProgram(mesh8, _stub_kernel)


# ---------------------------------------------------------------------------
# Rule table / operand naming
# ---------------------------------------------------------------------------


class _PkCache:
    def __init__(self, keys):
        self._keys = keys

    def __len__(self):
        return len(self._keys)

    def get(self, i):
        return self._keys[i]


class TestRuleTable:
    def test_tables_are_the_reference_s(self):
        from lighthouse_tpu.parallel import partition as JP

        assert P.PARTITION_RULES == JP.PARTITION_RULES
        assert P.OPERAND_LEAVES == JP.OPERAND_LEAVES
        assert P._NEST_LABELS == JP._NEST_LABELS and P._TOP_NAMES == JP._TOP_NAMES
        assert list(P.SPEC_TOKENS) == list(JP.SPEC_TOKENS)
        for token in P.SPEC_TOKENS:
            for ndim in (1, 2):
                assert tuple(P.SPEC_TOKENS[token](ndim, "batch")) == tuple(
                    JP.SPEC_TOKENS[token](ndim, "batch"))

    @pytest.mark.parametrize("deferred_pk", [False, True])
    def test_program_in_specs_are_the_reference_s(self, deferred_pk):
        from lighthouse_tpu.parallel import partition as JP

        args = _stub_args([True] * 8)
        args = args[1:] if deferred_pk else args

        from jax.sharding import PartitionSpec as JPS

        def flat(tree):
            if isinstance(tree, (M.PartitionSpec, JPS)):
                return [tuple(tree)]
            return [x for t in tree for x in flat(t)]

        from lighthouse_tpu.crypto.bls.jax_backend import fp as JF

        def to_ref(x):  # the same operands as the reference's (numpy leaves)
            if isinstance(x, F.LFp):
                return JF.LFp(x.limbs.numpy(), x.bound)
            if isinstance(x, torch.Tensor):
                return x.numpy()
            return tuple(to_ref(e) for e in x)

        ours = P.program_in_specs(args, deferred_pk=deferred_pk)
        ref = JP.program_in_specs(to_ref(args), deferred_pk=deferred_pk)
        assert flat(ours) == flat(ref) and len(flat(ours)) == (12 if deferred_pk else 11)

    def test_stub_operands_name_into_the_inventory(self):
        names = [n for n, _ in P.named_operand_leaves(_stub_args([True] * 4))]
        assert set(names) <= set(P.OPERAND_LEAVES)
        assert "pk/x/limbs" in names and "wbits" in names

    def test_live_marshal_leaves_bind_to_inventory_and_rules(self):
        """The engine's marshalled operand tree names into OPERAND_LEAVES
        and every leaf is rule-claimed: host-only, no kernel."""
        from lighthouse_tpu_torch.crypto.bls.api import SecretKey, SignatureSet
        from lighthouse_tpu_torch.crypto.bls.torch_backend.backend import TorchBackend
        from lighthouse_tpu_torch.ingest import IngestEngine

        engine = IngestEngine(TorchBackend(device="cpu"))
        sks = [SecretKey(7000 + i) for i in range(4)]
        pks = [sk.public_key() for sk in sks]
        sig = sks[0].sign(b"partition-binding")
        sets = [SignatureSet(sig, [pks[i]], b"m%d" % i) for i in range(4)]

        mb = engine.marshal_sets(sets)
        named = P.named_operand_leaves(mb.args)
        assert {n for n, _ in named} <= set(P.OPERAND_LEAVES)
        specs = P.match_partition_rules(P.PARTITION_RULES, named)
        assert len(specs) == len(named)

        engine.cache.sync_registry(_PkCache(pks))
        mb = engine.marshal_for_mesh(sets)
        assert mb.slots is not None  # all-registry batch defers the pk
        named = P.named_operand_leaves(mb.args, deferred_pk=True)
        reg_leaves = {"registry/x", "registry/y", "slots"}
        assert ({n for n, _ in named} | reg_leaves) <= set(P.OPERAND_LEAVES)
        engine.close()

    def test_unmatched_leaf_is_a_hard_error(self):
        with pytest.raises(ValueError, match="partition rule not found"):
            P.match_partition_rules((), [("pk/x/limbs", np.ones((2, 4)))])

    def test_unrecognized_operand_arity_is_a_hard_error(self):
        with pytest.raises(ValueError, match="unrecognized operand"):
            P.named_operand_leaves((np.ones((2, 4)),))

    def test_specs_split_only_the_trailing_batch_axis(self):
        specs = P.operand_partition_specs(_stub_args([True] * 8))
        flat = []

        def collect(t):
            if isinstance(t, M.PartitionSpec):
                flat.append(t)
            else:
                for e in t:
                    collect(e)

        collect(specs)
        assert len(flat) == 11
        for spec in flat:
            assert spec[-1] == M.BATCH_AXIS
            assert all(p is None for p in spec[:-1])


# ---------------------------------------------------------------------------
# The sharded program (stub kernel, 8 seats)
# ---------------------------------------------------------------------------


class TestShardedProgram:
    def test_all_true_batch_verdicts_true_everywhere(self, program8):
        v = program8.verdict_vector(_stub_args([True] * 16))
        assert v.shape == (8,) and v.all()

    def test_poisoned_column_condemns_exactly_its_shard(self, program8):
        verdicts = [True] * 16
        verdicts[5] = False  # shard 2 owns columns [4, 6)
        v = program8.verdict_vector(_stub_args(verdicts))
        assert list(v) == [i != 2 for i in range(8)]
        assert program8.shard_bounds(16)[2] == (4, 6)

    def test_non_divisible_batch_pads_and_stays_true(self, program8):
        v = program8.verdict_vector(_stub_args([True] * 12))
        assert v.all()
        bounds = program8.shard_bounds(12)
        assert bounds[5] == (10, 12)
        assert bounds[6] == (12, 12) and bounds[7] == (12, 12)

    def test_padding_is_and_safe_for_a_failing_tail(self, program8):
        verdicts = [True] * 12
        verdicts[11] = False  # last real column; pad dups column 0 (True)
        v = program8.verdict_vector(_stub_args(verdicts))
        # only shard 5 ([10, 12)) fails; padding-only shards stay true
        assert list(v) == [i != 5 for i in range(8)]

    def test_program_cache_reuses_builds_per_structure(self, program8):
        before = len(program8._programs)
        program8.verdict_vector(_stub_args([True] * 16))
        program8.verdict_vector(_stub_args([True] * 24))
        assert len(program8._programs) == max(before, 1)

    def test_stages_place_each_seat_s_columns(self, mesh8):
        prog = P.ShardedVerifyProgram(mesh8, _stub_kernel)
        args = _stub_args([True] * 16)
        seats = prog.shard_operands(prog.pad_operands(args))
        assert len(seats) == 8
        assert all(s[3].shape == (4, 2) and s[0][0].limbs.shape == (N_LIMBS, 2) for s in seats)
        specs = P.operand_partition_specs(args)
        _, gather = P.make_shard_and_gather_fns(specs, mesh8)
        shard, _ = P.make_shard_and_gather_fns(specs, mesh8)
        back = P.tree_apply(gather, P.tree_apply(shard, args))
        assert torch.equal(back[3], args[3]) and back[0][1].bound == 1.0

    def test_one_of_local_fn_or_seat_program(self, mesh8):
        with pytest.raises(ValueError):
            P.ShardedVerifyProgram(mesh8)
        with pytest.raises(ValueError):
            P.ShardedVerifyProgram(mesh8, _stub_kernel, seat_program=lambda d, b: None)

    def test_seat_program_seam_gets_each_seat_and_its_batch(self, mesh8):
        calls = []

        def seat_program(seat, B):
            calls.append((seat, B))
            return _stub_kernel

        prog = P.ShardedVerifyProgram(mesh8, seat_program=seat_program)
        verdicts = [True] * 32
        verdicts[30] = False
        assert list(prog.verdict_vector(_stub_args(verdicts))) == [True] * 7 + [False]
        assert calls == [(torch.device("cpu"), 4)] * 8

    def test_verdicts_and_bounds_match_the_reference_program(self):
        """The same stub verdicts through the reference ShardedVerifyProgram
        on its 8-device mesh and the port's on 8 seats: equal verdict
        vectors and shard_bounds, divisible and padded."""
        import jax.numpy as jnp

        from lighthouse_tpu.crypto.bls.jax_backend import fp as JF
        from lighthouse_tpu.parallel import partition as JP
        from lighthouse_tpu.parallel.mesh import make_mesh

        def jargs(verdicts):
            B = len(verdicts)

            def jl():
                return JF.LFp(jnp.ones((N_LIMBS, B), dtype=jnp.uint32), 1.0)

            p2 = ((jl(), jl()), (jl(), jl()))
            return ((jl(), jl()), p2, p2, jnp.asarray(_stub_wbits(verdicts)))

        ref = JP.ShardedVerifyProgram(make_mesh(8), lambda pk, s, h, wb: jnp.all(wb > 0))
        port = P.ShardedVerifyProgram(M.make_mesh(8, device="cpu"), _stub_kernel)
        for B, bad in ((16, (3, 12)), (13, (12,)), (8, ())):
            verdicts = [i not in bad for i in range(B)]
            assert list(port.verdict_vector(_stub_args(verdicts))) == list(
                ref.verdict_vector(jargs(verdicts)))
            assert port.shard_bounds(B) == ref.shard_bounds(B)


class TestPartitionedRegistry:
    N_REG = 24  # divisible by 8: no mirror padding

    def _registry(self, mesh):
        rx = np.zeros((N_LIMBS, self.N_REG), dtype=np.int32)
        rx[0, :] = np.arange(self.N_REG)
        ry = np.zeros((N_LIMBS, self.N_REG), dtype=np.int32)
        ry[0, :] = 1000 + np.arange(self.N_REG)
        n_local = self.N_REG // mesh.width
        cut = [slice(i * n_local, (i + 1) * n_local) for i in range(mesh.width)]
        return (tuple(torch.from_numpy(rx[:, c].copy()) for c in cut),
                tuple(torch.from_numpy(ry[:, c].copy()) for c in cut))

    @staticmethod
    def _reg_kernel(pk, sig, h, wbits):
        """The gathered pubkey columns must match the slot vector the
        marshal carried in the wbits plane: a byte-identity probe for the
        masked take + sum gather."""
        x_ok = torch.all(pk[0].limbs[0, :] == wbits[0, :])
        y_ok = torch.all(pk[1].limbs[0, :] == 1000 + wbits[0, :])
        return x_ok & y_ok & torch.all(wbits[1, :] > 0)

    def _rest_args(self, slots, valid):
        B = len(slots)
        wb = np.ones((4, B), dtype=np.int32)
        wb[0, :] = slots
        for i, v in enumerate(valid):
            if not v:
                wb[1, i] = 0
        return (_point2(B), _point2(B), torch.from_numpy(wb))

    @staticmethod
    def _pk_wrap(x, y):
        return (F.LFp(x, 1.0), F.LFp(y, 1.0))

    def test_gather_is_byte_identical_to_host_take(self, mesh8):
        prog = P.ShardedVerifyProgram(mesh8, self._reg_kernel, pk_wrap=self._pk_wrap)
        rng = np.random.default_rng(14)
        slots = rng.integers(0, self.N_REG, 16).astype(np.int32)
        v = prog.verdict_vector_registry(
            self._registry(mesh8), slots, self._rest_args(slots, [True] * 16))
        assert v.shape == (8,) and v.all()

    def test_registry_failure_localizes_to_the_shard(self, mesh8):
        prog = P.ShardedVerifyProgram(mesh8, self._reg_kernel, pk_wrap=self._pk_wrap)
        slots = np.arange(16, dtype=np.int32) % self.N_REG
        valid = [True] * 16
        valid[9] = False  # shard 4 owns columns [8, 10)
        v = prog.verdict_vector_registry(
            self._registry(mesh8), slots, self._rest_args(slots, valid))
        assert list(v) == [i != 4 for i in range(8)]

    def test_non_divisible_slots_pad_like_the_operands(self, mesh8):
        prog = P.ShardedVerifyProgram(mesh8, self._reg_kernel, pk_wrap=self._pk_wrap)
        slots = np.arange(13, dtype=np.int32) % self.N_REG
        v = prog.verdict_vector_registry(
            self._registry(mesh8), slots, self._rest_args(slots, [True] * 13))
        assert v.all()

    def test_registry_mode_without_pk_wrap_raises(self, mesh8):
        prog = P.ShardedVerifyProgram(mesh8, self._reg_kernel)
        with pytest.raises(ValueError, match="pk_wrap"):
            prog.execute_registry(self._registry(mesh8), [torch.zeros(8)] * 8, [()] * 8)


# ---------------------------------------------------------------------------
# Pod integration: the sharded fast path
# ---------------------------------------------------------------------------


class _ShardedStubMB:
    def __init__(self, args, B):
        self.args = args
        self.B = B
        self.invalid = []
        self.slots = None


class ShardedStubBackend:
    """Backend-mode surface with the raw-kernel seam the sharded path needs
    (``local_verify_fn``) plus the width-keyed program the per-seat
    coordinator uses, so both roads are drivable."""

    def __init__(self):
        self.local_fn_grabs = 0
        self.kernel_widths = []
        self._lock = threading.Lock()

    def marshal_sets(self, sets):
        return _ShardedStubMB(_stub_args([bool(s) for s in sets]), len(sets))

    def local_verify_fn(self):
        with self._lock:
            self.local_fn_grabs += 1
        return _stub_kernel

    def _program(self, width):
        with self._lock:
            self.kernel_widths.append(width)
        return _stub_kernel

    def resolve(self, handle):
        return bool(handle)


def make_sharded_pod(**kw):
    clock = [0.0]
    breaker = CircuitBreaker(failure_threshold=3, now=lambda: clock[0])

    def _all(sets):
        return all(bool(s) for s in sets)

    resilient = ResilientVerifier(
        device_verify=_all, cpu_verify=_all, breaker=breaker,
        now=lambda: clock[0], injector=FaultInjector(),
    )
    backend = kw.pop("backend", None) or ShardedStubBackend()
    pod = PodVerifier(
        resilient, backend=backend, injector=FaultInjector(),
        devices=list(M.make_mesh(8, device="cpu").seats), backoff_base=0.0, **kw,
    )
    return pod, backend


class TestPodShardedPath:
    def test_clean_batch_takes_one_sharded_dispatch(self):
        pod, backend = make_sharded_pod()
        out = pod.verify_batch([True] * 10)
        assert out.verdicts == [True] * 10
        assert out.device_calls == 8          # one program, whole mesh
        assert backend.local_fn_grabs == 1    # sharded road, not threaded
        assert backend.kernel_widths == []

    def test_failing_shard_reverifies_only_its_columns(self):
        pod, _ = make_sharded_pod()
        sets = [True] * 10
        sets[7] = False
        out = pod.verify_batch(sets)
        assert out.verdicts == sets
        # partial fallback: the mesh dispatch is still billed in full
        assert out.device_calls >= 8

    def test_device_loss_reshards_the_sharded_program(self):
        pod, _ = make_sharded_pod()
        health = pod._ensure_health()
        for dev in (4, 5, 6, 7):
            health.exclude(dev)
        out = pod.verify_batch([True] * 8)
        assert out.verdicts == [True] * 8
        assert out.device_calls == 4          # width followed the mesh

    def test_width_one_falls_back_to_the_coordinator(self):
        pod, backend = make_sharded_pod()
        health = pod._ensure_health()
        for dev in range(1, 8):
            health.exclude(dev)
        out = pod.verify_batch([True] * 6)
        assert out.verdicts == [True] * 6
        assert out.device_calls == 1
        assert backend.kernel_widths != []    # the threaded road ran

    def test_sharded_disabled_flag_uses_the_coordinator(self):
        pod, backend = make_sharded_pod(sharded=False)
        out = pod.verify_batch([True] * 8)
        assert out.verdicts == [True] * 8
        assert backend.local_fn_grabs == 0
        assert backend.kernel_widths != []

    def test_slot_mode_without_registry_provider_remarshal_falls_back(self):
        """A slot-mode batch whose sharded dispatch cannot run (no registry
        provider) re-marshals through the standard path for the per-seat
        coordinator: never an exception, never a wrong verdict."""
        backend = ShardedStubBackend()

        def slot_marshal(sets):
            mb = backend.marshal_sets(sets)
            mb.slots = np.arange(len(sets), dtype=np.int32)
            mb.args = mb.args[1:]  # deferred pk: (sig, h, wbits)
            return mb

        pod, _ = make_sharded_pod(backend=backend, sharded_marshal=slot_marshal)
        out = pod.verify_batch([True] * 8)
        assert out.verdicts == [True] * 8
        assert backend.kernel_widths != []    # coordinator finished it


# ---------------------------------------------------------------------------
# Epoch streaming: chunks in flight + peak host memory
# ---------------------------------------------------------------------------


class _StreamStubProgram:
    """Host-only program stand-in: handles are the operand tuples, so
    whatever the stream keeps alive is visible to tracemalloc."""

    width = 4

    def __init__(self):
        self.live = 0
        self.peak_live = 0
        self.registry_calls = 0

    def pad_operands(self, args):
        return args

    def shard_operands(self, args, deferred_pk=False):
        return args

    def dispatch(self, args):
        self.live += 1
        self.peak_live = max(self.peak_live, self.live)
        return args

    def dispatch_registry(self, registry, slots, rest_args):
        self.registry_calls += 1
        return self.dispatch(tuple(rest_args))

    def resolve(self, handle):
        self.live -= 1
        ok = bool(np.all(handle[0]))
        return np.full(self.width, ok, dtype=bool)


class _StreamStubMB:
    def __init__(self, arr, slots=None, invalid=()):
        self.args = (arr,)
        self.invalid = list(invalid)
        self.slots = slots


class TestEpochStream:
    def test_results_arrive_in_order_with_bounded_inflight(self):
        prog = _StreamStubProgram()
        chunks = [[bool((i + j) % 3) for j in range(4)] for i in range(9)]

        def marshal(chunk):
            return _StreamStubMB(np.array(chunk, dtype=np.int8))

        results = list(P.stream_epoch(chunks, marshal, prog, inflight=2))
        assert [r.index for r in results] == list(range(9))
        assert prog.peak_live <= 2
        for r, chunk in zip(results, chunks):
            assert r.ok == all(chunk)
            assert r.n == len(chunk)

    def test_invalid_chunk_yields_false_without_dispatch(self):
        prog = _StreamStubProgram()

        def marshal(chunk):
            if len(chunk) == 2:
                return _StreamStubMB(np.ones(1), invalid=[0])
            return _StreamStubMB(np.ones(len(chunk), dtype=np.int8))

        chunks = [[True] * 4, [True] * 2, [True] * 4]
        results = list(P.stream_epoch(chunks, marshal, prog))
        assert [r.ok for r in results] == [True, False, True]
        assert results[1].verdicts is None

    def test_registry_chunks_ride_the_partitioned_gather(self):
        prog = _StreamStubProgram()

        def marshal(chunk):
            return _StreamStubMB(np.ones(len(chunk), dtype=np.int8),
                                 slots=np.zeros(len(chunk), dtype=np.int32))

        results = list(P.stream_epoch([[True] * 4] * 3, marshal, prog, registry=("rx", "ry")))
        assert prog.registry_calls == 3
        assert all(r.ok for r in results)

    def test_peak_host_memory_is_chunk_scale_not_epoch_scale(self):
        """An epoch-sized stream of 4 MB chunks never holds more than
        inflight + 1 chunks' operands on the host."""
        chunk_bytes = 4 * 1024 * 1024
        n_chunks = 16
        prog = _StreamStubProgram()

        def marshal(chunk):
            return _StreamStubMB(np.ones(chunk_bytes, dtype=np.uint8) * len(chunk))

        tracemalloc.start()
        try:
            base = tracemalloc.get_traced_memory()[0]
            ok = all(r.ok for r in P.stream_epoch([[True]] * n_chunks, marshal, prog,
                                                  inflight=2))
            peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        assert ok
        # whole epoch = 64 MB of operands; the stream may hold ~3
        assert peak - base < 4 * chunk_bytes

    def test_real_program_streams_in_order(self, mesh8):
        prog = P.ShardedVerifyProgram(mesh8, _stub_kernel)

        def marshal(chunk):
            return _ShardedStubMB(_stub_args(chunk), len(chunk))

        chunks = [[True] * 8, [True] * 7 + [False], [True] * 16]
        results = list(P.stream_epoch(chunks, marshal, prog))
        assert [r.ok for r in results] == [True, False, True]
        assert list(results[1].verdicts) == [True] * 7 + [False]


# ---------------------------------------------------------------------------
# Registry mirror partitioning (ingest cache)
# ---------------------------------------------------------------------------


class _FakeFp:
    def __init__(self, v):
        self.v = v


class _FakeKey:
    def __init__(self, i):
        self.point = (_FakeFp(2 * i + 1), _FakeFp(2 * i + 2))


class _FakeValidatorCache:
    def __init__(self, n):
        self._keys = [_FakeKey(i) for i in range(n)]

    def __len__(self):
        return len(self._keys)

    def get(self, i):
        return self._keys[i]


class TestShardedRegistryMirror:
    def test_per_seat_bytes_shrink_with_mesh_width(self):
        from lighthouse_tpu_torch.ingest import PubkeyLimbCache

        cache = PubkeyLimbCache(device="cpu")
        assert cache.sync_registry(_FakeValidatorCache(37)) == 37
        full_cols = cache.registry_device()[0].shape[1]
        assert full_cols == 37
        per_seat = {}
        for width in (1, 2, 4, 8):
            rx, ry = cache.registry_device_sharded(M.make_mesh(width, device="cpu"))
            assert len(rx) == len(ry) == width
            shard_cols = rx[0].shape[1]
            assert all(x.shape[1] == shard_cols for x in rx)
            assert shard_cols * width == 37 + ((-37) % width)  # padded, not grown
            per_seat[width] = shard_cols
            # each shard its own tensor: no view of a full mirror
            assert all(x.untyped_storage().nbytes() == x.nbytes for x in rx)
            host = np.hstack([x.numpy() for x in rx])
            assert np.array_equal(host[:, :37], cache.registry_columns(np.arange(37))[0])
            assert not host[:, 37:].any()
        assert per_seat[1] == 37
        assert per_seat[8] == 5  # ceil(37 / 8)
        assert per_seat[1] > per_seat[2] > per_seat[4] > per_seat[8]

    def test_registry_growth_invalidates_the_sharded_mirror(self):
        from lighthouse_tpu_torch.ingest import PubkeyLimbCache

        cache = PubkeyLimbCache(device="cpu")
        cache.sync_registry(_FakeValidatorCache(8))
        mesh = M.make_mesh(8, device="cpu")
        first = cache.registry_device_sharded(mesh)
        assert cache.registry_device_sharded(mesh) is first  # cached
        cache.sync_registry(_FakeValidatorCache(16))
        second = cache.registry_device_sharded(mesh)
        assert second is not first
        assert sum(x.shape[1] for x in second[0]) == 16


def test_sharded_program_runs_each_seat_under_its_seat_context(monkeypatch, mesh8):
    """The placement, the registry gather and every seat's verify run under
    mesh.seat_context of the seat."""
    entered = []
    real = M.seat_context

    def spy(device):
        entered.append(torch.device(device))
        return real(device)

    monkeypatch.setattr(M, "seat_context", spy)
    prog = P.ShardedVerifyProgram(mesh8, _stub_kernel)
    prog.verdict_vector(_stub_args([True] * 8))
    assert len(entered) >= 8 * 2  # placement and verify, per seat
    entered.clear()
    reg = TestPartitionedRegistry()
    rprog = P.ShardedVerifyProgram(mesh8, reg._reg_kernel, pk_wrap=reg._pk_wrap)
    slots = np.arange(8, dtype=np.int32)
    assert rprog.verdict_vector_registry(reg._registry(mesh8), slots,
                                         reg._rest_args(slots, [True] * 8)).all()
    assert len(entered) >= 8 * 4  # slots, operands, gather, verify
