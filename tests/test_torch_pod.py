"""The port's pod (lighthouse_tpu_torch/parallel/pod.py): twins of
tests/test_pod.py, the per-shard fault-domain chaos suite, on a mesh of 8
CPU seats (``make_mesh(8, device="cpu")``, the counterpart of the
reference's 8 virtual CPU devices): the shard planner, the device health
tracker, backend-mode dispatch through a stub program on each seat's
backend, and every injected fault: shard-drop mid-batch (re-shard,
identical verdicts), device-hang (timeout, exclusion, probe re-arm),
corrupt-shard-result (ladder re-verify), all seats down (CPU ladder),
fault-sequence determinism under a pinned seed and randomized fault
corpora against the single-device oracle.

The injected ``resilient`` is the port's own ``ResilientVerifier``
(lighthouse_tpu_torch/beacon/processor.py), and the guarded stuck-true test
attaches the port's ``IntegrityGuard`` (lighthouse_tpu_torch/integrity/),
which drives the pod through its surface.  The reference's never-raise-registry test waits for the port of
the analysis package.
"""

import threading
import time

import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu_torch.beacon.processor import CircuitBreaker, ResilientVerifier
from lighthouse_tpu_torch.parallel import mesh as MESH
from lighthouse_tpu_torch.parallel.pod import (
    DeviceHealth,
    PodVerifier,
    _slice_tree,
    mesh_width,
    plan_shards,
)
from lighthouse_tpu_torch.utils import faults
from lighthouse_tpu_torch.utils.faults import DeviceFault, FaultInjector

pytestmark = pytest.mark.chaos

SEATS = list(MESH.make_mesh(8, device="cpu").seats)


@pytest.fixture(autouse=True)
def _clean_global_injector():
    faults.INJECTOR.disarm()
    yield
    faults.INJECTOR.disarm()


# ---------------------------------------------------------------------------
# Harness: a list-of-bools "signature set" batch.  A set IS its verdict,
# so the single-device oracle is trivially [bool(s) for s in sets] and
# every pod outcome can be checked byte-for-byte against it.
# ---------------------------------------------------------------------------


class StubMB:
    """Marshalled-batch stand-in: one (1, B) int tensor, trailing batch."""

    def __init__(self, arr):
        self.args = (arr,)
        self.B = arr.shape[-1]
        self.invalid = []


class StubBackend:
    """Backend-mode surface: marshal + width-keyed program + resolve, and
    one backend per seat (``for_device``), recorded."""

    def __init__(self):
        self.kernel_widths = []
        self.seats = []
        self._lock = threading.Lock()

    def marshal_sets(self, sets):
        return StubMB(torch.tensor([[1 if s else 0 for s in sets]], dtype=torch.int32))

    def for_device(self, device):
        with self._lock:
            self.seats.append(device)
        return self

    def _program(self, width):
        with self._lock:
            self.kernel_widths.append(width)
        return lambda a: torch.all(a != 0)

    def resolve(self, handle):
        return bool(handle)


def _oracle(sets):
    return [bool(s) for s in sets]


def _all(sets):
    if not all(sets):
        return False
    return True


def make_pod(injector=None, backend=None, shard_verify=None,
             devices=None, **kw):
    """A PodVerifier over a fresh ResilientVerifier whose device and CPU
    rungs are the list-conjunction oracle (virtual clock: no sleeps)."""
    clock = [0.0]
    breaker = CircuitBreaker(failure_threshold=3, now=lambda: clock[0])
    resilient = ResilientVerifier(
        device_verify=_all,
        cpu_verify=_all,
        breaker=breaker,
        now=lambda: clock[0],
        injector=FaultInjector(),
    )
    if backend is None and shard_verify is None:
        backend = StubBackend()
    pod = PodVerifier(
        resilient,
        backend=backend,
        shard_verify=shard_verify,
        devices=devices if devices is not None else SEATS,
        injector=injector if injector is not None else FaultInjector(),
        backoff_base=0.0,
        **kw,
    )
    return pod, resilient


# ---------------------------------------------------------------------------
# Planner / health units
# ---------------------------------------------------------------------------


class TestPlanner:
    def test_mesh_width_is_the_ladder_rung(self):
        assert [mesh_width(n) for n in (0, 1, 2, 3, 5, 7, 8, 9)] == [
            0, 1, 2, 2, 4, 4, 8, 8,
        ]

    def test_plan_shards_covers_contiguously(self):
        plan = plan_shards(10, 4)
        assert plan.bounds == ((0, 3), (3, 6), (6, 8), (8, 10))
        # power-of-two batch on power-of-two mesh: exactly even
        plan = plan_shards(16, 8)
        assert all(b - a == 2 for a, b in plan.bounds)
        # more shards than work: trailing ranges are empty, callers skip
        plan = plan_shards(2, 4)
        assert plan.bounds == ((0, 1), (1, 2), (2, 2), (2, 2))

    def test_slice_tree_shapes(self):
        class LFpLike:
            def __init__(self, limbs, bound):
                self.limbs, self.bound = limbs, bound

        arr = torch.arange(24).reshape(3, 8)
        lfp = LFpLike(arr, 5)
        sliced = _slice_tree((lfp, (arr, "meta")), 2, 5)
        assert sliced[0].limbs.shape == (3, 3) and sliced[0].bound == 5
        assert sliced[1][0].shape == (3, 3) and sliced[1][1] == "meta"


class TestDeviceHealth:
    def test_threshold_excludes_and_probe_cycle_rearms(self):
        h = DeviceHealth(4, exclusion_threshold=2, probe_after=1)
        assert not h.record_failure(1)  # 1 of 2
        assert h.record_failure(1)      # crossed: newly excluded
        assert h.healthy() == [0, 2, 3] and h.excluded() == [1]
        assert not h.record_failure(1)  # already out: not "newly"
        assert h.probe_ready() == []    # cooldown still pending
        h.tick()
        assert h.probe_ready() == [1]
        h.defer_probe(1)                # failed probe restarts cooldown
        assert h.probe_ready() == []
        h.tick()
        h.rearm(1)
        assert h.healthy() == [0, 1, 2, 3] and h.excluded() == []

    def test_success_resets_consecutive_score(self):
        h = DeviceHealth(2, exclusion_threshold=2)
        h.record_failure(0)
        h.record_success(0)
        assert not h.record_failure(0)  # score restarted, not cumulative
        assert h.excluded() == []


# ---------------------------------------------------------------------------
# Backend-mode dispatch on the virtual 8-device mesh
# ---------------------------------------------------------------------------


class TestBackendMode:
    def test_clean_round_shards_across_all_devices(self):
        backend = StubBackend()
        pod, resilient = make_pod(backend=backend)
        out = pod.verify_batch([True] * 16)
        assert out.verdicts == [True] * 16
        assert out.device_calls == 8  # one shard per device
        assert resilient.journal == [("pod", 16)]
        assert sorted(backend.kernel_widths) == [2] * 8
        assert backend.seats == SEATS  # each shard on its seat's backend

    def test_invalid_set_takes_the_ladder_byte_identical(self):
        sets = [True, True, False, True] * 2
        pod, resilient = make_pod()
        out = pod.verify_batch(sets)
        assert out.verdicts == _oracle(sets)
        # pod saw the False conjunction and handed the ORIGINAL sets to
        # the single-device bisection ladder
        assert ("pod", len(sets)) not in resilient.journal
        assert any(kind == "device" for kind, _ in resilient.journal)

    def test_empty_batch_short_circuits(self):
        pod, _ = make_pod()
        out = pod.verify_batch([])
        assert out.verdicts == [] and out.device_calls == 0

    def test_maybe_build_needs_shard_surface(self, monkeypatch):
        _, resilient = make_pod()
        assert PodVerifier.maybe_build(resilient) is None
        # below two visible CUDA devices the pod is never wired
        assert PodVerifier.maybe_build(resilient, backend=StubBackend()) is None
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
        assert PodVerifier.maybe_build(resilient) is None
        assert PodVerifier.maybe_build(resilient, backend=object()) is None
        pod = PodVerifier.maybe_build(resilient, backend=StubBackend())
        assert isinstance(pod, PodVerifier)
        assert pod.devices() == [torch.device("cuda", i) for i in range(8)]

    def test_passes_through_pipelined_verifier_surface(self):
        pod, resilient = make_pod()
        assert pod.breaker is resilient.breaker
        assert pod.journal is resilient.journal


# ---------------------------------------------------------------------------
# Chaos: the fault corpus
# ---------------------------------------------------------------------------


class TestShardDrop:
    def test_drop_mid_batch_reshards_and_stays_byte_identical(self):
        from lighthouse_tpu_torch.utils import metrics as M

        inj = FaultInjector()
        inj.arm("pod.dispatch", "shard-drop", times=1)
        pod, resilient = make_pod(
            injector=inj, max_shard_retries=0, exclusion_threshold=1,
        )
        reshards0 = M.POD_RESHARDS.value()
        sets = [True] * 16
        out = pod.verify_batch(sets)
        assert out.verdicts == _oracle(sets)  # never drops the batch
        assert out.device_calls == 4          # 8 -> 4 surviving mesh
        assert M.POD_RESHARDS.value() == reshards0 + 1
        assert inj.fired_sequence() == (("pod.dispatch", "shard-drop"),)
        assert len(pod.health.excluded()) == 1
        assert resilient.journal == [("pod", 16)]

    def test_retry_rescues_a_transient_drop_without_resharding(self):
        from lighthouse_tpu_torch.utils import metrics as M

        inj = FaultInjector()
        inj.arm("pod.dispatch", "shard-drop", times=1)
        pod, resilient = make_pod(
            injector=inj, max_shard_retries=2, exclusion_threshold=2,
        )
        reshards0 = M.POD_RESHARDS.value()
        retries0 = M.POD_RETRIES.value()
        out = pod.verify_batch([True] * 16)
        assert out.verdicts == [True] * 16
        assert out.device_calls == 8          # full mesh held
        assert M.POD_RESHARDS.value() == reshards0
        assert M.POD_RETRIES.value() == retries0 + 1
        assert pod.health.excluded() == []


class TestDeviceHang:
    def test_hang_times_out_then_excludes_then_probe_rearms(self):
        from lighthouse_tpu_torch.utils import metrics as M

        inj = FaultInjector()
        # one hang, far past the shard timeout.  The timeout carries a
        # wide margin over the (trivial) honest-shard work so a loaded
        # host can't starve honest threads into spurious exclusion.
        inj.arm("pod.dispatch", "device-hang", delay=6.0, times=1)
        pod, _ = make_pod(
            injector=inj, shard_timeout=1.0, max_shard_retries=0,
            exclusion_threshold=1, probe_after=1,
        )
        rearms0 = M.POD_REARMS.value()
        t0 = time.monotonic()
        out = pod.verify_batch([True] * 8)
        assert out.verdicts == [True] * 8     # round 2 on the survivors
        assert time.monotonic() - t0 < 5.0    # timeout, not the full hang
        assert len(pod.health.excluded()) == 1
        # next batch: cooldown has aged, the healthy round's probe shard
        # succeeds (the hang was times=1) and the device re-arms
        out = pod.verify_batch([True] * 8)
        assert out.verdicts == [True] * 8 and out.device_calls == 4
        assert pod.health.excluded() == []
        assert M.POD_REARMS.value() == rearms0 + 1
        # full-width mesh restored
        assert pod.verify_batch([True] * 8).device_calls == 8


class TestCorruptShardResult:
    def test_corrupted_gather_falls_to_ladder_byte_identical(self):
        inj = FaultInjector()
        inj.arm("pod.gather", "corrupt-shard-result", times=1)
        pod, resilient = make_pod(injector=inj)
        sets = [True] * 16
        out = pod.verify_batch(sets)
        # the inverted shard verdict makes the conjunction False; the
        # ladder re-verifies the ORIGINAL sets, so the corruption costs
        # latency, never correctness
        assert out.verdicts == _oracle(sets)
        assert inj.fired_sequence() == (("pod.gather", "corrupt-shard-result"),)
        assert ("pod", 16) not in resilient.journal


class _StubCorpus:
    """Bool-harness canary corpus: the real BLS corpus can't flow through
    the list-of-bools pod, so the known answers ARE bools.  Invalid-first,
    like the real one — the stuck-true lie must be probeable."""

    def batches(self, k=2):
        return [([False], False), ([True], True)]

    def rotate(self, epoch):
        pass


class TestSilentStuckTrueGap:
    """The False->True verdict lie at pod.gather: without the integrity
    guard the pod WRONG-ACCEPTS (the pinned gap this layer closes); with
    the guard the canary catches it, the batch re-ladders to the CPU
    oracle, and every lying device is quarantined."""

    def test_unguarded_pod_wrong_accepts_the_stuck_true_lie(self):
        inj = FaultInjector()
        # the CLI-facing spec form: targeted False->True flip, unbounded
        inj.arm_from_spec("pod.gather=corrupt-shard-result:stuck-true")
        pod, _ = make_pod(injector=inj)
        sets = [True] * 15 + [False]
        out = pod.verify_batch(sets)
        # every shard verdict comes back True, the conjunction holds, and
        # the invalid set sails through: the wrong accept, pinned
        assert out.verdicts == [True] * 16
        assert out.verdicts != _oracle(sets)

    def test_guarded_pod_catches_reladders_and_quarantines(self):
        from lighthouse_tpu_torch.integrity import IntegrityGuard

        inj = FaultInjector()
        inj.arm("pod.gather", "silent-stuck-true")
        pod, resilient = make_pod(injector=inj)
        guard = IntegrityGuard(
            pod, resilient, corpus=_StubCorpus(), strike_threshold=1,
        )
        guard.attach_pod(pod)
        sets = [True] * 15 + [False]
        out = guard.verify_batch(sets)
        # the invalid-first canary came back True: dispatch distrusted,
        # real sets re-verified on the CPU oracle — correct verdicts out
        assert out.verdicts == _oracle(sets)
        assert guard.distrusted == 1 and guard.sdc_events == 1
        assert guard.reladdered_sets == 16
        # every device failed its canary probe and is out of the mesh
        assert guard.quarantined == set(range(8))
        assert pod.health.healthy() == []
        assert resilient.breaker.consecutive_failures >= 1
        # lie disarmed: the canary-only probe is the readmission gate
        inj.disarm()
        assert pod.device_canary_probe(0) is True


class TestAllDevicesDown:
    def test_mesh_exhaustion_lands_on_the_cpu_ladder(self):
        inj = FaultInjector()
        inj.arm("pod.dispatch", "shard-drop")  # unbounded: every shard
        clock = [0.0]
        breaker = CircuitBreaker(failure_threshold=3, now=lambda: clock[0])
        resilient = ResilientVerifier(
            device_verify=lambda s: (_ for _ in ()).throw(
                DeviceFault("device down")
            ),
            cpu_verify=_all,
            breaker=breaker,
            now=lambda: clock[0],
            injector=FaultInjector(),
        )
        pod = PodVerifier(
            resilient, shard_verify=_all, devices=list(range(8)),
            injector=inj, exclusion_threshold=1, max_shard_retries=0,
            backoff_base=0.0,
        )
        sets = [True] * 8
        out = pod.verify_batch(sets)
        assert out.verdicts == _oracle(sets)  # the batch still lands
        assert pod.health.healthy() == []     # whole mesh excluded
        assert any(kind == "cpu" for kind, _ in resilient.journal)

    def test_open_breaker_stands_the_pod_down(self):
        pod, resilient = make_pod()
        for _ in range(3):
            resilient.breaker.record_failure()
        assert not resilient.breaker.allow_device()
        out = pod.verify_batch([True] * 8)
        assert out.verdicts == [True] * 8
        # no pod round ran: the ladder (breaker-gated to CPU) served it
        assert ("pod", 8) not in resilient.journal


class TestDeterminismAndCorpus:
    def _run_once(self, seed):
        inj = FaultInjector(seed=seed)
        inj.arm("pod.dispatch", "shard-drop", probability=0.5)
        pod, _ = make_pod(
            injector=inj, shard_verify=_all, devices=list(range(8)),
            exclusion_threshold=1, max_shard_retries=0,
        )
        verdicts = []
        for _ in range(4):
            verdicts.append(pod.verify_batch([True] * 8).verdicts)
        return inj.fired_sequence(), verdicts

    def test_pinned_seed_pins_the_fault_sequence(self):
        seq1, v1 = self._run_once(42)
        seq2, v2 = self._run_once(42)
        assert seq1 == seq2 and v1 == v2
        assert len(seq1) > 0, "the corpus must actually bite"
        seq3, _ = self._run_once(43)
        assert seq3 != seq1  # a different seed draws a different stream

    def test_randomized_fault_corpus_matches_the_oracle(self):
        import random

        for seed in range(6):
            rng = random.Random(seed)
            inj = FaultInjector(seed=seed)
            inj.arm("pod.dispatch", "shard-drop", probability=0.3)
            pod, _ = make_pod(
                injector=inj, exclusion_threshold=2, max_shard_retries=1,
                probe_after=1,
            )
            for _ in range(5):
                sets = [rng.random() < 0.8 for _ in range(rng.choice([5, 8, 16]))]
                out = pod.verify_batch(sets)
                assert out.verdicts == _oracle(sets), (
                    f"seed {seed}: pod diverged from the oracle"
                )

    def test_corrupt_corpus_matches_the_oracle(self):
        for seed in range(4):
            inj = FaultInjector(seed=seed)
            inj.arm("pod.gather", "corrupt-shard-result", probability=0.4)
            pod, _ = make_pod(injector=inj)
            for _ in range(4):
                sets = [True] * 8
                assert pod.verify_batch(sets).verdicts == _oracle(sets)


class TestNeverRaise:
    def test_backstop_fails_closed_on_coordinator_bugs(self):
        pod, _ = make_pod()
        pod._pod_verify = lambda sets: (_ for _ in ()).throw(
            RuntimeError("coordinator bug")
        )
        out = pod.verify_batch([True, True])
        assert out.verdicts == [False, False] and out.device_calls == 0


    def test_backstop_fails_closed_on_a_raising_ladder(self):
        """A ladder that raises (a bug below the pod) is absorbed too."""
        pod, resilient = make_pod()
        resilient.verify_batch = lambda sets: (_ for _ in ()).throw(RuntimeError("ladder bug"))
        sets = [True, False, True]
        assert pod.verify_batch(sets).verdicts == [False] * 3


def test_coordinator_runs_each_shard_under_its_seat_context(monkeypatch):
    """The per-seat coordinator runs each shard's program (and the sharded
    road each seat's) under mesh.seat_context of its seat."""
    entered = []
    real = MESH.seat_context

    def spy(device):
        entered.append(device)
        return real(device)

    monkeypatch.setattr(MESH, "seat_context", spy)
    pod, _ = make_pod()
    assert pod.verify_batch([True] * 16).device_calls == 8
    assert sorted(entered, key=str) == sorted(SEATS, key=str)


def test_warm_compile_builds_each_rung_on_each_seat_backend(monkeypatch):
    """warm_compile builds, under each device's seat_context, the seat batch
    of every padded batch size at every rung (the mesh's width down to 1),
    once per device; a size below the backend's smallest is skipped, and
    list mode warms nothing."""

    class WarmBackend(StubBackend):
        def __init__(self):
            super().__init__()
            self.warmed = []

        def _padded_size(self, n):
            B = 8
            while B < n:
                B *= 2
            return B

        def warm_compile(self, B):
            self.warmed.append((B, entered[-1] if entered else None))
            return B >= 8

    entered = []
    real = MESH.seat_context

    def spy(device):
        entered.append(device)
        return real(device)

    monkeypatch.setattr(MESH, "seat_context", spy)
    backend = WarmBackend()
    pod, _ = make_pod(backend=backend)
    cpu = torch.device("cpu")
    assert pod.warm_compile([100]) == [(cpu, 16), (cpu, 32), (cpu, 64), (cpu, 128)]
    assert pod.warm_compile([16], widths=(8, 2)) == [(cpu, 8)]
    assert [b for b, _ in backend.warmed] == [16, 32, 64, 128, 2, 8]
    assert all(seat == cpu for _, seat in backend.warmed)
    assert make_pod(shard_verify=_all)[0].warm_compile([64]) == []
