"""The port's verdict-integrity layer (lighthouse_tpu_torch/integrity/): twins
of tests/test_integrity.py and the port's own pins.

The twins lock down the silent-data-corruption defenses: (1) the canary corpus is
oracle-true and rotates per epoch; (2) the clean path is a differential
no-op — guard-wrapped verdicts are byte-identical to the bare ladder
over a valid / tampered / aggregate-to-infinity mix (the mainnet-shape
fingerprint pin in test_scenario.py covers the engine side: the
scenario ladder is untouched unless an sdc track installs the guard);
(3) a canary mismatch marks the dispatch distrusted and re-ladders
through the CPU-oracle rung, never the lying inner path; (4) the
cross-arm auditor turns a byte-level verdict disagreement into an SDC
event and releases the independent reference vector; (5) the guard is
never-raise and its backstop fails closed; (6) the boot-time selfcheck
catches scalar- and kernel-path liars.  The reference's two ``sdc-storm``
scenario tests wait for the port of the scenario harness (ROADMAP), and its
never-raise-registry test for the port of the analysis package: its twin
here drives the backstop with every layer of the guard failing.

The port's own: the canary corpus byte for byte against the reference's
for the same (seed, epoch); the selfcheck over ``TorchBackend._programs``
(each verify key replayed under its own arm, the aggregate and epoch keys
listed and skipped, no key built) against the reference's ``_kernels``
read; the cross-arm audit through the other arm's key while another thread
dispatches under its own arm; the ``bls.device_verify`` site carrying no
verdict, in both packages; and, under ``slow``, the guarded stack over
``TorchBackend(device="cpu")`` on an 8-set batch with one bad set.
"""

import threading

import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu_torch.beacon.processor import (
    BatchOutcome,
    CircuitBreaker,
    ResilientVerifier,
)
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.crypto.bls.api import (
    SecretKey,
    Signature,
    SignatureSet,
    cpu_backend,
)
from lighthouse_tpu_torch.integrity import (
    CANARY_CORPUS,
    DEFAULT_K,
    REQUIRED_CHAOS_KINDS,
    CanaryCorpus,
    CrossArmAuditor,
    IntegrityGuard,
    TrustScore,
    run_selfcheck,
)

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _python_backend_active(monkeypatch):
    """The port has no active engine until one is set: ``SignatureSet.verify``
    and the stack run over the python oracle, the registry restored after."""
    monkeypatch.setattr(tapi, "_ACTIVE", [])
    tapi.set_backend("python")


def _mixed_sets():
    """Valid, tampered-message, and aggregate-to-infinity sets — the
    differential corpus the no-op proof byte-compares over."""
    sets = []
    for i in range(3):
        sk = SecretKey(900 + i)
        msg = bytes([i, 77]) * 16
        sets.append(SignatureSet(sk.sign(msg), [sk.public_key()], msg))
    sk = SecretKey(950)
    sets.append(
        SignatureSet(sk.sign(b"mm" * 16), [sk.public_key()], b"xx" * 16)
    )
    sets.append(SignatureSet(
        Signature.infinity(), [SecretKey(960).public_key()], b"aa" * 16,
    ))
    return sets


def _oracle(sets):
    return [bool(s.verify()) for s in sets]


def _real_resilient():
    clock = [0.0]
    verify = lambda s: cpu_backend().verify_signature_sets(s)  # noqa: E731
    return ResilientVerifier(
        device_verify=verify, cpu_verify=verify,
        breaker=CircuitBreaker(now=lambda: clock[0]),
        now=lambda: clock[0],
    )


class AllTrueVerifier:
    """A silently lying inner rung: every verdict True, nothing raises."""

    def __init__(self):
        self.calls = 0

    def verify_batch(self, sets):
        self.calls += 1
        return BatchOutcome([True] * len(sets), 1)


# ---------------------------------------------------------------------------
# Corpus
# ---------------------------------------------------------------------------


class TestCanaryCorpus:
    def test_entries_agree_with_the_scalar_oracle(self):
        cc = CanaryCorpus(seed=5)
        entries = cc.entries()
        assert [e.entry_id for e in entries] == [
            r[0] for r in CANARY_CORPUS
        ]
        for e in entries:
            for s in e.sets:
                assert bool(s.verify()) == e.expected

    def test_rotation_changes_material_not_identity(self):
        cc = CanaryCorpus(seed=5)
        e0, e1 = cc.entries(0), cc.entries(1)
        assert [e.entry_id for e in e0] == [e.entry_id for e in e1]
        assert [e.expected for e in e0] == [e.expected for e in e1]
        # keys + messages are (seed, epoch)-salted: the material differs
        assert e0[0].sets[0].message != e1[0].sets[0].message

    def test_batches_lead_with_an_invalid_canary(self):
        # invalid-first: a stuck-True device is the dangerous polarity,
        # so the first canary dispatched must be able to catch it
        batches = CanaryCorpus(seed=5).batches(DEFAULT_K)
        assert len(batches) == DEFAULT_K
        assert batches[0][1] is False
        assert {expected for _, expected in batches} == {True, False}

    def test_required_kinds_are_armable(self):
        from lighthouse_tpu_torch.utils import faults

        for kind in REQUIRED_CHAOS_KINDS:
            assert kind in faults._KINDS


# ---------------------------------------------------------------------------
# Differential no-op proof (clean path)
# ---------------------------------------------------------------------------


class TestDifferentialNoop:
    def test_guarded_verdicts_byte_identical_on_the_clean_path(self):
        sets = _mixed_sets()
        bare = _real_resilient()
        guarded = IntegrityGuard(
            _real_resilient(), _real_resilient(), corpus=CanaryCorpus(),
        )
        want = bare.verify_batch(list(sets)).verdicts
        got = guarded.verify_batch(list(sets)).verdicts
        assert got == want == _oracle(sets)
        assert guarded.distrusted == 0 and guarded.sdc_events == 0
        assert guarded.canary_checks == 1

    def test_disabled_guard_is_pure_passthrough(self):
        inner = AllTrueVerifier()
        guard = IntegrityGuard(inner, None, k=0)
        out = guard.verify_batch([object(), object()])
        assert out.verdicts == [True, True]
        assert inner.calls == 1 and guard.canary_checks == 0


# ---------------------------------------------------------------------------
# Distrust + re-ladder
# ---------------------------------------------------------------------------


class TestDistrust:
    def test_canary_mismatch_reladders_through_the_cpu_rung(self):
        sets = _mixed_sets()
        lying = AllTrueVerifier()
        resilient = _real_resilient()
        guard = IntegrityGuard(lying, resilient, corpus=CanaryCorpus())
        out = guard.verify_batch(list(sets))
        # the lying inner said True for the invalid canary, so the whole
        # dispatch is distrusted and the real sets re-verify on the CPU
        # oracle — correct verdicts, not the liar's
        assert out.verdicts == _oracle(sets)
        assert guard.distrusted == 1 and guard.sdc_events == 1
        assert guard.reladdered_sets == len(sets)
        # the breaker heard about it: a lying device is a sick device
        assert resilient.breaker.consecutive_failures >= 1
        # the liar only ever saw the first canary batch, never the reals
        assert lying.calls == 1

    def test_backstop_fails_closed_and_never_raises(self):
        class Exploding:
            def verify_batch(self, sets):
                raise RuntimeError("kaboom")

        guard = IntegrityGuard(Exploding(), None, corpus=CanaryCorpus())
        out = guard.verify_batch([object(), object(), object()])
        assert out.verdicts == [False, False, False]
        assert guard.guard_backstops == 1

    def test_never_raises_when_every_layer_of_it_fails(self):
        """The twin of the reference's never-raise-registry test: the port
        has no analysis package, so the contract is driven instead — a
        corpus, an auditor and a trust table that all raise still give an
        all-False outcome, counted, never an exception."""
        class Broken:
            def batches(self, k):
                raise RuntimeError("corpus gone")

            def rotate(self, epoch):
                raise RuntimeError("corpus gone")

        guard = IntegrityGuard(AllTrueVerifier(), None, corpus=Broken())
        assert guard.verify_batch([object(), object()]).verdicts == [False, False]
        guard = IntegrityGuard(AllTrueVerifier(), None, k=0)
        guard.auditor = None  # the audit layer itself gone
        assert guard.verify_batch([object()]).verdicts == [False]
        assert guard.guard_backstops == 1


# ---------------------------------------------------------------------------
# Cross-arm audit
# ---------------------------------------------------------------------------


class TestCrossArmAudit:
    def test_cpu_floor_disagreement_is_an_sdc_event(self):
        sets = _mixed_sets()
        auditor = CrossArmAuditor(
            lambda s: cpu_backend().verify_signature_sets(s), fraction=1.0,
        )
        guard = IntegrityGuard(
            AllTrueVerifier(), None, k=0, auditor=auditor,
        )
        out = guard.verify_batch(list(sets))
        # the inner lied True on the tampered set; the audit's oracle
        # reference vector is released instead
        assert out.verdicts == _oracle(sets)
        assert guard.audits == 1 and guard.sdc_events == 1
        assert guard.reladdered_sets == len(sets)

    def test_agreeing_audit_changes_nothing(self):
        sets = _mixed_sets()[:3]  # all valid: the liar happens to agree
        auditor = CrossArmAuditor(
            lambda s: cpu_backend().verify_signature_sets(s), fraction=1.0,
        )
        guard = IntegrityGuard(
            AllTrueVerifier(), None, k=0, auditor=auditor,
        )
        out = guard.verify_batch(list(sets))
        assert out.verdicts == [True, True, True]
        assert guard.audits == 1 and guard.sdc_events == 0

    def test_fraction_zero_never_samples(self):
        auditor = CrossArmAuditor(lambda s: True, fraction=0.0)
        assert auditor.maybe_audit([object()]) is None


# ---------------------------------------------------------------------------
# Trust scoring
# ---------------------------------------------------------------------------


class TestTrustScore:
    def test_strike_crosses_threshold_exactly_once(self):
        t = TrustScore(strike_threshold=2)
        assert t.strike(3) is False          # 1 strike: below threshold
        assert t.strike(3) is True           # 2nd crosses it
        assert t.strike(3) is False          # already quarantined
        assert t.quarantined(3) and not t.quarantined(4)

    def test_clear_readmits(self):
        t = TrustScore(strike_threshold=1)
        assert t.strike(0) is True
        t.clear(0)
        assert not t.quarantined(0) and t.score(0) == 0

    def test_threshold_must_be_positive(self):
        with pytest.raises(ValueError):
            TrustScore(strike_threshold=0)


# ---------------------------------------------------------------------------
# Boot-time selfcheck
# ---------------------------------------------------------------------------


class TestSelfcheck:
    def test_honest_backend_passes(self):
        report = run_selfcheck(cpu_backend())
        assert report.ok and report.checked == len(CANARY_CORPUS)

    def test_scalar_liar_fails(self):
        class StuckTrue:
            name = "stuck-true"

            def verify_signature_sets(self, sets):
                return True

        report = run_selfcheck(StuckTrue())
        assert not report.ok
        invalid = sum(1 for r in CANARY_CORPUS if r[1] == "invalid")
        assert len(report.mismatches) == invalid

    def test_kernel_path_liar_fails_per_installed_batch_size(self):
        class KernelLiar:
            """Honest scalar path, lying B=2 kernel — the regime the
            selfcheck exists for (a prewarmed cached program gone bad)."""

            name = "kernel-liar"
            # the port's program table: a verify key (B, device_h2c, mxu,
            # chains, wsm) where the reference's test holds ("agg", 2)
            _programs = {(2, True, False, False, False): object()}

            def verify_signature_sets(self, sets):
                return all(bool(s.verify()) for s in sets)

            def marshal_sets(self, sets):
                class MB:
                    invalid = False
                return MB()

            def dispatch(self, mb):
                return mb

            def resolve(self, handle):
                return True

        report = run_selfcheck(KernelLiar())
        assert report.batch_sizes == (2,)
        assert not report.ok
        assert all("B=2" in m for m in report.mismatches)


# ---------------------------------------------------------------------------
# Stack + serve wiring
# ---------------------------------------------------------------------------


class TestStackWiring:
    def test_python_backend_auto_leaves_the_oracle_unguarded(self):
        from lighthouse_tpu_torch.serve.stack import build_verify_stack

        stack = build_verify_stack()
        # scalar python backend: no ingest split, the backend IS the
        # oracle — auto wires no guard
        if stack.ingest is None:
            assert stack.integrity is None
            assert stack.verifier is (stack.pod or stack.resilient)
        else:
            assert stack.integrity is stack.verifier

    def test_forced_integrity_wraps_and_stays_correct(self):
        from lighthouse_tpu_torch.serve.stack import build_verify_stack

        stack = build_verify_stack(integrity=True)
        assert isinstance(stack.integrity, IntegrityGuard)
        assert stack.verifier is stack.integrity
        sets = _mixed_sets()
        assert stack.verifier.verify_batch(sets).verdicts == _oracle(sets)

    def test_serve_rotate_epoch_reaches_the_guard(self):
        from lighthouse_tpu_torch.serve.service import VerifyService
        from lighthouse_tpu_torch.serve.stack import build_verify_stack

        stack = build_verify_stack(integrity=True)
        svc = VerifyService(stack.verifier, breaker=stack.breaker)
        assert stack.integrity.corpus.epoch == 0
        svc.rotate_epoch(7)
        assert stack.integrity.corpus.epoch == 7
        # a plain verifier has no rotate: the hook is a no-op, not a crash
        VerifyService(_real_resilient()).rotate_epoch(3)


# ---------------------------------------------------------------------------
# The port's own: differentials and pins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 1), (5, 3), (2**40 + 7, 12)])
def test_canary_corpus_bytes_match_the_reference(seed, epoch):
    from lighthouse_tpu.integrity.corpus import CanaryCorpus as JCorpus

    ref = JCorpus(seed=seed, oracle_check=False).entries(epoch)
    got = CanaryCorpus(seed=seed, oracle_check=False).entries(epoch)
    assert [e.entry_id for e in got] == [e.entry_id for e in ref]
    assert [e.expected for e in got] == [e.expected for e in ref]
    for g, r in zip(got, ref):
        (gs,), (rs,) = g.sets, r.sets
        assert gs.message == rs.message
        assert gs.signature.to_bytes() == rs.signature.to_bytes()
        assert [k.to_bytes() for k in gs.signing_keys] == [k.to_bytes() for k in rs.signing_keys]
    assert CanaryCorpus(seed=seed).batches(3)[0][1] is False


def _stub_program(monkeypatch, seen, hold=None):
    """Replace the device program of every verify key made from now on by a
    stub that records (B, the gates its thread sees) and answers True; with
    ``hold``, (entered, release) events, it waits inside the program."""
    from lighthouse_tpu_torch.crypto.bls.torch_backend import backend as TB
    from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F

    def stub(pk_aff, sig_aff, u0, u1, wbits):
        seen.append((wbits.shape[-1], F.chains_active(), F.wsm_fused_active(),
                     F.mxu_active(), threading.current_thread().name))
        if hold is not None and threading.current_thread().name == "audit":
            hold[0].set()
            assert hold[1].wait(30)
        return torch.tensor(True)

    monkeypatch.setattr(TB, "_verify_kernel_h2c", stub)
    monkeypatch.setattr(F, "_CHAINS_MODE", False)
    monkeypatch.setattr(F, "_WSM_MODE", False)
    monkeypatch.setattr(F, "_MXU_MODE", False)
    monkeypatch.setattr(F, "_MXU_PLAN", None)
    monkeypatch.delenv("LIGHTHOUSE_TPU_MXU", raising=False)
    return TB


def test_selfcheck_replays_each_verify_key_of_the_programs_under_its_own_arm(monkeypatch):
    """The port's selfcheck reads TorchBackend._programs: every verify key is
    replayed at its own batch size under its own arm (the canary tiled or cut
    to its columns), the aggregate and epoch keys are listed as skipped, and
    no key is built.  The stub program answers True, so exactly the invalid
    canaries mismatch, on every key."""
    seen = []
    TB = _stub_program(monkeypatch, seen)
    be = TB.TorchBackend(device="cpu")
    verify_keys = [(8, True, False, False, False), (4, True, False, False, False),
                   (32, True, True, False, False), (16, True, True, True, True)]
    for key in verify_keys:
        be._program_for(key)
    be._program_for(("agg", 4, False, False, False))
    be._programs[("epoch", 8, 16, False, False, False)] = object()  # never run
    before = set(be._programs)
    report = run_selfcheck(be)
    assert set(be._programs) == before  # no key built
    assert report.keys == tuple(sorted(verify_keys))
    assert report.batch_sizes == (4, 8, 16, 32)
    assert report.skipped == (("agg", 4, False, False, False),
                              ("epoch", 8, 16, False, False, False))
    n_invalid = sum(1 for r in CANARY_CORPUS if r[1] == "invalid")
    assert len(report.mismatches) == n_invalid * (1 + len(verify_keys))
    # the kernel path: one run per (key, entry), at the key's B and arm
    runs = [r[:4] for r in seen[len(CANARY_CORPUS):]]
    assert runs == [(B, chains, wsm, mxu) for B, _, mxu, chains, wsm in sorted(verify_keys)
                    for _ in CANARY_CORPUS]


def test_reference_selfcheck_reads_an_agg_key_as_a_verify_size():
    """The finding the port's selfcheck answers (ROADMAP Queue 3): the
    reference's _installed_batch_sizes takes the n of an ("agg", n) key for
    a batch-verify size, so its sweep checks (and on first use builds) a
    verify kernel at B = n, never the aggregate program it found."""
    from lighthouse_tpu.integrity import selfcheck as JS

    class Held:
        _kernels = {("agg", 64): object()}

    assert JS._installed_batch_sizes(Held()) == [64]
    from lighthouse_tpu_torch.integrity.selfcheck import installed_keys

    class PortHeld:
        _programs = {("agg", 64, False, False, False): object()}

    assert installed_keys(PortHeld()) == ([], [("agg", 64, False, False, False)])


def test_audit_runs_its_arm_pinned_while_another_thread_dispatches(monkeypatch):
    """The cross-arm audit under mxu13 holds the 13-bit arm on its own thread
    only: a dispatch on another thread while the audit's program runs keeps
    the default arm (its key and the gates its program reads), and the
    process-wide gates never move.  (The reference flips fp.set_mxu for the
    whole process around its audit.)"""
    from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F

    seen = []
    entered, release = threading.Event(), threading.Event()
    TB = _stub_program(monkeypatch, seen, hold=(entered, release))
    be = TB.TorchBackend(device="cpu")
    sk = SecretKey(77)
    sets = [SignatureSet(sk.sign(b"audit" * 6 + b"!!"), [sk.public_key()], b"audit" * 6 + b"!!")]
    auditor = CrossArmAuditor(lambda s: True, backend=be, arms=("mxu13",), fraction=1.0)
    out = {}

    def audit():
        out["audit"] = auditor.maybe_audit(sets)

    t = threading.Thread(target=audit, name="audit")
    t.start()
    assert entered.wait(30)
    # the audit is inside its mxu13 program: dispatch the default arm here
    mid_gate = F.mxu_active()
    other = {}

    def dispatch():
        other["verdict"] = be.resolve(be.dispatch(be.marshal_sets(sets)))

    d = threading.Thread(target=dispatch, name="shard")
    d.start()
    d.join(30)
    release.set()
    t.join(30)
    assert out["audit"] == ([True], "mxu13") and other["verdict"] is True
    by_thread = {name: (B, chains, wsm, mxu) for B, chains, wsm, mxu, name in seen}
    assert by_thread["audit"] == (8, False, False, True)
    assert by_thread["shard"] == (8, False, False, False)
    assert mid_gate is False and F.mxu_active() is False
    assert set(be._programs) == {(8, True, True, False, False), (8, True, False, False, False)}


def test_pinned_arm_holds_per_thread_under_stress(monkeypatch):
    """fp.pinned_arm is thread-local: 16 threads, each pinning its own arm
    in nested blocks under a short switch interval, always read their own
    gates, and the process-wide gates never move."""
    import sys

    from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F

    monkeypatch.setattr(F, "_CHAINS_MODE", False)
    monkeypatch.setattr(F, "_WSM_MODE", False)
    monkeypatch.setattr(F, "_MXU_MODE", False)
    monkeypatch.delenv("LIGHTHOUSE_TPU_MXU", raising=False)
    wrong, done = [], []

    def worker(i):
        arm = (bool(i & 1), bool(i & 2), bool(i & 4))
        inner = tuple(not g for g in arm)
        for _ in range(300):
            with F.pinned_arm(*arm):
                if (F.chains_active(), F.wsm_fused_active(), F.mxu_for_batch(64)) != arm:
                    wrong.append(i)
                with F.pinned_arm(*inner):
                    if (F.chains_active(), F.wsm_fused_active(), F.mxu_active()) != inner:
                        wrong.append(i)
                if F.mxu_active() != arm[2]:
                    wrong.append(i)
        done.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and sorted(done) == list(range(16))
    assert not wrong
    assert (F.chains_active(), F.wsm_fused_active(), F.mxu_active()) == (False, False, False)


def test_device_verify_site_carries_no_verdict_in_either_package(monkeypatch):
    """Pins the finding in ROADMAP Queue 3: ``bls.device_verify`` fires
    before the marshal with no payload (the reference's stack.py:62 and
    jax_backend/backend.py:575; the port keeps it), so ``silent-flip`` armed
    there fires and passes the verdict untouched in both packages — the
    card's lie is armed at ``pod.gather``, which carries the verdict."""
    from lighthouse_tpu.crypto.bls import api as japi
    from lighthouse_tpu.serve import stack as JS
    from lighthouse_tpu.utils import faults as JF
    from lighthouse_tpu_torch.serve import stack as TS
    from lighthouse_tpu_torch.utils import faults as TF

    class Backend:
        name = "stub"

        def __init__(self, verdict):
            self.verdict = verdict

        def marshal_sets(self, sets):
            return type("MB", (), {"invalid": False})()

        def dispatch(self, mb):
            return self.verdict

        def resolve(self, handle):
            return handle

    for api_mod, stack_mod, faults_mod in ((japi, JS, JF), (tapi, TS, TF)):
        for verdict in (True, False):
            be = Backend(verdict)
            monkeypatch.setattr(api_mod, "_ACTIVE", [be])
            ingest = type("Ingest", (), {"_backend": be, "marshal_sets": be.marshal_sets})()
            faults_mod.INJECTOR.arm("bls.device_verify", "silent-flip")
            try:
                n0 = len(faults_mod.INJECTOR.fired_sequence())
                got = stack_mod._make_ingest_device_verify(ingest)([object()])
                fired = faults_mod.INJECTOR.fired_sequence()[n0:]
            finally:
                faults_mod.INJECTOR.disarm("bls.device_verify")
            assert got is verdict
            assert fired == (("bls.device_verify", "silent-flip"),)
    # where the verdict is the payload, the kind does flip it
    inj = TF.FaultInjector()
    inj.arm("pod.gather", "silent-flip")
    assert inj.fire("pod.gather", False) is True


@pytest.mark.slow
def test_guarded_stack_over_the_cpu_backend_matches_the_oracle(monkeypatch):
    """build_verify_stack over TorchBackend(device="cpu") (the plain versions
    of the kernels): the guard's canaries, the ingest marshal and the ladder's
    bisection on an 8-set batch with one bad set, verdicts against the
    oracle's and every batch on the device rung."""
    from lighthouse_tpu_torch.crypto.bls.torch_backend import backend as TB
    from lighthouse_tpu_torch.serve.stack import build_verify_stack

    be = TB.TorchBackend(device="cpu")
    monkeypatch.setattr(tapi, "_BACKENDS", {**tapi._BACKENDS, "torch": be})
    tapi.set_backend("torch")
    sets = []
    for i in range(8):
        sk = SecretKey(4000 + i)
        msg = bytes([i, 9]) * 16
        sets.append(SignatureSet(sk.sign(msg), [sk.public_key()], msg))
    other = SecretKey(4999)
    sets[5] = SignatureSet(other.sign(b"elsewhere" * 4), [other.public_key()], sets[5].message)
    stack = build_verify_stack()
    assert isinstance(stack.integrity, IntegrityGuard) and stack.ingest is not None
    out = stack.verifier.verify_batch(sets)
    assert out.verdicts == _oracle(sets) == [i != 5 for i in range(8)]
    assert stack.integrity.distrusted == 0 and stack.integrity.canary_checks == 1
    assert stack.resilient.journal and all(k == "device" for k, _ in stack.resilient.journal)
    assert stack.breaker.is_closed
