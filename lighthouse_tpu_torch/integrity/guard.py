"""IntegrityGuard: the verdict-integrity choke point.

The port's copy of the JAX package's ``integrity/guard.py``.  It sits
between the device verdict and the verify service (serve/) as the
outermost ``verify_batch`` surface.  For every real batch it:

1. dispatches the canary known-answer batches through the *same* inner
   verifier path — a canary verdict that disagrees with its precomputed
   expectation marks the whole dispatch **distrusted** before any real
   verdict is released;
2. a distrusted dispatch is fail-closed: the real sets re-verify through
   the ResilientVerifier ladder's CPU-oracle rung
   (:meth:`~..beacon.processor.ResilientVerifier.cpu_batch`), never the
   lying device, and the breaker records the failure so a persistently
   lying device drains out of the hot path;
3. trusted outcomes are sampled into the :class:`~.audit.CrossArmAuditor`
   — a byte-level verdict disagreement on an independent arm is an SDC
   event handled the same way;
4. canary/audit strikes feed per-device :class:`~.trust.TrustScore`; a
   struck device attached via a ``PodVerifier`` is quarantined out of
   the mesh, and readmission requires passing a canary-only probe batch
   (``PodVerifier._probe_excluded`` routes through
   :meth:`device_canary_probe` when a guard is attached).

``verify_batch`` never raises: one broad handler covers the body and the
backstop fails closed (all-False), because a wrong ``False`` is a
liveness bug but a wrong ``True`` is a consensus-safety bug.

On the card every canary is a one-set batch, so it runs through the
backend's ``min_batch`` key (8 sets): ``k`` canaries cost ``k`` replays of
that key around every real batch, whatever the real batch's size.
"""

from __future__ import annotations

import logging
import random

from ..beacon.processor import BatchOutcome, verify_with_bisection
from ..crypto.bls import api as _bls_api
from ..obs.tracer import TRACER
from ..utils import metrics as M
from .audit import CrossArmAuditor
from .corpus import DEFAULT_K, CanaryCorpus
from .trust import TrustScore

log = logging.getLogger(__name__)


class IntegrityGuard:
    """Never-raise verdict gate over an inner verifier ladder.

    Parameters
    ----------
    inner:
        The verifier whose verdicts are being guarded (``PodVerifier``
        or ``ResilientVerifier``); must expose ``verify_batch``.
    resilient:
        The ``ResilientVerifier`` used for distrusted re-verification
        (its CPU-oracle rung).  May be the same object as ``inner``.
    corpus / k:
        Canary corpus and how many canary batches accompany each real
        batch.  ``enabled=False`` or ``k=0`` turns the canary layer off
        (the undefended configuration).
    auditor / audit_fraction:
        Cross-arm audit sampler; ``audit_fraction`` builds a CPU-floor
        auditor when no explicit auditor is given.
    """

    def __init__(self, inner, resilient, *, corpus=None, k=DEFAULT_K,
                 enabled=True, auditor=None, audit_fraction=0.0, rng=None,
                 strike_threshold=2):
        self.inner = inner
        self.resilient = resilient
        self.corpus = corpus if corpus is not None else CanaryCorpus()
        self.k = int(k)
        self.enabled = bool(enabled) and self.k > 0
        self.rng = rng or random.Random(0xCA7A)
        self.trust = TrustScore(strike_threshold=strike_threshold)
        if auditor is None:
            auditor = CrossArmAuditor(
                lambda s: _bls_api.cpu_backend().verify_signature_sets(s),
                fraction=audit_fraction,
                rng=self.rng,
            )
        self.auditor = auditor
        self.pod = None
        # Counters mirrored into scenario run facts via stats().
        self.canary_checks = 0
        self.distrusted = 0
        self.audits = 0
        self.sdc_events = 0
        self.reladdered_sets = 0
        self.guard_backstops = 0
        self.quarantined: set = set()

    # -- wiring -----------------------------------------------------------

    def attach_pod(self, pod) -> None:
        """Wire trust scoring into a pod mesh's health exclusion."""
        self.pod = pod
        pod.integrity = self

    def rotate(self, epoch: int) -> None:
        """Rotate the canary corpus at an epoch boundary."""
        self.corpus.rotate(epoch)

    def canary_batches(self) -> list[tuple[list, bool]]:
        """Known-answer batches for this epoch (shared with pod probes)."""
        return self.corpus.batches(self.k if self.k > 0 else DEFAULT_K)

    @property
    def breaker(self):
        return getattr(self.resilient, "breaker", None)

    # -- the guarded surface ----------------------------------------------

    def verify_batch(self, sets) -> BatchOutcome:
        """Canary-checked, audit-sampled verify.  Never raises: any
        internal failure is logged, counted, and fails closed all-False —
        a wrong reject is recoverable, a wrong accept is not."""
        sets = list(sets)
        try:
            if not sets:
                return BatchOutcome([], 0)
            if self.enabled and not self._canaries_ok():
                return self._distrusted(sets)
            out = self.inner.verify_batch(sets)
            return self._audited(sets, out)
        except Exception:
            self.guard_backstops += 1
            M.INTEGRITY_GUARD_BACKSTOPS.inc()
            log.exception(
                "integrity guard backstop: failing closed for %d sets",
                len(sets),
            )
            return BatchOutcome([False] * len(sets), 0)

    # -- canary layer -----------------------------------------------------

    def _canaries_ok(self) -> bool:
        self.canary_checks += 1
        with TRACER.span("integrity.canary", k=self.k) as sp:
            for canary_sets, expected in self.canary_batches():
                got = all(self.inner.verify_batch(canary_sets).verdicts)
                if got != expected:
                    sp.add(result="mismatch")
                    M.INTEGRITY_CANARY_CHECKS.inc(labels=("mismatch",))
                    return False
            M.INTEGRITY_CANARY_CHECKS.inc(labels=("ok",))
            return True

    def _distrusted(self, sets) -> BatchOutcome:
        self.distrusted += 1
        self.sdc_events += 1
        M.INTEGRITY_DISTRUSTED.inc()
        M.INTEGRITY_SDC_EVENTS.inc(labels=("canary",))
        self._strike_devices()
        breaker = self.breaker
        if breaker is not None:
            # A lying device is a sick device: let the breaker drain it
            # out of the hot path like any loud failure.
            breaker.record_failure()
        return self._reladder(sets)

    def _reladder(self, sets) -> BatchOutcome:
        cpu_batch = getattr(self.resilient, "cpu_batch", None)
        if cpu_batch is not None:
            out = cpu_batch(sets)
        else:
            out = verify_with_bisection(
                lambda ss: bool(self.auditor.cpu_verify(list(ss))), sets
            )
        self.reladdered_sets += len(sets)
        M.INTEGRITY_RELADDERED.inc(len(sets))
        return out

    # -- audit layer ------------------------------------------------------

    def _audited(self, sets, out: BatchOutcome) -> BatchOutcome:
        res = self.auditor.maybe_audit(sets)
        if res is None:
            return out
        ref, mode = res
        self.audits += 1
        M.INTEGRITY_AUDITS.inc(labels=(mode,))
        if ref == [bool(v) for v in out.verdicts]:
            return out
        self.sdc_events += 1
        M.INTEGRITY_SDC_EVENTS.inc(labels=("audit",))
        self._strike_devices()
        # The reference vector came from the independent arm / oracle:
        # release it, not the disputed one.
        self.reladdered_sets += len(sets)
        M.INTEGRITY_RELADDERED.inc(len(sets))
        return BatchOutcome(list(ref), out.device_calls)

    # -- trust + quarantine ----------------------------------------------

    def _strike_devices(self) -> None:
        pod = self.pod
        if pod is None:
            return
        for dev in pod.healthy_devices():
            ok = False
            try:
                ok = pod.device_canary_probe(dev)
            except Exception:
                ok = False
            if ok:
                continue
            M.INTEGRITY_TRUST_STRIKES.inc(labels=(str(dev),))
            if self.trust.strike(dev, reason="canary") and pod.quarantine(dev):
                self.quarantined.add(dev)
                M.INTEGRITY_QUARANTINES.inc()
                TRACER.instant("integrity.quarantine", device=dev)

    def readmit(self, dev) -> None:
        """Called by the pod when ``dev`` passed a canary-only probe."""
        self.trust.clear(dev)

    # -- reporting --------------------------------------------------------

    def stats(self) -> dict:
        return {
            "canary_checks": self.canary_checks,
            "distrusted": self.distrusted,
            "audits": self.audits,
            "sdc_events": self.sdc_events,
            "reladdered_sets": self.reladdered_sets,
            "guard_backstops": self.guard_backstops,
            "quarantined": len(self.quarantined),
        }
