"""Verdict-integrity layer of the port: canary sets, cross-arm audit, SDC
quarantine (the JAX package's ``integrity/``, over ``TorchBackend``).

Every robustness tier below this one (breaker ladder, pod fault domains,
crash recovery, byzantine sync) defends against *loud* failures — raised
errors, timeouts, crashes.  This package defends the verdict itself
against silent data corruption: a device that returns the wrong boolean
without raising anything.

Three cooperating pieces:

``corpus``
    Precomputed known-answer canary signature sets (mix of known-valid
    and known-invalid), generated through the scalar oracle and rotated
    per epoch (``CANARY_CORPUS`` is its literal registry).
``guard``
    :class:`~.guard.IntegrityGuard` — the never-raise choke point between
    the device verdict and the verify service.  Canary-checks every
    dispatched batch before any real verdict is released, samples accepted
    batches into the
    cross-arm auditor, and feeds strikes into device trust/quarantine.
``audit`` / ``trust``
    :class:`~.audit.CrossArmAuditor` re-verifies sampled batches on an
    independent autotuner arm, through that arm's own program key on this
    thread (CPU scalar oracle as the floor), and byte-compares verdicts; :class:`~.trust.TrustScore` turns canary and
    audit strikes into per-device quarantine decisions wired into
    ``PodVerifier``'s health exclusion.
``selfcheck``
    :func:`~.selfcheck.run_selfcheck` — the canaries through every verify
    program key the backend holds, each under its own arm.
"""

from .audit import CrossArmAuditor
from .corpus import CANARY_CORPUS, DEFAULT_K, REQUIRED_CHAOS_KINDS, CanaryCorpus
from .guard import IntegrityGuard
from .selfcheck import SelfcheckReport, run_selfcheck
from .trust import TrustScore

__all__ = [
    "CANARY_CORPUS",
    "DEFAULT_K",
    "REQUIRED_CHAOS_KINDS",
    "CanaryCorpus",
    "CrossArmAuditor",
    "IntegrityGuard",
    "SelfcheckReport",
    "TrustScore",
    "run_selfcheck",
]
