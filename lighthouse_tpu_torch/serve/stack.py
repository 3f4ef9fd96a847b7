"""The one verifier-stack construction path.

The port's copy of the JAX package's ``serve/stack.py``: the single factory
the verify service (and any other front end) builds its ladder with, so a
signature batch takes the same decisions whichever front end submitted it.
The ladder, bottom up:

* the active BLS backend (``crypto/bls/api.get_backend()``: ``TorchBackend``
  after ``set_backend("torch")``) — the device rung; when it exposes the
  marshal / dispatch / resolve split, the vectorized
  :class:`~lighthouse_tpu_torch.ingest.IngestEngine` marshals for it
  (byte-identical to the scalar marshal, degrading to it internally);
* :class:`~lighthouse_tpu_torch.beacon.processor.ResilientVerifier` — the
  breaker-guarded device / CPU degradation ladder, the scalar oracle
  (``api.cpu_backend()``) its CPU rung;
* :class:`~lighthouse_tpu_torch.parallel.pod.PodVerifier` — per-shard fault
  domains across the cards when two or more are visible (``maybe_build``
  returns None on one card);
* :class:`~lighthouse_tpu_torch.integrity.guard.IntegrityGuard` — canaries
  around every dispatch, when a device backend is active.

The returned :class:`VerifyStack` exposes the outermost ``verifier`` (the
object whose ``verify_batch`` callers use) plus every rung, so a caller that
needs the breaker or the ingest engine directly reaches the same instances.

On the card every padded batch size the stack will see is a program key, and
a key's first build takes tens of seconds: a caller with deadlines builds
its keys before traffic (``TorchBackend.warm_compile``, or ``aot_store`` with
``prewarm=True``), the canaries' ``min_batch`` key included.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class VerifyStack:
    """The assembled ladder: ``verifier`` is the outermost verify_batch
    surface (the guard when one was built, else the pod when one was built,
    else the resilient rung)."""

    breaker: object
    verifier: object
    resilient: object
    ingest: object | None
    pod: object | None
    injector: object
    # the warm-boot report when the stack was built with prewarm=True
    # (torch_backend/aot.PrewarmReport), else None
    prewarm_report: object | None = None
    # the IntegrityGuard wrapping ``verifier`` when the verdict-integrity
    # layer is on (integrity/guard.py), else None
    integrity: object | None = None


def _make_ingest_device_verify(ingest):
    """Device rung of the resilience ladder, marshalled by the ingest
    engine.  Fires the ``bls.device_verify`` chaos site where
    ``verify_signature_sets`` does, before the marshal and with no payload,
    so an armed device fault trips the breaker and falls down the ladder,
    while a verdict-mutating kind armed there (``silent-flip``) has no
    verdict to mutate and passes it untouched, as in the reference."""
    def device_verify(sets) -> bool:
        from ..crypto.bls import api as _bls_api
        from ..utils import faults as _faults

        be = _bls_api.get_backend()
        if be is not ingest._backend:
            # backend swapped since wiring: use it directly
            return be.verify_signature_sets(sets)
        _faults.fire("bls.device_verify")
        mb = ingest.marshal_sets(sets)
        if mb.invalid:
            return False
        return be.resolve(be.dispatch(mb))

    return device_verify


def build_verify_stack(pubkey_cache=None, injector=None, breaker=None, aot_store=None,
                       prewarm=False, integrity="auto", canary_k=None,
                       audit_fraction=0.0) -> VerifyStack:
    """Assemble the full verification ladder against the active backend.

    Parameters
    ----------
    pubkey_cache:
        Optional pubkey registry handed to the ingest engine's limb cache.
    injector:
        Fault injector for the pod's per-shard sites; defaults to the
        process-global one.
    breaker:
        Pre-built ``CircuitBreaker`` (tests pin its clock); defaults to a
        fresh real-time one.
    aot_store:
        Optional :class:`~..crypto.bls.torch_backend.aot.AotStore` attached
        to the active backend (when it has the seam): each key's first
        build records its operand skeleton in the store.
    prewarm:
        Build every current store entry's program NOW (``aot.prewarm``) —
        before this function returns, so before any caller can open a
        listener over the stack.  A tuned arm plan in the store installs
        first.  The report lands on the returned stack's ``prewarm_report``.
    integrity:
        ``"auto"`` (default) turns the verdict-integrity guard on when a
        device backend is active (integrity/guard.py).  The scalar python
        backend *is* the oracle, so auto leaves it unguarded.  Pass
        True/False to force.
    canary_k:
        Canary batches per dispatch (default ``integrity.corpus.DEFAULT_K``).
    audit_fraction:
        Fraction of accepted batches re-verified by the audit sampler on the
        CPU floor (0.0 disables sampling; the canary layer is unaffected).
    """
    from ..beacon.processor import CircuitBreaker, ResilientVerifier
    from ..crypto.bls import api as _bls_api
    from ..utils import faults as faults_mod

    if breaker is None:
        breaker = CircuitBreaker()
    if injector is None:
        injector = faults_mod.INJECTOR
    ingest = None
    _active = _bls_api.get_backend()
    prewarm_report = None
    if aot_store is not None and hasattr(_active, "attach_aot_store"):
        _active.attach_aot_store(aot_store)
        if prewarm:
            from ..crypto.bls.torch_backend import aot as _aot

            prewarm_report = _aot.prewarm(_active, aot_store)
    if hasattr(_active, "marshal_sets") and hasattr(_active, "dispatch"):
        from ..ingest import IngestEngine

        ingest = IngestEngine(_active, pubkey_cache=pubkey_cache)
        device_verify = _make_ingest_device_verify(ingest)
    else:
        # an engine without the stage split (the oracle): direct call
        device_verify = lambda s: _bls_api.get_backend().verify_signature_sets(s)  # noqa: E731
    resilient = ResilientVerifier(
        device_verify=device_verify,
        cpu_verify=lambda s: _bls_api.cpu_backend().verify_signature_sets(s),
        breaker=breaker,
    )
    verifier = resilient
    pod = None
    if ingest is not None:
        from ..parallel.pod import PodVerifier

        # the pod fronts the service whenever two cards are visible; the
        # sharded program gets the mesh-aware marshal (defers the pubkey
        # operand for all-registry batches) and the partitioned registry
        # mirror, so slot-mode batches gather on the cards
        pod = PodVerifier.maybe_build(
            resilient, backend=_active,
            marshal=ingest.marshal_sets,
            sharded_marshal=ingest.marshal_for_mesh,
            registry_provider=ingest.cache.registry_device_sharded,
            injector=injector,
        )
        if pod is not None:
            verifier = pod
    guard = None
    want_integrity = (ingest is not None) if integrity == "auto" else bool(integrity)
    if want_integrity:
        from ..integrity.corpus import DEFAULT_K
        from ..integrity.guard import IntegrityGuard

        guard = IntegrityGuard(
            verifier, resilient,
            k=DEFAULT_K if canary_k is None else int(canary_k),
            audit_fraction=audit_fraction,
        )
        if pod is not None:
            guard.attach_pod(pod)
        verifier = guard
    return VerifyStack(
        breaker=breaker, verifier=verifier, resilient=resilient,
        ingest=ingest, pod=pod, injector=injector,
        prewarm_report=prewarm_report, integrity=guard,
    )
