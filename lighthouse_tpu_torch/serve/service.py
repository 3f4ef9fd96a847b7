"""VerifyService: the multi-tenant batch-verification facade (the port's copy
of the JAX package's ``serve/service.py``).

The front door's engine room, deliberately free of any ``BeaconNode``
dependency: construct it over any object with the
``verify_batch(sets) -> BatchOutcome`` surface (``ResilientVerifier``,
``PodVerifier``, or the full ladder from
:func:`~.stack.build_verify_stack` via :meth:`VerifyService.standalone`).
One submission travels:

  submit (admission, ``serve.submit`` chaos + span)
    -> DeadlineAwareBatcher (fill-or-flush pooling)
      -> tick (``serve.dispatch`` chaos + span, one device batch)
        -> verify_batch -> per-request verdict slices -> poll

Verdict fidelity: a dispatch concatenates the admitted requests' sets in
FIFO order and hands them to ``verify_batch`` in ONE call, so the
verdicts a tenant polls back are byte-identical to calling the wrapped
verifier directly on the same stream — the acceptance invariant the
serve tests pin.

``tick`` is the service's never-raise pump: a dispatch failure fails the
affected requests closed (all-False verdicts, ``serve_errors_total``) and
the service keeps serving every other tenant.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..obs.tracer import TRACER
from ..utils import metrics as M
from ..utils.logging import get_logger
from .admission import AdmissionController, TenantPolicy
from .batcher import DeadlineAwareBatcher

log = get_logger("serve.service")

#: compiled device batch sizes the batcher fills toward when the caller
#: does not pin its own (matches the backend's min_batch ladder scale)
DEFAULT_COMPILED_SIZES = (64, 256, 1024)


@dataclass
class ServeRequest:
    """One admitted submission's lifecycle record."""

    request_id: str
    tenant: str
    sets: list
    deadline: float            # absolute, service clock
    submitted_at: float
    status: str = "queued"     # queued -> done
    verdicts: list | None = None
    done_at: float | None = None
    deadline_missed: bool = False

    def to_json(self) -> dict:
        out = {
            "request_id": self.request_id,
            "tenant": self.tenant,
            "status": self.status,
            "n_sets": len(self.sets),
        }
        if self.status == "done":
            out["verdicts"] = [bool(v) for v in self.verdicts]
            out["deadline_missed"] = self.deadline_missed
        return out


@dataclass
class SubmitResult:
    """What ``submit`` hands back: admitted (with an id) or shed."""

    accepted: bool
    reason: str = "ok"
    request_id: str | None = None
    tenant: str = "unknown"

    def to_json(self) -> dict:
        if self.accepted:
            return {"request_id": self.request_id, "status": "queued"}
        return {"status": "shed", "reason": self.reason}


class VerifyService:
    """Multi-tenant deadline-batched front end over one verifier ladder.

    Parameters
    ----------
    verifier:
        Anything with ``verify_batch(sets) -> BatchOutcome``.
    breaker:
        The ladder's circuit breaker; admission's degraded-mode shedding
        keys off it (None disables that gate).
    policies / default_policy:
        Per-tenant :class:`~.admission.TenantPolicy` table.
    compiled_sizes / flush_margin:
        The batcher's fill threshold and flush headroom — the
        latency/throughput knob (see batcher.py).
    default_deadline_s:
        Deadline applied to submissions that do not carry one.
    now:
        Injectable clock (tests, scenario engine).
    """

    def __init__(self, verifier, *, breaker=None, policies=None,
                 default_policy: TenantPolicy | None = None,
                 compiled_sizes=DEFAULT_COMPILED_SIZES,
                 flush_margin: float = 0.02,
                 default_deadline_s: float = 0.25,
                 injector=None, now=time.monotonic,
                 max_done: int = 4096, cost_model=None):
        from ..utils import faults as faults_mod

        self._verifier = verifier
        self.breaker = breaker
        self._now = now
        self._injector = (
            injector if injector is not None else faults_mod.INJECTOR
        )
        self.default_deadline_s = float(default_deadline_s)
        self.admission = AdmissionController(
            policies=policies, default_policy=default_policy,
            breaker=breaker, now=now, cost_model=cost_model,
        )
        self.batcher = DeadlineAwareBatcher(
            compiled_sizes, flush_margin=flush_margin, now=now,
        )
        self._lock = threading.Lock()
        self._requests: dict[str, ServeRequest] = {}
        self._done_order: list[str] = []
        self._max_done = int(max_done)
        self._seq = 0
        self._ticker: threading.Thread | None = None
        self._stop = threading.Event()
        # service-local per-tenant tallies (scenario SLO facts; the
        # labelled prom counters are the scrape surface)
        self.completed: dict[str, int] = {}
        self.deadline_misses: dict[str, int] = {}

    @classmethod
    def standalone(cls, *, pubkey_cache=None, injector=None, **kw):
        """Build the full ladder via the shared construction path
        (stack.py, over the active backend: ``set_backend("torch")`` first)
        and a service over it — no beacon node anywhere.  It adds no
        warm-up: on the card the first batch of each padded size builds its
        key inside that batch's deadline."""
        from .stack import build_verify_stack

        stack = build_verify_stack(
            pubkey_cache=pubkey_cache, injector=injector,
        )
        return cls(stack.verifier, breaker=stack.breaker,
                   injector=stack.injector, **kw)

    def rotate_epoch(self, epoch: int) -> None:
        """Epoch hook: rotate the verdict-integrity canary corpus when
        the verifier is an :class:`~..integrity.guard.IntegrityGuard`
        (no-op otherwise), so a tenant-facing stack never serves stale
        canaries a lying device could have learned."""
        rotate = getattr(self._verifier, "rotate", None)
        if rotate is not None:
            rotate(int(epoch))

    # -- ingress -----------------------------------------------------------

    def submit(self, tenant: str, sets, deadline_s: float | None = None,
               ) -> SubmitResult:
        """Programmatic ingress: one tenant submission."""
        return self.submit_payload(
            {"tenant": tenant, "sets": sets, "deadline_s": deadline_s}
        )

    def submit_payload(self, payload) -> SubmitResult:
        """Wire-shaped ingress: ``{"tenant", "sets", "deadline_s"}``.

        The ``serve.submit`` chaos site fires on the raw payload before
        validation — a ``slow-client`` arm burns deadline headroom right
        here, a ``malformed-request`` arm corrupts the payload and must
        come out as a ``malformed`` shed, never an exception escaping to
        the transport.
        """
        with TRACER.span("serve.submit"):
            payload = self._injector.fire("serve.submit", payload)
            tenant, sets, deadline_s = self._validate(payload)
            if sets is None:
                M.SERVE_SHED.inc(labels=(tenant, "malformed"))
                return SubmitResult(accepted=False, reason="malformed",
                                    tenant=tenant)
            ok, reason = self.admission.admit(tenant, len(sets),
                                              sets=sets)
            if not ok:
                M.SERVE_SHED.inc(labels=(tenant, reason))
                return SubmitResult(accepted=False, reason=reason,
                                    tenant=tenant)
            now = self._now()
            if deadline_s is None:
                deadline_s = self.default_deadline_s
            with self._lock:
                self._seq += 1
                req = ServeRequest(
                    request_id=f"r{self._seq:08d}", tenant=tenant,
                    sets=list(sets), deadline=now + float(deadline_s),
                    submitted_at=now,
                )
                self._requests[req.request_id] = req
                self.batcher.offer(req, len(req.sets), req.deadline)
            M.SERVE_ACCEPTED.inc(labels=(tenant,))
            return SubmitResult(accepted=True, request_id=req.request_id,
                                tenant=tenant)

    @staticmethod
    def _validate(payload):
        """(tenant, sets, deadline_s) from a wire payload; sets is None
        when the submission is malformed."""
        if not isinstance(payload, dict):
            return "unknown", None, None
        tenant = payload.get("tenant")
        if not isinstance(tenant, str) or not tenant:
            tenant = "unknown"
        sets = payload.get("sets")
        if not isinstance(sets, (list, tuple)) or not sets:
            return tenant, None, None
        deadline_s = payload.get("deadline_s")
        if deadline_s is not None:
            try:
                deadline_s = float(deadline_s)
            except (TypeError, ValueError):
                return tenant, None, None
            if deadline_s <= 0:
                return tenant, None, None
        return tenant, list(sets), deadline_s

    def result(self, request_id: str) -> dict | None:
        """Poll one request: its ``to_json`` dict, or None if unknown
        (never submitted, or evicted after completion)."""
        with self._lock:
            req = self._requests.get(request_id)
            return None if req is None else req.to_json()

    # -- the pump ----------------------------------------------------------

    def tick(self) -> int:
        """Advance the service: dispatch every batch the fill-or-flush
        policy says is due.  Returns batches dispatched.  Never raises —
        a failing dispatch fails its requests closed and the pump keeps
        pumping (the same contract as
        ``ResilientVerifier.verify_batch``)."""
        try:
            return self._drain(False)
        except Exception:
            log.error("serve tick failed", exc_info=True)
            M.SERVE_ERRORS.inc()
            return 0

    def flush(self) -> int:
        """Dispatch everything pooled regardless of deadline (shutdown,
        tests, bench end-of-run)."""
        return self._drain(True)

    def _drain(self, force: bool) -> int:
        batches = 0
        while True:
            with self._lock:
                out = self.batcher.poll()
                if out is None and force and self.batcher.pending:
                    out = self.batcher.drain_all(), "deadline"
            if out is None:
                return batches
            items, trigger = out
            self._dispatch(items, trigger)
            batches += 1

    def _dispatch(self, reqs: list[ServeRequest], trigger: str) -> None:
        """One coalesced device batch: concatenate the requests' sets in
        FIFO order, verify them in ONE ``verify_batch`` call, slice the
        verdicts back per request.  Fails closed on any error."""
        M.SERVE_FLUSHES.inc(labels=(trigger,))
        sets = []
        for r in reqs:
            sets.extend(r.sets)
        t0 = self._now()
        for r in reqs:
            M.SERVE_QUEUE_WAIT.observe(t0 - r.submitted_at,
                                       labels=(r.tenant,))
        with TRACER.span("serve.dispatch", trigger=trigger,
                         requests=len(reqs), n_sets=len(sets)):
            try:
                self._injector.fire("serve.dispatch")
                outcome = self._verifier.verify_batch(sets)
                verdicts = list(outcome.verdicts)
            except Exception:
                # infrastructure failure past the resilient ladder (or an
                # injected one): fail the whole batch closed, keep serving
                log.error("serve dispatch failed; batch fails closed",
                          exc_info=True)
                M.SERVE_ERRORS.inc()
                verdicts = [False] * len(sets)
        done_at = self._now()
        i = 0
        with self._lock:
            for r in reqs:
                r.verdicts = verdicts[i:i + len(r.sets)]
                i += len(r.sets)
                r.status = "done"
                r.done_at = done_at
                self.completed[r.tenant] = (
                    self.completed.get(r.tenant, 0) + 1
                )
                if done_at > r.deadline:
                    r.deadline_missed = True
                    self.deadline_misses[r.tenant] = (
                        self.deadline_misses.get(r.tenant, 0) + 1
                    )
                    M.SERVE_DEADLINE_MISS.inc(labels=(r.tenant,))
                M.SERVE_E2E_LATENCY.observe(done_at - r.submitted_at,
                                            labels=(r.tenant,))
                self._done_order.append(r.request_id)
            while len(self._done_order) > self._max_done:
                self._requests.pop(self._done_order.pop(0), None)
        for r in reqs:
            self.admission.release(r.tenant, len(r.sets))

    # -- background pump ---------------------------------------------------

    def start(self, interval: float = 0.002) -> "VerifyService":
        """Run ``tick`` on a daemon thread every ``interval`` seconds
        (the HTTP front door's pump)."""
        self._stop.clear()

        def _loop():
            while not self._stop.wait(interval):
                self.tick()

        self._ticker = threading.Thread(
            target=_loop, name="serve-tick", daemon=True,
        )
        self._ticker.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._ticker is not None:
            self._ticker.join(5.0)
            self._ticker = None
        self.flush()
