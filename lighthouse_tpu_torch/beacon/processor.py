"""The work scheduler and the verifier ladder: bounded priority queues
feeding device-sized batches, and the failure ladder every batch verify
takes to the card.

The port's copy of the JAX package's ``beacon/processor.py`` (twin of
beacon_node/beacon_processor/src/lib.rs: bounded queues (:77-196), LIFO for
attestations and FIFO for blocks and anti-censorship ops (:773-797),
hardcoded priority dispatch (:946-1070), gossip batch assembly (:204-217),
and the work journal scheduler tests read (:759-766)).  Like the JAX
package, it departs from the client's design where the device asks:

* batch sizes follow the device's program keys (powers of two from the
  backend's ``min_batch``), and assembly is deadline-driven;
* a poisoned batch (one bad signature fails the whole AND-reduce) is
  bisected on the device, not verified set by set on the CPU;
* ``ResilientVerifier``: device with retries and infra-bisection under one
  ``RetryBudget``, a ``CircuitBreaker``, and the scalar oracle
  (``api.cpu_backend()``) as the CPU rung; it never drops a batch and never
  raises;
* ``PipelinedVerifier``: the host marshal of batch N+1 on worker threads
  while batch N's program replays on the card (``for_backend`` over
  ``TorchBackend``'s ``marshal_sets`` / ``dispatch`` / ``resolve``, or the
  ingest engine's marshal).

Nothing here touches torch: the device is reached only through the
callables a caller wires in.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from enum import Enum, auto
from typing import Any, Callable

from ..obs.tracer import TRACER
from ..utils.logging import get_logger

log = get_logger("processor")


class WorkKind(Enum):
    """Work taxonomy (the `Work` enum, lib.rs:562 — the kinds the
    implemented layers emit; extended as layers land)."""

    CHAIN_SEGMENT = auto()
    RPC_BLOCK = auto()
    GOSSIP_BLOCK = auto()
    API_REQUEST_P0 = auto()
    GOSSIP_AGGREGATE = auto()
    GOSSIP_ATTESTATION = auto()
    GOSSIP_VOLUNTARY_EXIT = auto()
    GOSSIP_PROPOSER_SLASHING = auto()
    GOSSIP_ATTESTER_SLASHING = auto()
    GOSSIP_SYNC_SIGNATURE = auto()
    API_REQUEST_P1 = auto()


# queue bounds (lib.rs:77-196's explicit capacities)
DEFAULT_QUEUE_BOUNDS = {
    WorkKind.CHAIN_SEGMENT: 64,
    WorkKind.RPC_BLOCK: 1024,
    WorkKind.GOSSIP_BLOCK: 1024,
    WorkKind.API_REQUEST_P0: 1024,
    WorkKind.GOSSIP_AGGREGATE: 4096,
    WorkKind.GOSSIP_ATTESTATION: 16384,
    WorkKind.GOSSIP_VOLUNTARY_EXIT: 4096,
    WorkKind.GOSSIP_PROPOSER_SLASHING: 4096,
    WorkKind.GOSSIP_ATTESTER_SLASHING: 4096,
    WorkKind.GOSSIP_SYNC_SIGNATURE: 16384,
    WorkKind.API_REQUEST_P1: 1024,
}

# LIFO kinds: freshest-first (stale attestations lose value; lib.rs:773-786)
LIFO_KINDS = {
    WorkKind.GOSSIP_ATTESTATION,
    WorkKind.GOSSIP_AGGREGATE,
    WorkKind.GOSSIP_SYNC_SIGNATURE,
}

# dispatch priority (lib.rs:946-1070's if-else ladder, highest first)
PRIORITY_ORDER = [
    WorkKind.CHAIN_SEGMENT,
    WorkKind.RPC_BLOCK,
    WorkKind.GOSSIP_BLOCK,
    WorkKind.API_REQUEST_P0,
    WorkKind.GOSSIP_AGGREGATE,
    WorkKind.GOSSIP_ATTESTATION,
    WorkKind.GOSSIP_VOLUNTARY_EXIT,
    WorkKind.GOSSIP_PROPOSER_SLASHING,
    WorkKind.GOSSIP_ATTESTER_SLASHING,
    WorkKind.GOSSIP_SYNC_SIGNATURE,
    WorkKind.API_REQUEST_P1,
]

# batchable kinds and their device assembly caps
BATCHED_KINDS = {
    WorkKind.GOSSIP_ATTESTATION,
    WorkKind.GOSSIP_AGGREGATE,
    WorkKind.GOSSIP_SYNC_SIGNATURE,
}

# kinds it is acceptable to shed while the device is down (degraded mode):
# replaceable per-validator data whose value decays within a slot and whose
# information survives in aggregated form.  NEVER blocks (chain liveness),
# never the anti-censorship FIFO ops (exits/slashings — shedding those is a
# censorship vector), never aggregates (the compressed form we keep).
DEGRADED_SHED_KINDS = {
    WorkKind.GOSSIP_ATTESTATION,
    WorkKind.GOSSIP_SYNC_SIGNATURE,
    WorkKind.API_REQUEST_P1,
}


@dataclass
class WorkEvent:
    kind: WorkKind
    item: Any
    received_at: float = field(default_factory=time.monotonic)


class BoundedQueue:
    """Bounded FIFO/LIFO with drop-count accounting (load shedding)."""

    def __init__(self, bound: int, lifo: bool):
        self.bound = bound
        self.lifo = lifo
        self._dq: deque = deque()
        self.dropped = 0

    def push(self, ev: WorkEvent) -> bool:
        if len(self._dq) >= self.bound:
            if self.lifo:
                # LIFO sheds the OLDEST (bottom) — freshest data wins
                self._dq.popleft()
                self.dropped += 1
            else:
                self.dropped += 1
                return False
        self._dq.append(ev)
        return True

    def pop(self) -> WorkEvent | None:
        if not self._dq:
            return None
        return self._dq.pop() if self.lifo else self._dq.popleft()

    def pop_many(self, n: int) -> list[WorkEvent]:
        out = []
        while len(out) < n:
            ev = self.pop()
            if ev is None:
                break
            out.append(ev)
        return out

    def __len__(self):
        return len(self._dq)


class BeaconProcessor:
    """Single-threaded dispatch core (the manager loop).  Async/thread
    pumping lives in the runtime layer; tests drive `dispatch_once`."""

    def __init__(
        self,
        handlers: dict[WorkKind, Callable[[list[WorkEvent]], None]],
        batch_size_for: Callable[[WorkKind], int] | None = None,
        bounds: dict[WorkKind, int] | None = None,
        journal: list | None = None,
        breaker: "CircuitBreaker | None" = None,
        injector=None,
    ):
        bounds = {**DEFAULT_QUEUE_BOUNDS, **(bounds or {})}
        self.queues = {
            k: BoundedQueue(bounds[k], k in LIFO_KINDS) for k in WorkKind
        }
        self.handlers = handlers
        self.batch_size_for = batch_size_for or (lambda k: 64)
        # the work journal (lib.rs:759-766): every dispatch is observable
        self.journal = journal if journal is not None else []
        # degraded-mode wiring: when the breaker is not CLOSED the CPU
        # fallback is the verifier, so ingress sheds the shed-eligible
        # kinds rather than queueing more than the slow path can drain
        self.breaker = breaker
        if injector is None:
            from ..utils import faults as _faults

            injector = _faults.INJECTOR
        self.injector = injector
        self.shed = 0

    @property
    def degraded(self) -> bool:
        return self.breaker is not None and not self.breaker.is_closed

    def try_send(self, ev: WorkEvent) -> bool:
        try:
            if self.injector.check("processor.enqueue"):
                # injected queue overflow: the bound is "reached" regardless
                # of actual occupancy — same drop accounting as a real one
                self.queues[ev.kind].dropped += 1
                self.journal.append(("dropped", ev.kind.name))
                return False
            if self.degraded and ev.kind in DEGRADED_SHED_KINDS:
                from ..utils.metrics import PROCESSOR_SHED

                PROCESSOR_SHED.inc(labels=(ev.kind.name,))
                self.shed += 1
                self.journal.append(("shed", ev.kind.name))
                return False
            ok = self.queues[ev.kind].push(ev)
            if not ok:
                self.journal.append(("dropped", ev.kind.name))
            return ok
        except Exception as exc:  # noqa: BLE001 — ingress never raises
            # Gossip/RPC callers treat False as "queue full"; an internal
            # error must degrade to a drop, never propagate upward.
            log.error("processor: try_send backstop caught %s: %s",
                      type(exc).__name__, exc)
            return False

    def dispatch_once(self) -> bool:
        """Pop the highest-priority available work (batch-assembled for
        batchable kinds) and run its handler.  Returns False when idle."""
        for kind in PRIORITY_ORDER:
            q = self.queues[kind]
            if not len(q):
                continue
            n = self.batch_size_for(kind) if kind in BATCHED_KINDS else 1
            batch = q.pop_many(n)
            self.journal.append((kind.name, len(batch)))
            handler = self.handlers.get(kind)
            if handler is not None:
                handler(batch)
            return True
        return False

    def drain(self, budget: int | None = None) -> int:
        done = 0
        while budget is None or done < budget:
            if not self.dispatch_once():
                break
            done += 1
        return done

    def queue_lengths(self) -> dict[str, int]:
        return {k.name: len(q) for k, q in self.queues.items() if len(q)}


# ---------------------------------------------------------------------------
# Device batch verification with on-device bisection
# ---------------------------------------------------------------------------


@dataclass
class BatchOutcome:
    verdicts: list[bool]
    device_calls: int


def verify_with_bisection(
    verify: Callable[[list], bool], sets: list
) -> BatchOutcome:
    """AND-reduce batch verify with poisoned-batch attribution by on-device
    bisection: a failing batch splits in half and re-verifies each side,
    recursing to singles.  Cost for one poisoned item in B: ~2*log2(B) extra
    batch calls — replacing batch.rs:116-120's per-set CPU fallback (B CPU
    verifies) with device work.
    """
    calls = 0

    def go(items: list) -> list[bool]:
        nonlocal calls
        if not items:
            return []
        calls += 1
        if verify(items):
            return [True] * len(items)
        if len(items) == 1:
            return [False]
        mid = len(items) // 2
        return go(items[:mid]) + go(items[mid:])

    verdicts = go(list(sets))
    return BatchOutcome(verdicts=verdicts, device_calls=calls)


# ---------------------------------------------------------------------------
# Circuit breaker + graceful degradation
# ---------------------------------------------------------------------------


class BreakerState(Enum):
    CLOSED = auto()      # device healthy: batches go to the card
    OPEN = auto()        # device down: everything on the CPU fallback
    HALF_OPEN = auto()   # backoff elapsed: ONE probe batch may try the device


class CircuitBreaker:
    """Trip-open / probe / re-close state machine over the device backend.

    After ``failure_threshold`` CONSECUTIVE infrastructure failures the
    breaker opens: batches route to the CPU fallback and the scheduler
    sheds low-priority kinds (``DEGRADED_SHED_KINDS``).  After
    ``reset_timeout`` (doubling per failed probe up to ``max_backoff``)
    the breaker half-opens and admits a single probe batch; a probe
    success re-closes it, a probe failure re-opens with doubled backoff.
    The same shape as the reference's fallback beacon-node candidate
    rotation — health is observed, never assumed.
    """

    def __init__(
        self,
        failure_threshold: int = 3,
        reset_timeout: float = 1.0,
        backoff_factor: float = 2.0,
        max_backoff: float = 60.0,
        now: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self.backoff_factor = backoff_factor
        self.max_backoff = max_backoff
        self.now = now
        # One breaker is shared by every thread that verifies (the sync
        # tick driver, gossip handler threads, pipeline workers); the
        # check-then-transition sequences below are not atomic without it.
        # Reentrant: record_failure → _open → _transition compose.
        self._lock = threading.RLock()
        self.state = BreakerState.CLOSED
        self.consecutive_failures = 0
        self.trips = 0
        self._backoff = reset_timeout
        self._opened_at: float | None = None

    def _transition(self, state: "BreakerState") -> None:
        with self._lock:
            if state is self.state:
                return
            self.state = state
        from ..utils.metrics import BREAKER_TRANSITIONS

        BREAKER_TRANSITIONS.inc(labels=(state.name,))
        TRACER.instant("breaker.transition", state=state.name)
        if state is BreakerState.OPEN:
            # device-down is exactly the moment the flight recorder's recent
            # history matters: leave an artifact (no-op unless a dump dir is
            # configured; never raises)
            TRACER.maybe_dump("breaker-open")

    @property
    def is_closed(self) -> bool:
        return self.state is BreakerState.CLOSED

    def allow_device(self) -> bool:
        """May the next batch touch the device?  True while CLOSED; while
        OPEN, True exactly once per elapsed backoff window (the probe),
        flipping the breaker to HALF_OPEN."""
        with self._lock:
            if self.state is BreakerState.CLOSED:
                return True
            if self.state is BreakerState.HALF_OPEN:
                return False  # a probe is already in flight
            if self._opened_at is not None and (
                self.now() - self._opened_at >= self._backoff
            ):
                self._transition(BreakerState.HALF_OPEN)
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self.consecutive_failures = 0
            self._backoff = self.reset_timeout
            self._opened_at = None
            self._transition(BreakerState.CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self.consecutive_failures += 1
            if self.state is BreakerState.HALF_OPEN:
                # failed probe: back to OPEN with a longer wait
                self._backoff = min(
                    self._backoff * self.backoff_factor, self.max_backoff
                )
                self._open()
            elif (self.state is BreakerState.CLOSED
                  and self.consecutive_failures >= self.failure_threshold):
                self.trips += 1
                self._open()

    def _open(self) -> None:
        with self._lock:
            self._opened_at = self.now()
            self._transition(BreakerState.OPEN)


@dataclass
class RetryBudget:
    """Bounded retry allowance for ONE batch: device attempts + deadline."""

    attempts: int
    deadline: float

    def spend(self, now: float) -> bool:
        """Consume one attempt; False when the budget is gone."""
        if self.attempts <= 0 or now >= self.deadline:
            return False
        self.attempts -= 1
        return True


class ResilientVerifier:
    """Batch verification with a specified failure ladder.  On the card the
    device rung is ``TorchBackend`` (a key's first verify builds its CUDA
    graph, tens of seconds: build keys before traffic, since
    ``retry_deadline`` bounds only when an attempt may start).

    device healthy   -> on-device AND-reduce + poisoned-batch bisection
                        (``verify_with_bisection``), exactly as before
    device erroring  -> the batch is retried, then infra-bisected (halved
                        and re-tried per half — one poison input crashing
                        a kernel must not drag the whole batch to the
                        CPU), all under one bounded :class:`RetryBudget`
    budget exhausted
    or breaker OPEN  -> the pure-Python/NumPy verifier takes the batch

    A batch handed to :meth:`verify_batch` is NEVER silently dropped and
    the call never raises: every set gets a verdict from *some* engine.
    Infrastructure failures (exceptions out of the device call) are
    distinct from signature failures (the AND-reduce returning False) —
    only the former feed the breaker; the latter keep the existing
    on-device bisection semantics.
    """

    def __init__(
        self,
        device_verify: Callable[[list], bool],
        cpu_verify: Callable[[list], bool],
        breaker: CircuitBreaker | None = None,
        max_device_attempts: int = 4,
        retry_deadline: float = 2.0,
        now: Callable[[], float] = time.monotonic,
        injector=None,
    ):
        self.device_verify = device_verify
        self.cpu_verify = cpu_verify
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.max_device_attempts = max_device_attempts
        self.retry_deadline = retry_deadline
        self.now = now
        if injector is None:
            from ..utils import faults as _faults

            injector = _faults.INJECTOR
        self.injector = injector
        # observability: ("device" | "cpu", batch_size) per engine run
        self.journal: list[tuple[str, int]] = []

    def verify_batch(self, sets: list) -> BatchOutcome:
        sets = list(sets)
        if not sets:
            return BatchOutcome(verdicts=[], device_calls=0)
        try:
            from ..utils.metrics import VERIFY_BATCH_LATENCY

            with VERIFY_BATCH_LATENCY.timer(), TRACER.span(
                    "verify.batch", sets=len(sets)):
                budget = RetryBudget(
                    attempts=self.max_device_attempts,
                    deadline=self.now() + self.retry_deadline,
                )
                verdicts = self._device_or_cpu(sets, budget)
                return BatchOutcome(verdicts=verdicts, device_calls=0)
        except Exception as exc:  # noqa: BLE001 — never-raise backstop
            # The ladder already absorbs device faults; this catches a bug
            # in the ladder itself (or a CPU-oracle crash).  Fail closed:
            # every set gets a False verdict — a dropped batch would
            # silently skip verification, a raised exception would take
            # the caller down with it.
            log.error("verify_batch backstop caught %s: %s",
                      type(exc).__name__, exc)
            return BatchOutcome(verdicts=[False] * len(sets), device_calls=0)

    # -- internals ---------------------------------------------------------

    def _device_call(self, items: list) -> bool:
        self.injector.fire("processor.verify")
        return self.device_verify(items)

    def _device_or_cpu(self, items: list, budget: RetryBudget) -> list[bool]:
        """Verdicts for ``items``: device with retry/infra-bisection under
        ``budget``, CPU once the budget (or the breaker) says stop.

        ``allow_device`` is the ONLY gate consulted per attempt — it both
        admits the half-open probe and denies everything else while OPEN.
        """
        while self.breaker.allow_device() and budget.spend(self.now()):
            try:
                with TRACER.span("verify.device", sets=len(items)):
                    out = verify_with_bisection(self._device_call, items)
            except Exception:  # noqa: BLE001 — infrastructure, not verdict
                from ..utils.metrics import VERIFY_DEVICE_RETRIES

                VERIFY_DEVICE_RETRIES.inc()
                self.breaker.record_failure()
                if (len(items) > 1 and budget.attempts >= 2
                        and self.breaker.is_closed):
                    # infra-bisection: isolate a kernel-crashing input so
                    # the healthy half keeps its device throughput
                    mid = len(items) // 2
                    return (self._device_or_cpu(items[:mid], budget)
                            + self._device_or_cpu(items[mid:], budget))
                continue  # whole-batch retry
            self.breaker.record_success()
            self.journal.append(("device", len(items)))
            return out.verdicts
        return self._cpu(items).verdicts

    def cpu_batch(self, sets: list) -> BatchOutcome:
        """Force the ladder's CPU-oracle rung for ``sets``.

        The integrity guard re-verifies a *distrusted* dispatch through
        this rung: the device already lied once, so routing the re-verify
        back through it (as ``verify_batch`` would while the breaker is
        closed) could launder the same wrong verdict.  The scalar oracle
        is the trust floor."""
        return self._cpu(list(sets))

    def _cpu(self, sets: list) -> BatchOutcome:
        """Degraded mode: the CPU oracle, with the SAME bisection
        attribution so poisoned batches still name their bad sets."""
        from ..utils.metrics import VERIFY_DEGRADED_BATCHES

        VERIFY_DEGRADED_BATCHES.inc()
        self.journal.append(("cpu", len(sets)))
        with TRACER.span("verify.cpu", sets=len(sets)):
            out = verify_with_bisection(self.cpu_verify, sets)
        return BatchOutcome(verdicts=out.verdicts, device_calls=0)


_FALLBACK = object()  # dispatch-stage sentinel: batch must take the ladder


class PipelinedVerifier:
    """Host/device overlap on top of the :class:`ResilientVerifier` ladder.

    Three stages per batch — marshal (host worker pool), dispatch
    (non-blocking device enqueue), resolve (block on the verdict) — with
    at most ``depth`` batches in flight on the device (double-buffered by
    default).  Batch N+1 marshals while batch N's kernel runs, so a
    stream's wall time approaches max(marshal, device) instead of their
    sum.

    Never-drop/never-raise is preserved by construction: the fast path
    only short-circuits the all-valid case (device verdict True == every
    set True, exactly the AND-reduce's meaning).  Everything else —
    marshal failure, dispatch/resolve failure, breaker OPEN, device
    verdict False (needs bisection attribution) — hands the RAW sets to
    ``resilient.verify_batch``, the unchanged ladder.  The breaker is
    consulted before dispatch and fed by dispatch/resolve outcomes, so
    pipelined and ladder traffic share one view of device health; the
    ``processor.verify`` chaos site fires on every device dispatch, same
    as the ladder's device call.
    """

    def __init__(
        self,
        resilient: "ResilientVerifier",
        marshal: Callable[[list], Any],
        dispatch: Callable[[Any], Any],
        resolve: Callable[[Any], bool],
        workers: int = 2,
        depth: int = 2,
        injector=None,
        now: Callable[[], float] = time.perf_counter,
    ):
        self.resilient = resilient
        self._marshal = marshal
        self._dispatch = dispatch
        self._resolve = resolve
        self.workers = max(1, workers)
        self.depth = max(1, depth)
        self.now = now
        if injector is None:
            from ..utils import faults as _faults

            injector = _faults.INJECTOR
        self.injector = injector

    @classmethod
    def for_backend(cls, resilient: "ResilientVerifier", backend,
                    ingest=None, **kw) -> "PipelinedVerifier":
        """Wire the three stages to a ``TorchBackend``'s marshal_sets /
        dispatch / resolve split (crypto/bls/torch_backend/backend.py): on
        the card ``dispatch`` copies the operands into the key's CUDA graph
        and enqueues its replay without waiting, and ``resolve`` waits for
        the verdict.

        Pass an ``IngestEngine`` (lighthouse_tpu_torch/ingest) as ``ingest``
        to use its vectorized, cache-backed marshal as the host stage; it is
        byte-identical to ``backend.marshal_sets`` and degrades to it
        internally.  Where its registry gather runs on the card in a marshal
        worker, the batch carries ``MarshalledBatch.ready`` and ``dispatch``
        orders the replay after it on the card, with no host sync.
        """
        marshal = ingest.marshal_sets if ingest is not None \
            else backend.marshal_sets
        return cls(resilient, marshal, backend.dispatch,
                   backend.resolve, **kw)

    def verify_stream(self, batches: list[list]) -> list[BatchOutcome]:
        """Verify a stream of batches with marshal/device overlap;
        outcomes come back in input order, one per batch."""
        from ..utils import metrics as M

        batches = [list(b) for b in batches]
        if not batches:
            return []
        from concurrent.futures import ThreadPoolExecutor

        wall0 = self.now()
        marshal_busy = 0.0
        device_busy = 0.0
        outcomes: list[BatchOutcome] = []
        inflight: deque = deque()  # (sets, handle)

        def timed_marshal(sets):
            t0 = self.now()
            try:
                with TRACER.span("pipeline.marshal", sets=len(sets)):
                    mb = self._marshal(sets)
            except Exception:  # noqa: BLE001 — marshal failure -> ladder
                mb = None
            return mb, self.now() - t0

        with ThreadPoolExecutor(
            max_workers=self.workers,
            thread_name_prefix="marshal",
        ) as pool:
            futs = [pool.submit(timed_marshal, b) for b in batches]
            for sets, fut in zip(batches, futs):
                mb, m_secs = fut.result()
                marshal_busy += m_secs
                t0 = self.now()
                handle = self._dispatch_stage(mb)
                device_busy += self.now() - t0
                inflight.append((sets, handle))
                while len(inflight) > self.depth:
                    sets_done, h = inflight.popleft()
                    out, d_secs = self._resolve_stage(sets_done, h)
                    device_busy += d_secs
                    outcomes.append(out)
            while inflight:
                sets_done, h = inflight.popleft()
                out, d_secs = self._resolve_stage(sets_done, h)
                device_busy += d_secs
                outcomes.append(out)

        wall = max(self.now() - wall0, 1e-9)
        M.PIPELINE_MARSHAL_SECONDS.inc(marshal_busy)
        M.PIPELINE_DEVICE_SECONDS.inc(device_busy)
        M.PIPELINE_OCCUPANCY.set(100.0 * min(device_busy / wall, 1.0))
        return outcomes

    # -- stages ------------------------------------------------------------

    def _dispatch_stage(self, mb):
        """Enqueue one marshalled batch on the device, non-blocking.
        Returns the in-flight handle, or ``_FALLBACK`` when the batch
        must take the resilient ladder instead (marshal/validation
        failure, breaker says no device, dispatch raised)."""
        if mb is None or getattr(mb, "invalid", False):
            return _FALLBACK
        if not self.resilient.breaker.allow_device():
            return _FALLBACK
        try:
            with TRACER.span("pipeline.dispatch"):
                self.injector.fire("processor.verify")
                return self._dispatch(mb)
        except Exception:  # noqa: BLE001 — infrastructure, not verdict
            self.resilient.breaker.record_failure()
            return _FALLBACK

    def _resolve_stage(self, sets, handle):
        """Block on one in-flight batch; (BatchOutcome, device_seconds).
        Any outcome but a True verdict delegates to the ladder."""
        from ..utils import metrics as M

        if handle is _FALLBACK:
            M.PIPELINE_FALLBACKS.inc()
            return self.resilient.verify_batch(sets), 0.0
        t0 = self.now()
        try:
            with TRACER.span("pipeline.resolve", sets=len(sets)):
                ok = self._resolve(handle)
        except Exception:  # noqa: BLE001 — infrastructure, not verdict
            d = self.now() - t0
            self.resilient.breaker.record_failure()
            M.PIPELINE_FALLBACKS.inc()
            return self.resilient.verify_batch(sets), d
        d = self.now() - t0
        self.resilient.breaker.record_success()
        if ok:
            self.resilient.journal.append(("device", len(sets)))
            return (
                BatchOutcome(verdicts=[True] * len(sets), device_calls=1),
                d,
            )
        # verdict False: re-verify through the ladder for per-set
        # bisection attribution (False batches are the rare case)
        M.PIPELINE_FALLBACKS.inc()
        return self.resilient.verify_batch(sets), d


class DeadlineBatcher:
    """Deadline-driven batch assembly for one batchable kind.

    Flush triggers (whichever first):
    * the accumulation reaches the largest compiled device batch size, or
    * the slot-phase deadline arrives (e.g. attestations: 1/3 slot).

    The flush size snaps to a built power-of-two program key (padding
    waste is bounded and no new key is built mid-slot) — the device
    version of "batch sizes chosen for the CPU poisoning trade-off"
    (lib.rs:204-216).
    """

    def __init__(
        self,
        compiled_sizes: list[int],
        deadline_fn: Callable[[], float],
        now: Callable[[], float] = time.monotonic,
    ):
        self.sizes = sorted(compiled_sizes)
        self.deadline_fn = deadline_fn
        self.now = now
        self.pending: list = []

    def offer(self, item) -> list | None:
        self.pending.append(item)
        if len(self.pending) >= self.sizes[-1]:
            return self._take(self.sizes[-1])
        return None

    def poll(self) -> list | None:
        """Deadline check: flush whatever is pending at the phase edge."""
        if self.pending and self.now() >= self.deadline_fn():
            return self._take(len(self.pending))
        return None

    def _take(self, n: int) -> list:
        batch, self.pending = self.pending[:n], self.pending[n:]
        return batch

    def snap_size(self, n: int) -> int:
        """Smallest compiled size >= n (the program key the flush will run
        at; the pad is filled by the backend)."""
        for s in self.sizes:
            if s >= n:
                return s
        return self.sizes[-1]


# ---------------------------------------------------------------------------
# Reprocess / delay queue
# ---------------------------------------------------------------------------


@dataclass
class _Delayed:
    ready_at: float
    event: WorkEvent


class ReprocessQueue:
    """Delayed re-delivery — twin of beacon_processor/src/
    work_reprocessing_queue.rs (DelayQueue-based): blocks that arrive early
    wait for their slot; attestations referencing an unknown block wait for
    the block to land (or expire).  Drained by the manager loop each tick.
    """

    def __init__(self, now: Callable[[], float] = time.monotonic,
                 attestation_ttl: float = 12.0):
        self.now = now
        self.attestation_ttl = attestation_ttl
        self._timed: list[_Delayed] = []
        self._awaiting_block: dict[bytes, list[tuple[float, WorkEvent]]] = {}
        self.expired = 0

    def defer_until(self, ev: WorkEvent, ready_at: float) -> None:
        """Early block: park until its slot starts."""
        self._timed.append(_Delayed(ready_at=ready_at, event=ev))

    def defer_for_block(self, ev: WorkEvent, block_root: bytes) -> None:
        """Unknown-block attestation: park keyed by the missing root."""
        self._awaiting_block.setdefault(block_root, []).append(
            (self.now() + self.attestation_ttl, ev)
        )

    def block_imported(self, block_root: bytes) -> list[WorkEvent]:
        """The missing block arrived: release its waiters (unexpired)."""
        waiters = self._awaiting_block.pop(block_root, [])
        now = self.now()
        out = []
        for deadline, ev in waiters:
            if deadline >= now:
                out.append(ev)
            else:
                self.expired += 1
        return out

    def poll(self) -> list[WorkEvent]:
        """Release everything whose time has come; expire stale waiters."""
        now = self.now()
        ready = [d.event for d in self._timed if d.ready_at <= now]
        self._timed = [d for d in self._timed if d.ready_at > now]
        for root in list(self._awaiting_block):
            alive = [
                (dl, ev) for dl, ev in self._awaiting_block[root] if dl >= now
            ]
            self.expired += len(self._awaiting_block[root]) - len(alive)
            if alive:
                self._awaiting_block[root] = alive
            else:
                del self._awaiting_block[root]
        return ready

    def __len__(self):
        return len(self._timed) + sum(
            len(v) for v in self._awaiting_block.values()
        )
