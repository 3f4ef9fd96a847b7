"""Span tracer: a thread-safe ring buffer of timing spans.

The port's own copy of the part of the JAX package's ``obs/tracer.py`` that
the ingest engine, warm boot, the pod, the verifier ladder, the integrity
guard and the verify service use: ``TRACER.span(name, **fields)`` as a
context manager (``.add(**fields)`` on the open span), ``TRACER.instant(name,
**fields)`` for a point event, nested spans linked to their parent on the same
thread, and the most recent ``CAPACITY`` spans kept for ``snapshot()``.  The
flight recorder: ``dump(path)`` writes the ring as Chrome trace-event JSON,
and ``maybe_dump(reason)`` does so into the directory of
``configure_dump_dir`` (or ``$LIGHTHOUSE_TPU_TRACE_DIR``), at most eight files
per reason, never raising; with neither set it writes nothing.  Span names
are a closed set (``SPANS``).  Clocks are ``time.perf_counter()``: only
deltas mean anything.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from typing import NamedTuple

log = logging.getLogger("lighthouse_tpu_torch.obs.tracer")

DUMP_LIMIT = 8  # flight-recorder files per reason per process

CAPACITY = 8192  # spans kept; the oldest is dropped first

SPANS: dict[str, str] = {
    "ingest.marshal": "IngestEngine vectorized marshal of one batch",
    "ingest.expand": "batched SHA-256 hash-to-field draws for the batch",
    "ingest.encode": "pubkey cache resolve + operand limb assembly",
    "aot.capture": "AOT store: one program's operand skeleton written after its first build",
    "prewarm.load": "warm boot: one store entry read, verified and its program built",
    "autotune.trial": "autotune: one arm's timed Montgomery-product trial at one batch shape",
    "verify.batch": "verify_batch of the pod or the ladder: one batch, retries and fallbacks included",
    "verify.device": "ResilientVerifier: one device attempt with bisection attribution",
    "verify.cpu": "ResilientVerifier: the CPU oracle rung for one batch",
    "breaker.transition": "CircuitBreaker state transition (closed / open / half-open)",
    "pipeline.marshal": "PipelinedVerifier: the host marshal of one batch on a worker",
    "pipeline.dispatch": "PipelinedVerifier: the non-blocking device enqueue of one batch",
    "pipeline.resolve": "PipelinedVerifier: the wait for one in-flight verdict",
    "integrity.canary": "IntegrityGuard: the canary known-answer sweep around one dispatch",
    "integrity.audit": "CrossArmAuditor: one batch re-verified on an independent arm",
    "integrity.selfcheck": "run_selfcheck: the boot-time known-answer sweep over the programs",
    "integrity.quarantine": "IntegrityGuard: a struck device quarantined out of the pod",
    "serve.submit": "VerifyService: admission of one tenant submission",
    "serve.dispatch": "VerifyService: one coalesced batch through the verifier",
    "pod.dispatch": "pod: one dispatch round over the mesh (sharded program or shard threads)",
    "pod.reshard": "pod: a round lost a seat and the batch re-shards onto the survivors",
    "block.import": "BeaconChain.process_block end-to-end (beacon/chain.py)",
    "sync.batch": "SyncManager: one range batch, request through import (beacon/sync.py)",
}


class SpanRecord(NamedTuple):
    sid: int  # unique, increasing span id
    parent: int  # sid of the enclosing span on this thread, or 0
    name: str  # key of SPANS
    t0: float  # perf_counter() at entry
    dur: float  # seconds
    tid: int  # thread id
    fields: tuple  # sorted (key, value) pairs


class _LiveSpan:
    """An open span; commits itself to the tracer's ring on ``__exit__``."""

    __slots__ = ("_tracer", "name", "fields", "sid", "parent", "t0")

    def __init__(self, tracer, name, fields):
        self._tracer = tracer
        self.name = name
        self.fields = fields
        self.sid = 0
        self.parent = 0
        self.t0 = 0.0

    def add(self, **fields):
        """Attach more fields to the span before it closes."""
        self.fields.update(fields)
        return self

    def __enter__(self):
        tracer = self._tracer
        self.sid = next(tracer._ids)
        stack = tracer._stack()
        if stack:
            self.parent = stack[-1]
        stack.append(self.sid)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self.t0
        stack = self._tracer._stack()
        if stack and stack[-1] == self.sid:
            stack.pop()
        if exc_type is not None:
            self.fields["error"] = exc_type.__name__
        self._tracer._commit(self, dur)
        return False


class Tracer:
    """Ring buffer of the last ``CAPACITY`` spans, oldest dropped first."""

    def __init__(self):
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=CAPACITY)
        self._dump_dir: str | None = None
        self._dump_seq: dict = {}

    def span(self, name: str, **fields):
        """Open a span: ``with TRACER.span("ingest.marshal", sets=n):``."""
        if name not in SPANS:
            raise ValueError(f"unknown span name {name!r}")
        return _LiveSpan(self, name, fields)

    def instant(self, name: str, **fields) -> None:
        """Record a zero-duration point event (a state transition)."""
        if name not in SPANS:
            raise ValueError(f"unknown span name {name!r}")
        sp = _LiveSpan(self, name, fields)
        sp.sid = next(self._ids)
        stack = self._stack()
        if stack:
            sp.parent = stack[-1]
        sp.t0 = time.perf_counter()
        self._commit(sp, 0.0)

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _commit(self, sp: _LiveSpan, dur: float) -> None:
        rec = SpanRecord(sp.sid, sp.parent, sp.name, sp.t0, dur, threading.get_ident(),
                         tuple(sorted(sp.fields.items())))
        with self._lock:
            self._buf.append(rec)

    def snapshot(self, since_sid: int = 0) -> list:
        """The spans in the ring with ``sid > since_sid``, oldest first."""
        with self._lock:
            recs = list(self._buf)
        return [r for r in recs if r.sid > since_sid]

    def chrome_trace(self, since_sid: int = 0) -> dict:
        """The ring as a Chrome trace-event JSON object."""
        events = []
        for r in self.snapshot(since_sid):
            args = {k: v if isinstance(v, (bool, int, float, str)) or v is None else repr(v)
                    for k, v in r.fields}
            args["sid"] = r.sid
            if r.parent:
                args["parent"] = r.parent
            events.append({"name": r.name, "cat": "lighthouse_tpu_torch", "ph": "X",
                           "ts": round(r.t0 * 1e6, 3), "dur": round(r.dur * 1e6, 3),
                           "pid": os.getpid(), "tid": r.tid, "args": args})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump(self, path: str, since_sid: int = 0) -> str:
        """Write the ring as Chrome trace JSON to ``path``; returns ``path``."""
        doc = self.chrome_trace(since_sid)
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, separators=(",", ":"))
        os.replace(tmp, path)
        return path

    def configure_dump_dir(self, path: str | None) -> None:
        """Directory for ``maybe_dump``'s files (None: the environment's)."""
        with self._lock:
            self._dump_dir = path
            self._dump_seq = {}

    def maybe_dump(self, reason: str, since_sid: int = 0) -> str | None:
        """Best-effort flight-recorder dump (a breaker opening):
        ``trace-<reason>-<NNN>.json`` in the configured directory, or
        ``$LIGHTHOUSE_TPU_TRACE_DIR``; None when neither is set or the
        reason has had its ``DUMP_LIMIT`` files.  Never raises: the breaker
        calls it on a never-raise path."""
        try:
            with self._lock:
                dump_dir = self._dump_dir or os.environ.get("LIGHTHOUSE_TPU_TRACE_DIR")
                if not dump_dir:
                    return None
                seq = self._dump_seq.get(reason, 0) + 1
                if seq > DUMP_LIMIT:
                    return None
                self._dump_seq[reason] = seq
            os.makedirs(dump_dir, exist_ok=True)
            path = self.dump(os.path.join(dump_dir, f"trace-{reason}-{seq:03d}.json"),
                             since_sid)
            log.info("flight-recorder dump (%s) -> %s", reason, path)
            return path
        except Exception as exc:  # noqa: BLE001 — diagnostics never raise
            log.warning("flight-recorder dump failed (%s): %s", reason, exc)
            return None


#: The process-wide tracer every span of the port goes to.
TRACER = Tracer()
