"""Span tracer: a thread-safe ring buffer of timing spans.

The port's own copy of the part of the JAX package's ``obs/tracer.py`` that
the ingest engine, warm boot and the pod use: ``TRACER.span(name, **fields)``
as a context manager, ``TRACER.instant(name, **fields)`` for a point event,
nested spans linked to their parent on the same thread, and the most recent
``CAPACITY`` spans kept for ``snapshot()``.  Span names are a
closed set (``SPANS``).  Clocks are ``time.perf_counter()``: only deltas
mean anything.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import NamedTuple

CAPACITY = 8192  # spans kept; the oldest is dropped first

SPANS: dict[str, str] = {
    "ingest.marshal": "IngestEngine vectorized marshal of one batch",
    "ingest.expand": "batched SHA-256 hash-to-field draws for the batch",
    "ingest.encode": "pubkey cache resolve + operand limb assembly",
    "aot.capture": "AOT store: one program's operand skeleton written after its first build",
    "prewarm.load": "warm boot: one store entry read, verified and its program built",
    "autotune.trial": "autotune: one arm's timed Montgomery-product trial at one batch shape",
    "verify.batch": "PodVerifier.verify_batch: one batch through the pod and its ladder",
    "pod.dispatch": "pod: one dispatch round over the mesh (sharded program or shard threads)",
    "pod.reshard": "pod: a round lost a seat and the batch re-shards onto the survivors",
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


#: The process-wide tracer every span of the port goes to.
TRACER = Tracer()
