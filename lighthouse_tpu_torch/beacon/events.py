"""Server-sent-events hub: the chain's observable event stream.

Twin of beacon_node/beacon_chain/src/events.rs (ServerSentEventHandler,
230 LoC): bounded per-subscriber queues fed by chain milestones (head,
block, attestation, finalized_checkpoint, blob_sidecar), drained by the
HTTP API's `/eth/v1/events` SSE endpoint — the standard VC/monitoring
integration point.
"""

from __future__ import annotations

import queue
import threading

EVENT_KINDS = (
    "head",
    "block",
    "attestation",
    "finalized_checkpoint",
    "blob_sidecar",
    "voluntary_exit",
    "contribution_and_proof",
)


class EventBroadcaster:
    """Fan-out with per-subscriber bounded queues; a slow consumer drops
    its own events (lagged), never stalls the chain."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._subs: list[queue.Queue] = []
        self._lock = threading.Lock()

    def subscribe(self) -> queue.Queue:
        q: queue.Queue = queue.Queue(maxsize=self.capacity)
        with self._lock:
            self._subs.append(q)
        return q

    def unsubscribe(self, q: queue.Queue) -> None:
        with self._lock:
            try:
                self._subs.remove(q)
            except ValueError:
                pass

    def emit(self, kind: str, data: dict) -> None:
        with self._lock:
            subs = list(self._subs)
        for q in subs:
            try:
                q.put_nowait((kind, data))
            except queue.Full:
                pass  # lagged consumer: drop, don't block the chain

    @property
    def subscriber_count(self) -> int:
        with self._lock:
            return len(self._subs)
