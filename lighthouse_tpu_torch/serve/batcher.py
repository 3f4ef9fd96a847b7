"""Deadline-aware batcher: coalesce many tenants into device batches (the
port's copy of the JAX package's ``serve/batcher.py``).

The single-node ``DeadlineBatcher`` (beacon/processor.py) holds one
deadline for the whole assembly window; a multi-tenant front door cannot
— every submission arrives with its *own* deadline, and the batch must
flush when the **oldest** pending request is about to run out of road.
The policy, per arXiv:2302.00418's fill-or-flush knob:

* **fill** — the moment the pending pool reaches the largest compiled
  batch size, a full batch leaves (maximum device efficiency);
* **flush** — otherwise, when ``now >= oldest_deadline - flush_margin``
  a partial batch leaves so the oldest request can still make its
  deadline.  ``flush_margin`` is the headroom reserved for the device
  round trip — raising it flushes earlier (lower p99, more partial
  batches), lowering it lets batches fill (more throughput, later
  verdicts).  That margin is THE latency/throughput knob.

Entries are opaque ``(item, n_sets, deadline)`` triples ordered FIFO —
fairness across tenants is the admission controller's job (it bounds
what each tenant may have pending), not the batcher's.  ``now`` is
injectable so tests and the scenario engine drive a fake clock.
"""

from __future__ import annotations

import bisect
import time


class DeadlineAwareBatcher:
    """FIFO pool of deadline-carrying entries with fill-or-flush drain.

    Parameters
    ----------
    compiled_sizes:
        The device's built batch sizes (program keys), e.g. ``[512, 2048,
        8192]``.  On the card every padded size a flush can reach should be
        a key built before traffic: a first build takes tens of seconds.
        ``sizes[-1]`` is the fill threshold; ``snap_size`` rounds a
        drain up to the next compiled size for padding decisions.
    flush_margin:
        Seconds of headroom before the oldest deadline at which a
        partial batch is flushed.
    """

    def __init__(self, compiled_sizes, flush_margin: float = 0.02,
                 now=time.monotonic):
        self.sizes = sorted(compiled_sizes)
        if not self.sizes:
            raise ValueError("need at least one compiled batch size")
        self.flush_margin = float(flush_margin)
        self._now = now
        #: pending (item, n_sets, deadline) in arrival order
        self.pending: list[tuple[object, int, float]] = []
        self._pending_sets = 0
        self.flushes_full = 0
        self.flushes_deadline = 0

    def __len__(self) -> int:
        return len(self.pending)

    @property
    def pending_sets(self) -> int:
        """Signature sets (not requests) currently pooled."""
        return self._pending_sets

    def offer(self, item, n_sets: int, deadline: float) -> None:
        """Add one admitted request carrying ``n_sets`` signature sets
        and an absolute ``deadline`` (same clock as ``now``)."""
        self.pending.append((item, int(n_sets), float(deadline)))
        self._pending_sets += int(n_sets)

    def due(self) -> str | None:
        """Why the pool should drain right now: ``"full"``,
        ``"deadline"``, or None (keep filling)."""
        if not self.pending:
            return None
        if self._pending_sets >= self.sizes[-1]:
            return "full"
        oldest = min(d for _, _, d in self.pending)
        if self._now() >= oldest - self.flush_margin:
            return "deadline"
        return None

    def poll(self):
        """Drain one device batch if due: ``(items, trigger)`` where
        ``trigger`` is ``"full"`` or ``"deadline"``; None otherwise.
        A full drain takes whole requests up to the largest compiled
        size and leaves the remainder pooled (FIFO)."""
        trigger = self.due()
        if trigger is None:
            return None
        if trigger == "full":
            self.flushes_full += 1
            cap = self.sizes[-1]
            taken, n = [], 0
            while self.pending and n + self.pending[0][1] <= cap:
                entry = self.pending.pop(0)
                taken.append(entry)
                n += entry[1]
            if not taken:
                # one oversized request: it IS the batch
                taken.append(self.pending.pop(0))
            self._pending_sets -= sum(e[1] for e in taken)
            return [e[0] for e in taken], "full"
        self.flushes_deadline += 1
        return self.drain_all(), "deadline"

    def drain_all(self) -> list:
        """Take every pending item unconditionally (deadline flushes,
        shutdown, tests)."""
        items = [e[0] for e in self.pending]
        self.pending.clear()
        self._pending_sets = 0
        return items

    def snap_size(self, n: int) -> int:
        """Smallest compiled size >= n (padding target); the largest
        size when n exceeds every compiled program."""
        i = bisect.bisect_left(self.sizes, n)
        return self.sizes[min(i, len(self.sizes) - 1)]
