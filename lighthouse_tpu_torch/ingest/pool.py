"""Marshal worker pool: shard a batch across host threads.

The port's copy of the JAX package's ``ingest/pool.py``, with one change:
by default it runs inline (one worker), and ``LIGHTHOUSE_TPU_INGEST_WORKERS``
asks for more.  The reference defaults to one worker per core on the ground
that numpy releases the GIL inside its ufunc loops.  The SHA lanes are
thousands of numpy calls on shards of a few hundred lanes, each call's
Python overhead larger than its loop, so the threads queue on the GIL
instead: on the H100's 8-core host the engine's marshal of 4,096 distinct
messages took 7.9 s through eight threads against the scalar marshal's
0.24 s (chip_smoke.py's registry phase times both; PERF.md).

Shards are pure maps: ``map_shards(fn, items)`` returns exactly
``fn(items)``'s elements in input order, so sharding can never perturb
byte-identity with the scalar oracle.  Small batches run inline — the
pool only engages when a shard is worth a dispatch.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

from ..utils import metrics as M

# Below this many items per would-be shard, dispatch overhead beats the
# parallelism: run inline.
MIN_SHARD = 256

_ENV_WORKERS = "LIGHTHOUSE_TPU_INGEST_WORKERS"


def default_workers() -> int:
    """``LIGHTHOUSE_TPU_INGEST_WORKERS``, else 1 (see the module docstring)."""
    env = os.environ.get(_ENV_WORKERS, "").strip()
    return max(1, int(env)) if env else 1


class MarshalPool:
    """Lazy thread pool for batch-sharded marshal stages."""

    def __init__(self, workers: int | None = None,
                 min_shard: int = MIN_SHARD):
        self.workers = workers if workers is not None else default_workers()
        self.workers = max(1, int(self.workers))
        self.min_shard = max(1, int(min_shard))
        self._lock = threading.Lock()
        self._pool: ThreadPoolExecutor | None = None

    def _executor(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.workers,
                    thread_name_prefix="ingest-marshal",
                )
            return self._pool

    def shard_count(self, n_items: int) -> int:
        """How many shards ``map_shards`` would split ``n_items`` into."""
        if self.workers <= 1:
            return 1
        return max(1, min(self.workers, n_items // self.min_shard))

    def map_shards(self, fn, items: list) -> list:
        """Apply ``fn: list -> list`` over contiguous shards of ``items``
        concurrently; concatenate results in input order.

        ``fn`` must be a pure element-wise map (len(fn(xs)) == len(xs)),
        which makes sharding invisible to the output — asserted here.
        """
        n = len(items)
        shards = self.shard_count(n)
        M.INGEST_POOL_DEPTH.set(shards)
        if shards <= 1:
            out = fn(items)
        else:
            bounds = [(i * n) // shards for i in range(shards + 1)]
            chunks = [items[bounds[i]:bounds[i + 1]] for i in range(shards)]
            out = []
            for part in self._executor().map(fn, chunks):
                out.extend(part)
        if len(out) != n:
            raise ValueError(
                f"marshal shard fn returned {len(out)} results for {n} items"
            )
        return out

    def close(self) -> None:
        with self._lock:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None
