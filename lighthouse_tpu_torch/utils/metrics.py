"""Process-global counters, gauges and histograms of the port.

The port's own copy of the parts of the JAX package's ``utils/metrics.py``
that it reads.  The ingest engine's: the cache counters prove that repeat
signers skip aggregation and limb encode, the rate gauge and the pool depth
say whether the marshal keeps pace with the card, and the fallback counter
counts every degradation of the vectorized marshal.  Warm boot's: the
program build histogram, the AOT store's hit, miss and reject counters and
the compile-cache error counter.  The pod's (parallel/pod.py): the live mesh
width, exclusions, re-arms, re-shards, retries and ladder fallbacks, and the
batch latency.  Each counter and gauge is thread-safe and has ``inc``,
``set`` and ``value()``; a histogram has ``observe``, ``count()`` and
``timer()``.
"""

from __future__ import annotations

import threading
import time


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def value(self) -> float:
        with self._lock:
            return self._value


class Counter(_Metric):
    kind = "counter"


class Gauge(_Metric):
    kind = "gauge"


class Histogram:
    """Observations of one quantity, counted (the reference's buckets and sum
    are not kept: nothing in the port reads them; a build's seconds are in
    its build record)."""

    kind = "histogram"

    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self._count += 1

    def count(self) -> int:
        with self._lock:
            return self._count

    def timer(self):
        """A context manager observing the seconds of its block."""
        return _Timer(self)


class _Timer:
    def __init__(self, hist: Histogram):
        self._hist = hist
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0)
        return False


INGEST_CACHE_HITS = Counter(
    "ingest_pubkey_cache_hits_total",
    "Signer sets whose aggregated-pubkey limbs came from the cache "
    "(registry tier or aggregate LRU): no aggregation, no limb encode",
)
INGEST_CACHE_MISSES = Counter(
    "ingest_pubkey_cache_misses_total",
    "Signer sets that had to be aggregated and limb-encoded on the host",
)
INGEST_CACHE_EVICTIONS = Counter(
    "ingest_pubkey_cache_evictions_total",
    "Aggregate-LRU entries dropped (capacity bound or epoch-boundary invalidation)",
)
INGEST_CACHE_KEYS = Gauge(
    "ingest_pubkey_cache_keys",
    "Resident cache entries: registry validators plus live LRU aggregates",
)
INGEST_POOL_DEPTH = Gauge(
    "ingest_pool_depth",
    "Shards the marshal pool split the last batch into (1 == inline)",
)
INGEST_MARSHAL_RATE = Gauge(
    "ingest_marshal_rate",
    "Sets marshalled per second by the last vectorized marshal call",
)
INGEST_FALLBACKS = Counter(
    "ingest_fallbacks_total",
    "Ingest marshal degradations: the vectorized path fell back to the scalar "
    "marshal, or the scalar fallback itself failed (invalid batch)",
)

# Warm boot (torch_backend/aot.py, backend.enable_compile_cache).  A program
# build is one key's first call: on the card its warm-up, capture and
# instantiation, on the CPU its first eager run (the counterpart of the
# reference's first traced-and-compiled call per kernel cache key).
JIT_COMPILE_SECONDS = Histogram(
    "jit_compile_seconds",
    "Program build wall time (first call per program key: warm-up, capture "
    "and instantiate on the card), one observation per build",
)
# hits = an entry's skeleton read and verified, misses = no entry for the
# program or an entry stale for this process, rejects = an entry present
# that fails integrity (manifest or plan signature, skeleton sha256, skeleton
# parse): a reject costs the next traffic a build, never an error.
AOT_CACHE_HITS = Counter(
    "aot_cache_hits_total",
    "AOT store entries whose operand skeleton was read and verified",
)
AOT_CACHE_MISSES = Counter(
    "aot_cache_misses_total",
    "AOT store lookups with no usable entry (absent, or stale for this "
    "torch / CUDA version, device or arm)",
)
AOT_CACHE_REJECTS = Counter(
    "aot_cache_rejects_total",
    "AOT store entries rejected by integrity checks (manifest signature, "
    "skeleton sha256, skeleton parse)",
)
COMPILE_CACHE_ERRORS = Counter(
    "compile_cache_errors_total",
    "Failures pointing the kernel libraries' build root at a cache directory: "
    "a dead cache re-pays every nvcc build on every boot",
)

# The pod (parallel/pod.py PodVerifier): the live mesh width (8/4/2/1 after
# exclusions), the device health tracker's exclusions and re-arms, the
# recovery work the fault domains absorbed (re-shards, retries), and the
# batches handed down the ladder to the single-device verifier.
VERIFY_BATCH_LATENCY = Histogram(
    "verify_batch_latency_seconds",
    "verify_batch wall time per batch (the pod's rounds and its ladder included)",
)
POD_ACTIVE_SHARDS = Gauge(
    "pod_active_shards",
    "Seats the pod verifier is dispatching across (mesh width after exclusions: "
    "8/4/2/1, 0 before first use)",
)
POD_EXCLUSIONS = Counter(
    "pod_device_exclusions_total",
    "Seats excluded from the pod mesh after consecutive shard failures",
)
POD_RESHARDS = Counter(
    "pod_reshards_total",
    "Batches re-sharded onto a reduced mesh after shard failures",
)
POD_RETRIES = Counter(
    "pod_shard_retries_total",
    "Per-shard dispatch attempts past the first (timeout or device fault)",
)
POD_REARMS = Counter(
    "pod_device_rearms_total",
    "Excluded seats re-admitted to the mesh after a probe batch succeeded",
)
POD_FALLBACKS = Counter(
    "pod_fallbacks_total",
    "Batches the pod handed to the single-device verifier's ladder (mesh "
    "exhausted, breaker open, or a shard verdict False)",
)
