"""Process-global counters, gauges and histograms of the port.

The port's own copy of the parts of the JAX package's ``utils/metrics.py``
that it reads.  The ingest engine's: the cache counters prove that repeat
signers skip aggregation and limb encode, the rate gauge and the pool depth
say whether the marshal keeps pace with the card, and the fallback counter
counts every degradation of the vectorized marshal.  Warm boot's: the
program build histogram, the AOT store's hit, miss and reject counters and
the compile-cache error counter.  The pod's (parallel/pod.py): the live mesh
width, exclusions, re-arms, re-shards, retries and ladder fallbacks, and the
batch latency.  The verifier ladder's (beacon/processor.py): breaker
transitions, device retries, batches on the CPU rung, shed work, and the
pipeline's busy times, occupancy and fallbacks.  The verify service's
(serve/) and the integrity guard's (integrity/), under the reference's
names and labels.  Each counter and gauge is thread-safe and has ``inc``,
``set`` and ``value()``; a histogram has ``observe``, ``count()``,
``sum()`` and ``timer()``.  Every method takes an optional ``labels``
tuple (the reference's label values, in its order); ``()`` is the
unlabelled series.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str, label_names: tuple = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._values: dict = defaultdict(float)
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, labels: tuple = ()) -> None:
        with self._lock:
            self._values[labels] += amount

    def set(self, v: float, labels: tuple = ()) -> None:
        with self._lock:
            self._values[labels] = v

    def value(self, labels: tuple = ()) -> float:
        with self._lock:
            return self._values.get(labels, 0.0)

    def samples(self) -> dict:
        """Every series, labels -> value."""
        with self._lock:
            return dict(self._values)


class Counter(_Metric):
    kind = "counter"


class Gauge(_Metric):
    kind = "gauge"


class Histogram:
    """Observations of one quantity, counted and summed per label tuple (the
    reference's buckets are not kept: nothing in the port reads them; a
    build's seconds are in its build record)."""

    kind = "histogram"

    def __init__(self, name: str, help_: str, label_names: tuple = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._counts: dict = defaultdict(int)
        self._sums: dict = defaultdict(float)
        self._lock = threading.Lock()

    def observe(self, v: float, labels: tuple = ()) -> None:
        with self._lock:
            self._counts[labels] += 1
            self._sums[labels] += v

    def count(self, labels: tuple = ()) -> int:
        with self._lock:
            return self._counts.get(labels, 0)

    def sum(self, labels: tuple = ()) -> float:
        with self._lock:
            return self._sums.get(labels, 0.0)

    def timer(self, labels: tuple = ()):
        """A context manager observing the seconds of its block."""
        return _Timer(self, labels)


class _Timer:
    def __init__(self, hist: Histogram, labels: tuple = ()):
        self._hist = hist
        self._labels = labels
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0, self._labels)
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

# The verifier ladder (beacon/processor.py): the breaker's transitions, the
# device attempts retried, the batches the CPU rung took, the work shed in
# degraded mode, and the pipeline's stage busy times and fallbacks.
BREAKER_TRANSITIONS = Counter(
    "breaker_transitions_total",
    "CircuitBreaker state transitions, by new state",
    ("state",),
)
VERIFY_DEGRADED_BATCHES = Counter(
    "verify_degraded_batches_total",
    "Signature batches verified on the CPU fallback (breaker open or "
    "device retry budget exhausted)",
)
VERIFY_DEVICE_RETRIES = Counter(
    "verify_device_retries_total",
    "Device batch-verify attempts retried after an infrastructure failure",
)
PROCESSOR_SHED = Counter(
    "processor_shed_total",
    "Work events shed in degraded mode, by kind",
    ("kind",),
)
PIPELINE_MARSHAL_SECONDS = Gauge(
    "pipeline_marshal_seconds_total",
    "Cumulative host marshal busy time in the pipelined verify path",
)
PIPELINE_DEVICE_SECONDS = Gauge(
    "pipeline_device_seconds_total",
    "Cumulative device dispatch+wait busy time in the pipelined verify path",
)
PIPELINE_OCCUPANCY = Gauge(
    "pipeline_device_occupancy_percent",
    "Device busy time as a percent of wall time over the last verify stream "
    "(100 == perfect marshal/device overlap)",
)
PIPELINE_FALLBACKS = Counter(
    "pipeline_resilient_fallbacks_total",
    "Pipelined batches handed to the ResilientVerifier ladder (device "
    "verdict False, dispatch failure, or marshal failure)",
)

# The verify service (serve/): admission, the batcher's flushes, the
# dispatch failures the pump absorbed, and the latencies tenants see.
SERVE_ACCEPTED = Counter(
    "serve_accepted_total",
    "Submissions admitted into the batcher, by tenant",
    ("tenant",),
)
SERVE_SHED = Counter(
    "serve_shed_total",
    "Submissions refused at admission, by tenant and reason "
    "(rate-limit / queue-full / degraded / malformed)",
    ("tenant", "reason"),
)
SERVE_DEADLINE_MISS = Counter(
    "serve_deadline_miss_total",
    "Accepted submissions whose verdicts landed after their deadline, by tenant",
    ("tenant",),
)
SERVE_FLUSHES = Counter(
    "serve_flushes_total",
    "Device-batch flushes out of the deadline-aware batcher, by trigger "
    "(full = batch reached the largest compiled size, deadline = the "
    "oldest request's deadline neared)",
    ("trigger",),
)
SERVE_ERRORS = Counter(
    "serve_errors_total",
    "VerifyService dispatch failures absorbed by the never-raise tick "
    "(affected requests fail closed)",
)
SERVE_QUEUE_WAIT = Histogram(
    "serve_queue_wait_seconds",
    "Wait between admission and batch dispatch, by tenant: the price of "
    "the fill/flush knob",
    ("tenant",),
)
SERVE_E2E_LATENCY = Histogram(
    "serve_e2e_latency_seconds",
    "End-to-end submit-to-verdict latency, by tenant",
    ("tenant",),
)

# The verdict-integrity guard (integrity/).
INTEGRITY_CANARY_CHECKS = Counter(
    "integrity_canary_checks_total",
    "Canary known-answer sweeps around real dispatches, by result (ok / mismatch)",
    ("result",),
)
INTEGRITY_DISTRUSTED = Counter(
    "integrity_distrusted_dispatches_total",
    "Dispatches whose canary verdicts disagreed with the precomputed "
    "expectation: the whole dispatch is discarded and re-laddered",
)
INTEGRITY_RELADDERED = Counter(
    "integrity_reladdered_sets_total",
    "Real signature sets re-verified through the CPU-oracle rung because "
    "their original dispatch was distrusted or failed audit",
)
INTEGRITY_AUDITS = Counter(
    "integrity_audits_total",
    "Cross-arm audit re-verifications of accepted batches, by reference "
    "mode (autotuner arm id or cpu floor)",
    ("mode",),
)
INTEGRITY_SDC_EVENTS = Counter(
    "integrity_sdc_events_total",
    "Silent-data-corruption detections, by source (canary mismatch or "
    "audit disagreement)",
    ("source",),
)
INTEGRITY_TRUST_STRIKES = Counter(
    "integrity_trust_strikes_total",
    "Per-device trust strikes from failed canary probes during SDC attribution",
    ("device",),
)
INTEGRITY_QUARANTINES = Counter(
    "integrity_quarantines_total",
    "Devices quarantined out of the pod mesh after crossing the trust "
    "strike threshold (readmission requires a canary-only probe)",
)
INTEGRITY_GUARD_BACKSTOPS = Counter(
    "integrity_guard_backstops_total",
    "IntegrityGuard.verify_batch never-raise backstop activations "
    "(batch failed closed all-False)",
)
