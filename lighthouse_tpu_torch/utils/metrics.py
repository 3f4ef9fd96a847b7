"""Process-global counters, gauges and histograms of the port, and their
Prometheus text exposition (``render()``).

The port's own copy of the JAX package's ``utils/metrics.py``: the registry
and the metric classes as there, and the metrics the port's layers write.
The ingest engine's: the cache counters prove that repeat signers skip
aggregation and limb encode, the rate gauge and the pool depth say whether
the marshal keeps pace with the card, and the fallback counter counts every
degradation of the vectorized marshal.  Warm boot's: the program build
histogram, the AOT store's hit, miss and reject counters and the
compile-cache error counter.  The pod's (parallel/pod.py): the live mesh
width, exclusions, re-arms, re-shards, retries and ladder fallbacks, and the
batch latency.  The verifier ladder's (beacon/processor.py): breaker
transitions, device retries, batches on the CPU rung, shed work, and the
pipeline's busy times, occupancy and fallbacks.  The verify service's
(serve/) and the integrity guard's (integrity/), and the node layers'
(beacon/, store/, network/, utils/executor.py), under the reference's names
and labels.  Each counter and gauge is thread-safe and has ``inc`` and
``value()`` (a gauge also ``set`` and ``dec``); a histogram has ``observe``,
``count()``, ``sum()``, ``timer()``, ``bucket_counts()`` and ``quantile()``.
Every method takes an optional ``labels`` tuple (the reference's label
values, in its order); ``()`` is the unlabelled series.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict


_REGISTRY: list["_Metric"] = []
_REG_LOCK = threading.Lock()


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str, label_names: tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._values: dict[tuple, float] = defaultdict(float)
        self._lock = threading.Lock()
        with _REG_LOCK:
            _REGISTRY.append(self)

    def _fmt_labels(self, labels: tuple) -> str:
        if not labels:
            return ""
        if self.label_names and len(self.label_names) == len(labels):
            inner = ",".join(
                f'{n}="{v}"' for n, v in zip(self.label_names, labels)
            )
        else:
            inner = ",".join(f'l{i}="{v}"' for i, v in enumerate(labels))
        return "{" + inner + "}"

    def samples(self):
        with self._lock:
            return list(self._values.items())


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, labels: tuple = ()):
        with self._lock:
            self._values[labels] += amount

    def value(self, labels: tuple = ()) -> float:
        with self._lock:
            return self._values[labels]


class Gauge(_Metric):
    kind = "gauge"

    def set(self, v: float, labels: tuple = ()):
        with self._lock:
            self._values[labels] = v

    def inc(self, amount: float = 1.0, labels: tuple = ()):
        with self._lock:
            self._values[labels] += amount

    def dec(self, amount: float = 1.0, labels: tuple = ()):
        with self._lock:
            self._values[labels] -= amount

    def value(self, labels: tuple = ()) -> float:
        with self._lock:
            return self._values[labels]


class Histogram(_Metric):
    kind = "histogram"

    DEFAULT_BUCKETS = (
        0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
        1.0, 2.5, 5.0, 10.0,
    )

    def __init__(self, name, help_, buckets=None, label_names=()):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self._counts: dict[tuple, list[int]] = defaultdict(
            lambda: [0] * (len(self.buckets) + 1)
        )
        self._sums: dict[tuple, float] = defaultdict(float)

    def observe(self, v: float, labels: tuple = ()):
        with self._lock:
            counts = self._counts[labels]
            for i, edge in enumerate(self.buckets):
                if v <= edge:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[labels] += v
            self._values[labels] += 1  # total count

    def timer(self, labels: tuple = ()):
        return _Timer(self, labels)

    def count(self, labels: tuple = ()) -> int:
        with self._lock:
            return int(self._values[labels])

    def sum(self, labels: tuple = ()) -> float:
        with self._lock:
            return self._sums[labels]

    def bucket_counts(self, labels: tuple = ()) -> list[int]:
        """Snapshot of per-bucket counts (last entry = +Inf overflow).
        SLO evaluators subtract two snapshots to get a window's
        distribution and feed the delta back through :meth:`quantile`."""
        with self._lock:
            c = self._counts.get(labels)
            return list(c) if c else [0] * (len(self.buckets) + 1)

    def quantile(self, q: float, labels: tuple = (),
                 counts: list[int] | None = None) -> float:
        """Bucket-interpolated quantile estimate (``histogram_quantile``
        semantics): linear within the winning bucket, clamped to the
        highest finite edge when the rank lands in +Inf, 0.0 when empty.
        Pass ``counts`` (e.g. a snapshot delta) to evaluate a window
        instead of the lifetime distribution."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if counts is None:
            counts = self.bucket_counts(labels)
        total = sum(counts)
        if total <= 0:
            return 0.0
        rank = q * total
        cum = 0
        lo = 0.0
        for edge, c in zip(self.buckets, counts):
            cum += c
            if c > 0 and cum >= rank:
                frac = (rank - (cum - c)) / c
                return lo + (edge - lo) * frac
            lo = edge
        return self.buckets[-1]  # rank fell in the +Inf bucket


class _Timer:
    def __init__(self, hist: Histogram, labels: tuple):
        self.hist = hist
        self.labels = labels

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self.t0, self.labels)


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
    label_names=("tenant",),
)
SERVE_E2E_LATENCY = Histogram(
    "serve_e2e_latency_seconds",
    "End-to-end submit-to-verdict latency, by tenant",
    label_names=("tenant",),
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

# The node layers (the copies of beacon/, store/, network/, utils/executor.py
# and consensus/ssz.py): the supervised tasks' restarts, block import
# latency, the store's torn-tail recovery, range sync and peer scoring, the
# deposit queue, the attestation pool's verify cost and the SSZ hash cache.
FAULTS_INJECTED = Counter(
    "faults_injected_total",
    "Faults fired by the FaultInjector, by site",
    ("site",),
)
TASKS_RESTARTED = Counter(
    "executor_tasks_restarted_total",
    "Supervised task restarts after a crash, by name",
    ("name",),
)
TASKS_ABANDONED = Counter(
    "executor_tasks_abandoned_total",
    "Supervised tasks that exhausted their restart cap, by name",
    ("name",),
)
BLOCK_IMPORT_LATENCY = Histogram(
    "block_import_latency_seconds",
    "End-to-end block import latency (process_block entry to fork choice "
    "update + store durability point)",
)
STORE_TORN_TAIL_RECOVERIES = Counter(
    "store_torn_tail_recoveries_total",
    "Store opens that detected and truncated a torn or corrupt log tail",
)
STORE_RECORDS_DROPPED = Counter(
    "store_records_dropped_total",
    "Log record frames lost past the valid prefix in torn-tail recovery",
)
STORE_BYTES_TRUNCATED = Counter(
    "store_bytes_truncated_total",
    "Bytes cut from the log tail by torn-tail recovery",
)
STORE_CRC_FAILURES = Counter(
    "store_crc_failures_total",
    "CRC32-C record mismatches detected (engine replay + offline verify)",
)
SYNC_BATCHES_REQUESTED = Counter(
    "sync_batches_requested_total",
    "BlocksByRange batch requests issued by the sync manager",
)
SYNC_BATCHES_IMPORTED = Counter(
    "sync_batches_imported_total",
    "Batches that validated, bulk-verified, and imported cleanly",
)
SYNC_BATCHES_INVALID = Counter(
    "sync_batches_invalid_total",
    "Batches rejected before import, by validation failure reason",
    ("reason",),
)
SYNC_BATCH_RETRIES = Counter(
    "sync_batch_retries_total",
    "Batch attempts past the first (failed batches re-requested)",
)
SYNC_PEER_ROTATIONS = Counter(
    "sync_peer_rotations_total",
    "Batches moved to a different peer after a failed attempt",
)
SYNC_STALLS = Counter(
    "sync_stalls_total",
    "Times sync parked as STALLED (no viable peer / batch budget exhausted)",
)
SYNC_SEGMENT_SETS_VERIFIED = Counter(
    "sync_segment_signature_sets_verified_total",
    "Signature sets bulk-verified across whole sync segments (one device "
    "batch per accepted range batch)",
)
SYNC_BLOCKS_IMPORTED = Counter(
    "sync_blocks_imported_total",
    "Blocks imported through the sync manager's validated batch path",
)
PEER_PENALTIES = Counter(
    "peer_behaviour_penalties_total",
    "Behaviour penalties applied by the peer manager, by reason",
    ("reason",),
)
PEER_BANS = Counter(
    "peer_bans_total",
    "Peers banned after their score crossed BAN_THRESHOLD",
)
DEPOSIT_QUEUE_DEPTH = Gauge(
    "deposit_queue_depth",
    "Eth1 deposits voted in but not yet drained on-chain "
    "(effective eth1_data.deposit_count - state.eth1_deposit_index) at "
    "the last block production",
)
POOL_ESTIMATED_VERIFY_COST = Gauge(
    "pool_estimated_verify_cost",
    "Estimated marginal batch-verify cost of the naive aggregation pool "
    "(resident signatures across groups — superlinear under "
    "committee-overlap aggregation storms)",
)
SSZ_CACHE_BYTES = Gauge(
    "ssz_cache_bytes",
    "Approximate bytes pinned by the SSZ root/serialize caches and the "
    "active-indices caches (keys + pinned values), budget-evicted",
)
SSZ_CACHE_EVICTIONS = Counter(
    "ssz_cache_evictions_total",
    "SSZ/state cache entries evicted (capacity cap or byte-budget bound)",
)


def render() -> str:
    """Prometheus text exposition of every registered metric."""
    out = []
    with _REG_LOCK:
        metrics = list(_REGISTRY)
    for m in metrics:
        out.append(f"# HELP {m.name} {m.help}")
        out.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            with m._lock:
                for labels, counts in m._counts.items():
                    cum = 0
                    base = m._fmt_labels(labels)[1:-1] if labels else ""
                    for edge, c in zip(m.buckets, counts):
                        cum += c
                        lbl = f'{{le="{edge}"' + (f",{base}" if base else "") + "}"
                        out.append(f"{m.name}_bucket{lbl} {cum}")
                    cum += counts[-1]
                    lbl = '{le="+Inf"' + (f",{base}" if base else "") + "}"
                    out.append(f"{m.name}_bucket{lbl} {cum}")
                    out.append(
                        f"{m.name}_sum{m._fmt_labels(labels)} {m._sums[labels]}"
                    )
                    out.append(
                        f"{m.name}_count{m._fmt_labels(labels)} "
                        f"{int(m._values[labels])}"
                    )
                    # quantile export (p50/p99): summary-style convenience
                    # samples next to the raw buckets, so SLO gates and
                    # dashboards read latency percentiles straight off the
                    # scrape without a histogram_quantile() evaluator
                    for q, suffix in ((0.5, "p50"), (0.99, "p99")):
                        est = m.quantile(q, counts=list(counts))
                        out.append(
                            f"{m.name}_{suffix}{m._fmt_labels(labels)} "
                            f"{est:.6g}"
                        )
        else:
            for labels, v in m.samples():
                out.append(f"{m.name}{m._fmt_labels(labels)} {v}")
    return "\n".join(out) + "\n"


def registry_names() -> list[str]:
    with _REG_LOCK:
        return [m.name for m in _REGISTRY]
