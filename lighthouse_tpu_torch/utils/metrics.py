"""Process-global counters and gauges of the ingest engine.

The port's own copy of the part of the JAX package's ``utils/metrics.py``
that ``lighthouse_tpu_torch.ingest`` reads: the cache counters prove that
repeat signers skip aggregation and limb encode, the rate gauge and the pool
depth say whether the marshal keeps pace with the card, and the fallback
counter counts every degradation of the vectorized marshal.  Each metric is
thread-safe and has ``inc``, ``set`` and ``value()``.
"""

from __future__ import annotations

import threading


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
