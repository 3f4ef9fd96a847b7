"""Pubkey limb cache with a card-resident registry: repeat signers skip marshal work.

Port of the JAX package's ``ingest/cache.py``.  Every attestation epoch
re-signs with the same ~1M registry keys, so the marshal keeps paying two
per-set costs that depend only on the signer set: host aggregation (one
Jacobian add per signer in bigint Python) and the aggregate's Montgomery
limb encode.  This cache pays each once:

* **registry tier**: validator index -> canonical Montgomery limb columns of
  that validator's G1 pubkey, append-only (an index's key never changes),
  synced from a ``ValidatorPubkeyCache``-like registry (``len`` and
  ``get(i)``) and mirrored to the card, so a batch whose sets all resolve to
  registry slots gathers its pubkey operand there with one ``index_select``:
  no host limb work and no host-to-device copy of the pubkey operand.  The
  columns are int32 (26, n) planes, exactly ``fp.encode_mont``'s output.
  At mainnet's ~1M keys the mirror holds 2 x 26 x 4 B x n = 208 MiB.
* **LRU tier**: a bounded map from a signer-set identity to the aggregated
  pubkey's limb columns: committees and off-registry keys hit here and skip
  re-aggregation.  Cleared at every epoch boundary (``begin_epoch``) and
  bounded, oldest evicted first.

Identity is by object (``id``): the cache holds a reference to every keyed
object, so an id cannot be recycled while its entry lives.  Equal but
distinct key objects miss and repopulate; correctness never depends on a
hit.

A mesh (parallel/mesh.py) gets its own mirror, split on the validator axis
(``registry_device_sharded``): each seat holds a contiguous shard of its own,
so per-seat bytes shrink with the mesh's width; the sharded program gathers
from it (parallel/partition.py).

Thread-safe: one lock, taken once per batch-level call.  The mirror is
replaced on growth, never written into, so a gather in flight keeps
reading the mirror it was launched on.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from ..crypto.bls.torch_backend import fp as F
from ..utils import metrics as M

DEFAULT_LRU_CAPACITY = 8192


class PubkeyLimbCache:
    """Aggregate-pubkey limb columns keyed by validator index (registry
    tier) or signer-set identity (LRU tier); the registry mirrored on
    ``device``.  See the module docstring."""

    def __init__(self, lru_capacity: int = DEFAULT_LRU_CAPACITY, device="cuda"):
        self.device = torch.device(device)
        self._lock = threading.Lock()
        # registry tier: (N, n) canonical Montgomery limb columns
        self._reg_x = np.zeros((F.N, 0), dtype=np.int32)
        self._reg_y = np.zeros((F.N, 0), dtype=np.int32)
        self._reg_keys: list = []  # slot -> PublicKey (the id's anchor)
        self._slot_by_id: dict[int, int] = {}
        # LRU tier: signer-set identity -> (keys, x_col, y_col)
        self.lru_capacity = max(1, int(lru_capacity))
        self._lru: OrderedDict = OrderedDict()
        self._epoch: int | None = None
        self._dev = None  # the registry's mirror on the device, made lazily
        self._dev_sharded: dict = {}  # mesh -> its validator-axis-sharded mirror

    # -- registry tier -----------------------------------------------------

    def sync_registry(self, pubkey_cache) -> int:
        """Pull validators ``[len(self), len(pubkey_cache))`` from the
        registry, limb-encoding the new keys in one vectorized batch.
        Returns the number of keys added."""
        with self._lock:
            start = len(self._reg_keys)
            end = len(pubkey_cache)
            if end <= start:
                return 0
            new = [pubkey_cache.get(i) for i in range(start, end)]
            xs = F.encode_mont([pk.point[0].v for pk in new])
            ys = F.encode_mont([pk.point[1].v for pk in new])
            self._reg_x = np.hstack([self._reg_x, xs])
            self._reg_y = np.hstack([self._reg_y, ys])
            for off, pk in enumerate(new):
                self._slot_by_id[id(pk)] = start + off
            self._reg_keys.extend(new)
            self._dev = None  # the mirrors are stale
            self._dev_sharded.clear()
            M.INGEST_CACHE_KEYS.set(len(self._reg_keys) + len(self._lru))
            return end - start

    def registry_size(self) -> int:
        with self._lock:
            return len(self._reg_keys)

    def registry_device(self) -> tuple:
        """The mirror on ``self.device``: (x, y) int32 (N, n) tensors, uploaded
        through ``fp.upload`` at the first call after growth (so never inside
        a CUDA graph capture, where ``upload`` raises).  Growth replaces the
        mirror; it is never written into."""
        with self._lock:
            if self._dev is None:
                self._dev = (F.upload(torch.from_numpy(self._reg_x), self.device),
                             F.upload(torch.from_numpy(self._reg_y), self.device))
            return self._dev

    def registry_device_sharded(self, mesh) -> tuple:
        """The mirror partitioned over ``mesh``: (x, y), each a tuple of the
        seats' (N, n_padded / width) int32 shards, seat i holding validators
        ``[i * n_local, (i + 1) * n_local)``.  The validator axis is padded
        with zero columns to a multiple of the width (no slot points
        there).  Each shard is its own tensor on its seat, uploaded through
        ``fp.upload`` (never inside a capture), so a seat holds 1 / width of
        the registry.  Cached per mesh; dropped on growth, as the mirror
        is."""
        with self._lock:
            cached = self._dev_sharded.get(mesh)
            if cached is None:
                width = len(mesh.seats)
                n = self._reg_x.shape[1]
                n_local = (n + width - 1) // width
                pad = n_local * width - n
                rx, ry = self._reg_x, self._reg_y
                if pad:
                    z = np.zeros((rx.shape[0], pad), dtype=rx.dtype)
                    rx, ry = np.hstack([rx, z]), np.hstack([ry, z])
                xs, ys = [], []
                for i, seat in enumerate(mesh.seats):
                    cols = slice(i * n_local, (i + 1) * n_local)
                    xs.append(F.upload(torch.from_numpy(np.ascontiguousarray(rx[:, cols])), seat))
                    ys.append(F.upload(torch.from_numpy(np.ascontiguousarray(ry[:, cols])), seat))
                cached = (tuple(xs), tuple(ys))
                self._dev_sharded[mesh] = cached
            return cached

    def device_bytes(self) -> int:
        """Bytes the mirror takes (or will take) on the device."""
        with self._lock:
            return self._reg_x.nbytes + self._reg_y.nbytes

    def gather_device(self, slots) -> tuple:
        """Gather of registry columns by validator slot on the device:
        ``slots`` (B,) int -> ((N, B), (N, B)) int32 tensors, enqueued on the
        current stream.  The slots are uploaded as int64 or int32, as given."""
        dev_x, dev_y = self.registry_device()
        idx = np.asarray(slots)
        if idx.dtype not in (np.int32, np.int64):
            idx = idx.astype(np.int64)
        idx = F.upload(torch.from_numpy(np.ascontiguousarray(idx)), self.device)
        return dev_x.index_select(1, idx), dev_y.index_select(1, idx)

    # -- epoch lifecycle ---------------------------------------------------

    def begin_epoch(self, epoch: int) -> None:
        """Epoch-boundary invalidation: the aggregate LRU is cleared (committee
        aggregates are an epoch's working set); the registry tier survives."""
        with self._lock:
            if self._epoch == epoch:
                return
            dropped = len(self._lru)
            self._lru.clear()
            self._epoch = epoch
            if dropped:
                M.INGEST_CACHE_EVICTIONS.inc(dropped)
            M.INGEST_CACHE_KEYS.set(len(self._reg_keys) + len(self._lru))

    @property
    def epoch(self):
        return self._epoch

    # -- batch resolve / insert (the marshal-time API) ---------------------

    @staticmethod
    def _set_key(signing_keys) -> tuple:
        return tuple(map(id, signing_keys))

    def resolve_batch(self, sets):
        """One-lock lookup for a whole batch.  Returns ``(slots, cols,
        missing)``: ``slots[i]`` the registry slot of a single-signer
        registry hit, else -1; ``cols[i]`` (x_col, y_col) of an LRU hit;
        ``missing`` the set indices to aggregate and encode (then handed
        back through ``insert_aggregates``)."""
        slots = np.full(len(sets), -1, dtype=np.int64)
        cols: dict[int, tuple] = {}
        missing: list[int] = []
        hits = misses = 0
        with self._lock:
            for i, s in enumerate(sets):
                keys = s.signing_keys
                if len(keys) == 1:
                    slot = self._slot_by_id.get(id(keys[0]), -1)
                    if slot >= 0:
                        slots[i] = slot
                        hits += 1
                        continue
                key = self._set_key(keys)
                entry = self._lru.get(key)
                if entry is not None:
                    self._lru.move_to_end(key)
                    cols[i] = (entry[1], entry[2])
                    hits += 1
                else:
                    missing.append(i)
                    misses += 1
        if hits:
            M.INGEST_CACHE_HITS.inc(hits)
        if misses:
            M.INGEST_CACHE_MISSES.inc(misses)
        return slots, cols, missing

    def insert_aggregates(self, entries) -> None:
        """Admit freshly aggregated and encoded signer sets, ``entries`` =
        [(signing_keys, x_col, y_col)]; past ``lru_capacity`` the oldest
        entries are evicted."""
        evicted = 0
        with self._lock:
            for keys, x_col, y_col in entries:
                # hold the key objects: an id cannot be recycled while cached
                self._lru[self._set_key(keys)] = (tuple(keys), x_col, y_col)
            while len(self._lru) > self.lru_capacity:
                self._lru.popitem(last=False)
                evicted += 1
            M.INGEST_CACHE_KEYS.set(len(self._reg_keys) + len(self._lru))
        if evicted:
            M.INGEST_CACHE_EVICTIONS.inc(evicted)

    def lru_size(self) -> int:
        with self._lock:
            return len(self._lru)

    def registry_columns(self, slots) -> tuple:
        """Host gather: (N, B) int32 x and y columns of registry ``slots``."""
        with self._lock:
            return (np.take(self._reg_x, slots, axis=1),
                    np.take(self._reg_y, slots, axis=1))
