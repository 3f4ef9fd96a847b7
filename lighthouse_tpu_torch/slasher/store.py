"""Disk-backed chunked slasher surfaces with an LRU of hot chunks.

Twin of slasher/src/array.rs (chunked min/max-target arrays persisted in
MDBX, updated per attestation batch) + slasher/src/database/ (the
pluggable DB interface): surfaces are (chunk_v × chunk_e) int32 tiles
keyed (validator_chunk, epoch_chunk) in a KeyValueStore column — the
same native slabdb engine the beacon store uses stands in for MDBX.
Memory is bounded by ``max_cached`` tiles; dirty tiles write back on
eviction and flush(), so a restarted process resumes exactly where the
last flush left the surfaces.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ..store.kv import DBColumn, KeyValueStore


class ChunkedSurface:
    """One persisted (validators × epochs%H) int32 surface."""

    def __init__(
        self,
        db: KeyValueStore,
        column: DBColumn,
        default: int,
        history_length: int,
        chunk_v: int = 64,
        chunk_e: int = 256,
        max_cached: int = 128,
    ):
        self.db = db
        self.column = column
        self.default = np.int32(default)
        self.H = history_length
        self.chunk_v = chunk_v
        self.chunk_e = chunk_e
        self.max_cached = max_cached
        self._cache: OrderedDict[tuple[int, int], np.ndarray] = OrderedDict()
        self._dirty: set[tuple[int, int]] = set()

    # -- tiles -------------------------------------------------------------

    def _key(self, cv: int, ce: int) -> bytes:
        return cv.to_bytes(4, "big") + ce.to_bytes(4, "big")

    def _tile(self, cv: int, ce: int) -> np.ndarray:
        key = (cv, ce)
        tile = self._cache.get(key)
        if tile is not None:
            self._cache.move_to_end(key)
            return tile
        raw = self.db.get(self.column, self._key(cv, ce))
        if raw is not None:
            tile = np.frombuffer(raw, np.int32).reshape(
                self.chunk_v, self.chunk_e
            ).copy()
        else:
            tile = np.full((self.chunk_v, self.chunk_e), self.default, np.int32)
        self._cache[key] = tile
        self._evict()
        return tile

    def _evict(self) -> None:
        while len(self._cache) > self.max_cached:
            (cv, ce), tile = self._cache.popitem(last=False)
            if (cv, ce) in self._dirty:
                self.db.put(self.column, self._key(cv, ce), tile.tobytes())
                self._dirty.discard((cv, ce))

    def flush(self) -> None:
        """Write every dirty cached tile back (array.rs commit point)."""
        for key in list(self._dirty):
            tile = self._cache.get(key)
            if tile is not None:
                self.db.put(self.column, self._key(*key), tile.tobytes())
        self._dirty.clear()
        self.db.flush()

    @property
    def cached_tiles(self) -> int:
        return len(self._cache)

    # -- reads/updates (epoch values already reduced mod H) ----------------

    def read(self, validators: np.ndarray, epoch_mod: int) -> np.ndarray:
        """surface[vs, e] gather across tiles."""
        out = np.empty(len(validators), np.int32)
        ce, eo = divmod(int(epoch_mod), self.chunk_e)
        for cv in np.unique(validators // self.chunk_v):
            mask = validators // self.chunk_v == cv
            tile = self._tile(int(cv), ce)
            out[mask] = tile[validators[mask] % self.chunk_v, eo]
        return out

    def combine(self, validators: np.ndarray, epochs_mod: np.ndarray,
                value: int, op) -> None:
        """surface[np.ix_(vs, es)] = op(surface[...], value) tile by tile
        (op = np.minimum | np.maximum — the array.rs update sweeps)."""
        if len(epochs_mod) == 0 or len(validators) == 0:
            return
        e_chunks = epochs_mod // self.chunk_e
        for cv in np.unique(validators // self.chunk_v):
            vmask = validators // self.chunk_v == cv
            rows = validators[vmask] % self.chunk_v
            for ce in np.unique(e_chunks):
                emask = e_chunks == ce
                cols = epochs_mod[emask] % self.chunk_e
                tile = self._tile(int(cv), int(ce))
                sub = np.ix_(rows, cols)
                tile[sub] = op(tile[sub], np.int32(value))
                self._dirty.add((int(cv), int(ce)))
