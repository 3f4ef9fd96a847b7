"""Key-value store interfaces + backends (memory, native slabdb).

Twin of beacon_node/store/src/lib.rs: the `KeyValueStore`/`ItemStore` trait
surface (:53,153,318) and `DBColumn` column families (:218).  Two backends,
matching the reference's LevelDB + MemoryStore pair: the C++ slabdb engine
(lighthouse_tpu_torch/native/slabdb.cpp) for disk, a dict for tests.

Crash-safety surface: every SlabStore open yields a
:class:`~.wal.RecoveryReport` describing what replay kept/dropped from a
torn or corrupt tail; `flush` is a real fsync; and the `store.open` /
`store.put` / `store.flush` FaultInjector sites make disk failures and torn
writes deterministically injectable (utils/faults.py `io-error` /
`torn-write` kinds).
"""

from __future__ import annotations

import ctypes
import os
from enum import Enum

from ..utils import faults as _faults
from ..utils.metrics import (
    STORE_BYTES_TRUNCATED,
    STORE_CRC_FAILURES,
    STORE_RECORDS_DROPPED,
    STORE_TORN_TAIL_RECOVERIES,
)
from .wal import TAG_PUT, RecoveryReport, encode_record


class DBColumn(Enum):
    """Column families (store/src/lib.rs:218's DBColumn, the subset the
    implemented layers use)."""

    BEACON_META = b"m"
    BEACON_BLOCK = b"b"
    BEACON_STATE = b"s"
    BEACON_STATE_SUMMARY = b"y"
    BEACON_BLOCK_ROOTS = b"r"
    BEACON_STATE_ROOTS = b"t"
    FORK_CHOICE = b"f"
    OP_POOL = b"o"
    ETH1_CACHE = b"e"
    COLD_BLOCK = b"B"
    COLD_STATE = b"S"
    BEACON_BLOB = b"l"
    # slasher database (the MDBX/LMDB equivalent rides the same engine)
    SLASHER_MIN_TARGETS = b"1"
    SLASHER_MAX_TARGETS = b"2"
    SLASHER_ATTESTATIONS = b"3"
    SLASHER_BLOCKS = b"4"


class KeyValueStore:
    """The KeyValueStore trait (get/put/delete/iterate per column)."""

    def get(self, column: DBColumn, key: bytes) -> bytes | None:
        raise NotImplementedError

    def put(self, column: DBColumn, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, column: DBColumn, key: bytes) -> None:
        raise NotImplementedError

    def keys(self, column: DBColumn) -> list[bytes]:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class MemoryStore(KeyValueStore):
    """Ephemeral store for tests (the reference's MemoryStore)."""

    def __init__(self):
        self._d: dict[bytes, bytes] = {}

    def _k(self, column: DBColumn, key: bytes) -> bytes:
        return column.value + key

    def get(self, column, key):
        return self._d.get(self._k(column, key))

    def put(self, column, key, value):
        self._d[self._k(column, key)] = bytes(value)

    def delete(self, column, key):
        self._d.pop(self._k(column, key), None)

    def keys(self, column):
        p = column.value
        return [k[len(p):] for k in self._d if k.startswith(p)]


class SlabStore(KeyValueStore):
    """Disk store over the native C++ slabdb engine (ctypes ABI).

    Opening replays the CRC32-C-framed log; ``recovery_report`` records
    what a torn/corrupt tail cost (always present; ``.clean`` on a healthy
    open).  A ``torn-write`` fault at ``store.put`` appends a truncated
    frame and leaves the store closed — the process "died" mid-write, and
    only a reopen (which runs recovery) brings the data back.
    """

    def __init__(self, path: str):
        from ..native import load

        _faults.fire("store.open", path)
        lib = load("slabdb")
        lib.slab_open.restype = ctypes.c_void_p
        lib.slab_open.argtypes = [ctypes.c_char_p]
        lib.slab_close.argtypes = [ctypes.c_void_p]
        lib.slab_put.restype = ctypes.c_int
        lib.slab_put.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.c_char_p, ctypes.c_uint32,
        ]
        lib.slab_get.restype = ctypes.c_int64
        lib.slab_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ]
        lib.slab_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.slab_del.restype = ctypes.c_int
        lib.slab_del.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
        lib.slab_count.restype = ctypes.c_uint64
        lib.slab_count.argtypes = [ctypes.c_void_p]
        lib.slab_dead_bytes.restype = ctypes.c_uint64
        lib.slab_dead_bytes.argtypes = [ctypes.c_void_p]
        lib.slab_flush.restype = ctypes.c_int
        lib.slab_flush.argtypes = [ctypes.c_void_p]
        lib.slab_compact.restype = ctypes.c_int
        lib.slab_compact.argtypes = [ctypes.c_void_p]
        lib.slab_iter_prefix.restype = ctypes.c_int64
        lib.slab_iter_prefix.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        for fn in ("slab_recovery_kept", "slab_recovery_dropped",
                   "slab_recovery_truncated"):
            getattr(lib, fn).restype = ctypes.c_uint64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.slab_recovery_flags.restype = ctypes.c_int
        lib.slab_recovery_flags.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._path = path
        self._h = lib.slab_open(path.encode())
        if not self._h:
            raise IOError(f"slabdb failed to open {path}")
        flags = lib.slab_recovery_flags(self._h)
        self.recovery_report = RecoveryReport(
            records_kept=lib.slab_recovery_kept(self._h),
            records_dropped=lib.slab_recovery_dropped(self._h),
            bytes_truncated=lib.slab_recovery_truncated(self._h),
            tail_torn=bool(flags & 1),
            migrated=bool(flags & 2),
            crc_mismatch=bool(flags & 4),
        )
        if self.recovery_report.tail_torn:
            STORE_TORN_TAIL_RECOVERIES.inc()
            STORE_RECORDS_DROPPED.inc(self.recovery_report.records_dropped)
            STORE_BYTES_TRUNCATED.inc(self.recovery_report.bytes_truncated)
        if self.recovery_report.crc_mismatch:
            STORE_CRC_FAILURES.inc()

    def _k(self, column: DBColumn, key: bytes) -> bytes:
        return column.value + key

    def _handle(self):
        if not self._h:
            raise IOError("SlabStore is closed")
        return self._h

    def get(self, column, key):
        k = self._k(column, key)
        out = ctypes.POINTER(ctypes.c_uint8)()
        n = self._lib.slab_get(self._handle(), k, len(k), ctypes.byref(out))
        if n < 0:
            return None
        try:
            return ctypes.string_at(out, n)
        finally:
            self._lib.slab_free(out)

    def put(self, column, key, value):
        k = self._k(column, key)
        v = bytes(value)
        try:
            _faults.fire("store.put", (column, key))
        except _faults.TornWrite as tw:
            self._tear(k, v, tw.fraction)
            raise _faults.StorageFault(
                f"injected torn write: crashed mid-append of a "
                f"{len(v)}-byte value"
            ) from tw
        if self._lib.slab_put(self._handle(), k, len(k), v, len(v)) != 0:
            raise IOError("slabdb put failed")

    def _tear(self, k: bytes, v: bytes, fraction: float) -> None:
        """Simulate a SIGKILL mid-``fwrite``: flush and abandon the engine
        handle (the 'crashed' process held it), then append only a prefix
        of the framed record.  The store is unusable afterwards; a reopen
        runs torn-tail recovery."""
        h, self._h = self._h, None
        self._lib.slab_close(h)
        frame = encode_record(TAG_PUT, k, v)
        keep = min(len(frame) - 1, max(1, int(len(frame) * fraction)))
        with open(self._path, "ab") as f:
            f.write(frame[:keep])
            f.flush()
            os.fsync(f.fileno())

    def delete(self, column, key):
        k = self._k(column, key)
        if self._lib.slab_del(self._handle(), k, len(k)) != 0:
            raise IOError("slabdb delete failed")

    def keys(self, column):
        p = column.value
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_uint64()
        n = self._lib.slab_iter_prefix(
            self._handle(), p, len(p), ctypes.byref(out), ctypes.byref(out_len)
        )
        try:
            raw = ctypes.string_at(out, out_len.value)
        finally:
            self._lib.slab_free(out)
        keys, pos = [], 0
        for _ in range(n):
            klen = int.from_bytes(raw[pos : pos + 4], "little")
            keys.append(raw[pos + 4 + len(p) : pos + 4 + klen])
            pos += 4 + klen
        return keys

    def __len__(self):
        return self._lib.slab_count(self._handle())

    def dead_bytes(self) -> int:
        return self._lib.slab_dead_bytes(self._handle())

    def compact(self) -> None:
        if self._lib.slab_compact(self._handle()) != 0:
            raise IOError("slabdb compact failed")

    def flush(self):
        _faults.fire("store.flush", self._path)
        if self._lib.slab_flush(self._handle()) != 0:
            raise IOError("slabdb flush (fsync) failed")

    def close(self):
        if self._h:
            self._lib.slab_close(self._h)
            self._h = None
