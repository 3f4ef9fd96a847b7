"""Storage layer — twin of beacon_node/store (HotColdDB over native KV)."""

from .hot_cold import HotColdDB, Split  # noqa: F401
from .kv import DBColumn, KeyValueStore, MemoryStore, SlabStore  # noqa: F401
from .wal import RecoveryReport, scan_file, verify_file  # noqa: F401
