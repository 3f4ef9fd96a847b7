"""HotColdDB: the hot/cold split beacon database.

Twin of beacon_node/store/src/hot_cold_store.rs:43-50: recent (hot) blocks
and full states live ahead of the finalized split; at finalization, blocks
and periodic restore-point states migrate to the cold section and
intermediate hot states are dropped (reconstructable by replay — the
BlockReplayer pattern of store/src/reconstruct.rs).  Schema versioning in
the metadata column mirrors store/src/metadata.rs.
"""

from __future__ import annotations

from dataclasses import dataclass

from .kv import DBColumn, KeyValueStore, MemoryStore

SCHEMA_VERSION = 2
SPLIT_KEY = b"split"
SCHEMA_KEY = b"schema"


def _migrate_v1_to_v2(db: KeyValueStore) -> None:
    """v2 adds the slot → block-root forward index (forwards_iter.rs's
    chain-spine column): backfill it from every stored block."""
    for col in (DBColumn.BEACON_BLOCK, DBColumn.COLD_BLOCK):
        for root in db.keys(col):
            raw = db.get(col, root)
            slot = HotColdDB._block_slot(raw) if raw else None
            if slot is not None:
                db.put(
                    DBColumn.BEACON_BLOCK_ROOTS, slot.to_bytes(8, "big"), root
                )


# schema upgrade registry (store/src/metadata.rs SchemaVersion +
# beacon_chain/src/schema_change* walked by database_manager)
_MIGRATIONS = {1: _migrate_v1_to_v2}


@dataclass
class Split:
    """The hot/cold boundary (finalized slot + state root)."""

    slot: int
    state_root: bytes

    def encode(self) -> bytes:
        return self.slot.to_bytes(8, "little") + self.state_root

    @classmethod
    def decode(cls, data: bytes) -> "Split":
        return cls(int.from_bytes(data[:8], "little"), data[8:40])


class HotColdDB:
    def __init__(
        self,
        store: KeyValueStore | None = None,
        types_family=None,
        slots_per_restore_point: int = 32,
    ):
        self.db = store if store is not None else MemoryStore()
        self.types = types_family
        self.slots_per_restore_point = slots_per_restore_point
        # a store that truncated a torn tail on open may have lost the
        # suffix of the log: re-anchor the head indexes to what survived
        # BEFORE anything reads them (the open-after-SIGKILL contract)
        report = getattr(self.db, "recovery_report", None)
        self.last_recovery = report
        if report is not None and not report.clean:
            self.re_anchor()
        raw = self.db.get(DBColumn.BEACON_META, SCHEMA_KEY)
        if raw is None:
            self.db.put(
                DBColumn.BEACON_META, SCHEMA_KEY,
                SCHEMA_VERSION.to_bytes(4, "little"),
            )
        else:
            found = int.from_bytes(raw, "little")
            if found > SCHEMA_VERSION:
                raise IOError(
                    f"database schema v{found} is NEWER than this build's "
                    f"v{SCHEMA_VERSION}; refusing to downgrade"
                )
            while found < SCHEMA_VERSION:
                migration = _MIGRATIONS.get(found)
                if migration is None:
                    raise IOError(f"no migration path from schema v{found}")
                migration(self.db)
                found += 1
                self.db.put(
                    DBColumn.BEACON_META, SCHEMA_KEY,
                    found.to_bytes(4, "little"),
                )
            self.db.flush()

    # ------------------------------------------------------------- split

    @property
    def split(self) -> Split:
        raw = self.db.get(DBColumn.BEACON_META, SPLIT_KEY)
        return Split.decode(raw) if raw else Split(0, bytes(32))

    # ---------------------------------------------------- crash recovery

    def re_anchor(self) -> dict:
        """Restore block/index consistency after torn-tail recovery.

        Truncation drops a *suffix* of the log, so two shapes of damage are
        possible: a slot→root index entry whose block record was cut (the
        entry itself survived an earlier record), or a block whose index
        entry was cut (put_block writes block first, index second).  Drop
        the former, backfill the latter, and report the resulting head —
        the highest indexed slot whose block actually loads.
        """
        dropped = backfilled = 0
        for slot_key in list(self.db.keys(DBColumn.BEACON_BLOCK_ROOTS)):
            root = self.db.get(DBColumn.BEACON_BLOCK_ROOTS, slot_key)
            if root is not None and not self.block_exists(root):
                self.db.delete(DBColumn.BEACON_BLOCK_ROOTS, slot_key)
                dropped += 1
        for col in (DBColumn.BEACON_BLOCK, DBColumn.COLD_BLOCK):
            for root in self.db.keys(col):
                raw = self.db.get(col, root)
                slot = self._block_slot(raw) if raw else None
                if slot is None:
                    continue
                key = slot.to_bytes(8, "big")
                if self.db.get(DBColumn.BEACON_BLOCK_ROOTS, key) is None:
                    self.db.put(DBColumn.BEACON_BLOCK_ROOTS, key, root)
                    backfilled += 1
        head_slot, head_root = 0, None
        for slot_key in self.db.keys(DBColumn.BEACON_BLOCK_ROOTS):
            slot = int.from_bytes(slot_key, "big")
            if slot >= head_slot:
                head_slot = slot
                head_root = self.db.get(DBColumn.BEACON_BLOCK_ROOTS, slot_key)
        self.db.flush()
        return {
            "head_slot": head_slot,
            "head_root": head_root,
            "index_dropped": dropped,
            "index_backfilled": backfilled,
        }

    # ------------------------------------------------------------- blocks

    def put_block(self, block_root: bytes, signed_block) -> None:
        raw = signed_block.encode()
        self.db.put(DBColumn.BEACON_BLOCK, block_root, raw)
        # slot → root forward index (last writer wins: the caller imports
        # in fork-choice order, so the canonical chain overwrites forks)
        self.db.put(
            DBColumn.BEACON_BLOCK_ROOTS,
            int(signed_block.message.slot).to_bytes(8, "big"),
            block_root,
        )

    def get_block(self, block_root: bytes, block_cls=None):
        for col in (DBColumn.BEACON_BLOCK, DBColumn.COLD_BLOCK):
            raw = self.db.get(col, block_root)
            if raw is not None:
                cls = block_cls or (self.types and self.types.SignedBeaconBlock)
                return cls.deserialize_value(raw) if cls else raw
        return None

    def block_exists(self, block_root: bytes) -> bool:
        return any(
            self.db.get(c, block_root) is not None
            for c in (DBColumn.BEACON_BLOCK, DBColumn.COLD_BLOCK)
        )

    # ------------------------------------------------------------- blobs

    def put_blob(self, block_root: bytes, index: int, sidecar) -> None:
        """Blob sidecars keyed (block_root, index) — store/src's blobs
        column (DBColumn::BeaconBlob)."""
        self.db.put(
            DBColumn.BEACON_BLOB, block_root + bytes([index]), sidecar.encode()
        )

    def get_blobs(self, block_root: bytes, max_blobs: int = 16) -> list:
        out = []
        for i in range(max_blobs):
            raw = self.db.get(DBColumn.BEACON_BLOB, block_root + bytes([i]))
            if raw is None:
                break
            cls = self.types and self.types.BlobSidecar
            out.append(cls.deserialize_value(raw) if cls else raw)
        return out

    # ------------------------------------------------------------- states

    def put_state(self, state_root: bytes, state) -> None:
        self.db.put(DBColumn.BEACON_STATE, state_root, state.encode())
        self.db.put(
            DBColumn.BEACON_STATE_SUMMARY,
            state_root,
            int(state.slot).to_bytes(8, "little"),
        )

    def get_state(self, state_root: bytes, state_cls=None):
        for col in (DBColumn.BEACON_STATE, DBColumn.COLD_STATE):
            raw = self.db.get(col, state_root)
            if raw is not None:
                cls = state_cls or (self.types and self.types.BeaconState)
                return cls.deserialize_value(raw) if cls else raw
        return None

    def state_slot(self, state_root: bytes) -> int | None:
        raw = self.db.get(DBColumn.BEACON_STATE_SUMMARY, state_root)
        return int.from_bytes(raw, "little") if raw else None

    # ------------------------------------------------------- finalization

    def migrate_to_cold(
        self, finalized_slot: int, finalized_state_root: bytes,
        keep_block_roots: set[bytes] | None = None,
    ) -> dict:
        """Advance the split (hot_cold_store freezer migration): move
        finalized blocks cold, keep restore-point states, drop intermediate
        hot states (replayable).  `keep_block_roots`: canonical-chain roots
        to migrate; others (pruned forks) are deleted."""
        stats = {"blocks_cold": 0, "blocks_pruned": 0, "states_dropped": 0,
                 "states_kept": 0}
        for root in list(self.db.keys(DBColumn.BEACON_BLOCK)):
            raw = self.db.get(DBColumn.BEACON_BLOCK, root)
            slot = self._block_slot(raw)
            if slot is None or slot > finalized_slot:
                continue
            if keep_block_roots is None or root in keep_block_roots:
                self.db.put(DBColumn.COLD_BLOCK, root, raw)
                stats["blocks_cold"] += 1
            else:
                stats["blocks_pruned"] += 1
            self.db.delete(DBColumn.BEACON_BLOCK, root)
        for root in list(self.db.keys(DBColumn.BEACON_STATE)):
            slot = self.state_slot(root)
            if slot is None or slot > finalized_slot:
                continue
            raw = self.db.get(DBColumn.BEACON_STATE, root)
            if slot % self.slots_per_restore_point == 0 or root == finalized_state_root:
                # restore point: keep the state AND its slot summary so
                # replay can locate the nearest restore point by slot
                self.db.put(DBColumn.COLD_STATE, root, raw)
                stats["states_kept"] += 1
            else:
                stats["states_dropped"] += 1
                self.db.delete(DBColumn.BEACON_STATE_SUMMARY, root)
            self.db.delete(DBColumn.BEACON_STATE, root)
        self.db.put(
            DBColumn.BEACON_META, SPLIT_KEY,
            Split(finalized_slot, finalized_state_root).encode(),
        )
        self.db.flush()
        return stats

    @staticmethod
    def _block_slot(signed_block_bytes: bytes) -> int | None:
        # SignedBeaconBlock = 4-byte offset to message | signature(96) |
        # message{slot u64 at its head}
        if len(signed_block_bytes) < 108:
            return None
        return int.from_bytes(signed_block_bytes[100:108], "little")

    # ------------------------------------------------------- iteration/GC

    def forwards_block_roots_iterator(self, start_slot: int, end_slot: int):
        """(slot, block_root) ascending over the canonical spine
        (store/src/forwards_iter.rs): slots without a block are skipped
        (empty slots have no root of their own)."""
        for slot in range(start_slot, end_slot + 1):
            root = self.db.get(
                DBColumn.BEACON_BLOCK_ROOTS, slot.to_bytes(8, "big")
            )
            if root is not None:
                yield slot, root

    def garbage_collect(self, keep_state_roots: set[bytes]) -> dict:
        """Drop abandoned hot states (pruned forks that never finalized —
        store/src/garbage_collection.rs): anything hot, at/below the
        split, and not in ``keep_state_roots``."""
        split_slot = self.split.slot
        dropped = 0
        for root in list(self.db.keys(DBColumn.BEACON_STATE)):
            slot = self.state_slot(root)
            if slot is None or slot > split_slot:
                continue
            if root in keep_state_roots:
                continue
            self.db.delete(DBColumn.BEACON_STATE, root)
            self.db.delete(DBColumn.BEACON_STATE_SUMMARY, root)
            dropped += 1
        self.db.flush()
        return {"states_dropped": dropped}

    # ------------------------------------------------------------- misc

    def put_item(self, column: DBColumn, key: bytes, value: bytes) -> None:
        self.db.put(column, key, value)

    def get_item(self, column: DBColumn, key: bytes) -> bytes | None:
        return self.db.get(column, key)

    def flush(self):
        """Durability point: on a SlabStore backend this is a real fsync."""
        self.db.flush()

    def close(self):
        self.db.close()
