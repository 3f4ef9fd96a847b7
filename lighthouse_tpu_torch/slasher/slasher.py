"""Slashing detection over chunked, disk-backed per-validator surfaces.

Twin of slasher/src (Slasher::process_queued :79, process_batch :204,
min/max-target chunked arrays array.rs, attestation/block queues, the
database/ backend split).  The two surround-detection surfaces are
chunked int32 tiles persisted through a KeyValueStore (slasher/store.py —
the MDBX/LMDB equivalent on the native slabdb engine), with an LRU of hot
tiles bounding memory:

* ``min_targets[v, e]`` — the minimum attestation target seen for source
  epochs  > e  (detects "new attestation is surrounded by an old one")
* ``max_targets[v, e]`` — the maximum target seen for source epochs < e
  (detects "new attestation surrounds an old one")

Double proposals/votes are exact-match lookups persisted in their own
columns, so a restarted slasher resumes with full history (the reference
re-opens its MDBX environment the same way).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..consensus.containers import (
    AttesterSlashing,
    IndexedAttestation,
    ProposerSlashing,
    SignedBeaconBlockHeader,
)
from ..store.kv import DBColumn, KeyValueStore, MemoryStore
from .store import ChunkedSurface

_INT32_MAX = np.iinfo(np.int32).max


@dataclass
class SlasherConfig:
    history_length: int = 4096  # epochs of lookback (the reference default)
    chunk_size: int = 256  # epochs per tile (array.rs chunk_size)
    validator_chunk_size: int = 64  # validators per tile
    max_cached_tiles: int = 128  # LRU bound: tiles held in memory


class Slasher:
    def __init__(self, config: SlasherConfig | None = None,
                 db: KeyValueStore | None = None):
        """``db=None`` → ephemeral MemoryStore; pass a SlabStore for the
        disk-backed, restart-surviving configuration."""
        self.config = config or SlasherConfig()
        self.db = db if db is not None else MemoryStore()
        c = self.config
        self.min_targets = ChunkedSurface(
            self.db, DBColumn.SLASHER_MIN_TARGETS, _INT32_MAX,
            c.history_length, c.validator_chunk_size, c.chunk_size,
            c.max_cached_tiles,
        )
        self.max_targets = ChunkedSurface(
            self.db, DBColumn.SLASHER_MAX_TARGETS, 0,
            c.history_length, c.validator_chunk_size, c.chunk_size,
            c.max_cached_tiles,
        )
        self.attestation_queue: list[IndexedAttestation] = []
        self.block_queue: list[SignedBeaconBlockHeader] = []
        self.found_attester_slashings: list[AttesterSlashing] = []
        self.found_proposer_slashings: list[ProposerSlashing] = []

    # ------------------------------------------------------------- intake

    def accept_attestation(self, indexed: IndexedAttestation) -> None:
        self.attestation_queue.append(indexed)

    def accept_block_header(self, header: SignedBeaconBlockHeader) -> None:
        self.block_queue.append(header)

    # -------------------------------------------------- persisted records

    @staticmethod
    def _att_key(v: int, tgt: int) -> bytes:
        return v.to_bytes(8, "big") + tgt.to_bytes(8, "big")

    def _get_attestation(self, v: int, tgt: int) -> IndexedAttestation | None:
        raw = self.db.get(DBColumn.SLASHER_ATTESTATIONS, self._att_key(v, tgt))
        return IndexedAttestation.deserialize_value(raw) if raw else None

    def _put_attestation(self, v: int, tgt: int, att) -> None:
        self.db.put(
            DBColumn.SLASHER_ATTESTATIONS, self._att_key(v, tgt), att.encode()
        )

    def _attestations_of(self, v: int):
        prefix = v.to_bytes(8, "big")
        for key in self.db.keys(DBColumn.SLASHER_ATTESTATIONS):
            if key[:8] == prefix:
                raw = self.db.get(DBColumn.SLASHER_ATTESTATIONS, key)
                if raw:
                    yield IndexedAttestation.deserialize_value(raw)

    # ------------------------------------------------------------ process

    def process_queued(self, current_epoch: int) -> tuple[list, list]:
        """Slasher::process_queued: drain both queues, detect, persist the
        surface updates (flush = the reference's MDBX commit), return the
        (attester, proposer) slashings found this pass."""
        att_found: list[AttesterSlashing] = []
        for indexed in self.attestation_queue:
            att_found.extend(self._process_attestation(indexed))
        self.attestation_queue.clear()
        prop_found: list[ProposerSlashing] = []
        for header in self.block_queue:
            ps = self._process_block_header(header)
            if ps is not None:
                prop_found.append(ps)
        self.block_queue.clear()
        self.min_targets.flush()
        self.max_targets.flush()
        self.found_attester_slashings.extend(att_found)
        self.found_proposer_slashings.extend(prop_found)
        return att_found, prop_found

    # ------------------------------------------------- attestation checks

    def _process_attestation(self, indexed) -> list[AttesterSlashing]:
        H = self.config.history_length
        src = int(indexed.data.source.epoch)
        tgt = int(indexed.data.target.epoch)
        validators = [int(v) for v in indexed.attesting_indices]
        if not validators:
            return []
        out = []
        vs = np.array(validators)
        # --- double vote: same target, different data -------------------
        for v in validators:
            prior = self._get_attestation(v, tgt)
            if prior is not None and prior.data.root() != indexed.data.root():
                out.append(
                    AttesterSlashing(attestation_1=prior, attestation_2=indexed)
                )
            else:
                self._put_attestation(v, tgt, indexed)
        # --- surround checks against the chunked surfaces ---------------
        # min_targets[v, src] = min target over priors with source > src:
        # if it is < tgt, the NEW attestation surrounds that prior.
        does_surround = self.min_targets.read(vs, src % H) < tgt
        for i, v in enumerate(validators):
            if does_surround[i]:
                prior = self._find_surround_witness(v, src, tgt, surrounding=True)
                if prior is not None:
                    out.append(
                        AttesterSlashing(
                            attestation_1=prior, attestation_2=indexed
                        )
                    )
        # max_targets[v, src] = max target over priors with source < src:
        # if it is > tgt, a prior attestation surrounds the NEW one.
        is_surrounded = self.max_targets.read(vs, src % H) > tgt
        for i, v in enumerate(validators):
            if is_surrounded[i]:
                prior = self._find_surround_witness(v, src, tgt, surrounding=False)
                if prior is not None:
                    out.append(
                        AttesterSlashing(
                            attestation_1=prior, attestation_2=indexed
                        )
                    )
        # --- update the surfaces (array.rs sweeps, tile-wise) -----------
        #   min_targets[v, e] = min target over atts with source > e
        #   max_targets[v, e] = max target over atts with source < e
        lo = np.arange(0, src)  # epochs below src: this att has source > e
        self.min_targets.combine(vs, lo % H, tgt, np.minimum)
        hi = np.arange(src + 1, min(tgt, src + H) + 1)
        self.max_targets.combine(vs, hi % H, tgt, np.maximum)
        return out

    def _find_surround_witness(self, v, src, tgt, surrounding: bool):
        """Locate a concrete prior attestation forming the slashing pair
        (the reference re-reads its database the same way)."""
        for att in self._attestations_of(v):
            s2, t2 = int(att.data.source.epoch), int(att.data.target.epoch)
            if surrounding and src < s2 and t2 < tgt:
                return att  # the new (src, tgt) surrounds this prior
            if not surrounding and s2 < src and tgt < t2:
                return att  # this prior surrounds the new (src, tgt)
        return None

    # ------------------------------------------------------ block checks

    def _process_block_header(self, signed_header):
        h = signed_header.message
        key = int(h.proposer_index).to_bytes(8, "big") + int(h.slot).to_bytes(
            8, "big"
        )
        raw = self.db.get(DBColumn.SLASHER_BLOCKS, key)
        prior = SignedBeaconBlockHeader.deserialize_value(raw) if raw else None
        if prior is not None and prior.message.root() != h.root():
            return ProposerSlashing(
                signed_header_1=prior, signed_header_2=signed_header
            )
        self.db.put(DBColumn.SLASHER_BLOCKS, key, signed_header.encode())
        return None

    # ------------------------------------------------------------- prune

    def prune(self, finalized_epoch: int) -> None:
        """Drop attestation records at/below finalization (the surfaces
        wrap mod H and overwrite themselves)."""
        for key in list(self.db.keys(DBColumn.SLASHER_ATTESTATIONS)):
            tgt = int.from_bytes(key[8:], "big")
            if tgt <= finalized_epoch:
                self.db.delete(DBColumn.SLASHER_ATTESTATIONS, key)
