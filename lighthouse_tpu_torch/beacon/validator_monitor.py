"""Per-validator performance monitoring + block latency attribution.

Twin of beacon_node/beacon_chain/src/validator_monitor.rs (2,124 LoC —
tracks registered validators' attestation inclusion, proposals, sync
participation, with per-epoch summaries) and block_times_cache.rs (221 LoC
— observed/imported/head timestamps per block root, the latency
attribution the `head` SSE event and delay metrics feed on).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field

from ..utils import Counter, get_logger

log = get_logger("validator_monitor")

MONITORED_ATTESTATIONS = Counter(
    "validator_monitor_attestations_total",
    "Attestations by monitored validators seen in blocks",
)
MONITORED_PROPOSALS = Counter(
    "validator_monitor_blocks_total", "Blocks proposed by monitored validators"
)


# ---------------------------------------------------------------------------
# Block times (block_times_cache.rs)
# ---------------------------------------------------------------------------


@dataclass
class BlockTimes:
    slot: int = 0
    observed: float | None = None  # first seen (gossip decode)
    imported: float | None = None  # import_block completed
    became_head: float | None = None  # head recompute picked it


class BlockTimesCache:
    """Bounded per-root timestamp triples; deltas are the pipeline's
    latency attribution (observed→imported = verification+execution,
    imported→head = fork-choice scheduling)."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._d: OrderedDict[bytes, BlockTimes] = OrderedDict()

    def _entry(self, root: bytes, slot: int | None = None) -> BlockTimes:
        e = self._d.get(root)
        if e is None:
            e = BlockTimes(slot=slot or 0)
            self._d[root] = e
            if len(self._d) > self.capacity:
                self._d.popitem(last=False)
        return e

    def observe(self, root: bytes, slot: int) -> None:
        e = self._entry(root, slot)
        if e.observed is None:
            e.observed = time.monotonic()

    def imported(self, root: bytes, slot: int) -> None:
        e = self._entry(root, slot)
        if e.imported is None:
            e.imported = time.monotonic()

    def set_head(self, root: bytes) -> None:
        e = self._d.get(root)
        if e is not None and e.became_head is None:
            e.became_head = time.monotonic()

    def attribution(self, root: bytes) -> dict | None:
        e = self._d.get(root)
        if e is None:
            return None
        out = {"slot": e.slot}
        if e.observed is not None and e.imported is not None:
            out["observed_to_imported"] = e.imported - e.observed
        if e.imported is not None and e.became_head is not None:
            out["imported_to_head"] = e.became_head - e.imported
        return out


# ---------------------------------------------------------------------------
# Validator monitor (validator_monitor.rs)
# ---------------------------------------------------------------------------


@dataclass
class MonitoredValidator:
    index: int
    blocks_proposed: int = 0
    blocks_missed: int = 0
    attestations_included: int = 0
    attestations_seen_gossip: int = 0
    inclusion_delay_sum: int = 0
    last_attested_epoch: int = -1
    sync_signatures_included: int = 0
    epochs_attested: set = field(default_factory=set)
    epochs_seen_gossip: set = field(default_factory=set)


class ValidatorMonitor:
    """Tracks registered validators through block import: attestation
    inclusions (with delay), proposals, sync-aggregate participation."""

    def __init__(self, auto_register: bool = False):
        self.validators: dict[int, MonitoredValidator] = {}
        self.auto_register = auto_register

    def register(self, *indices: int) -> None:
        for i in indices:
            self.validators.setdefault(int(i), MonitoredValidator(int(i)))

    def _get(self, index: int) -> MonitoredValidator | None:
        v = self.validators.get(int(index))
        if v is None and self.auto_register:
            v = MonitoredValidator(int(index))
            self.validators[int(index)] = v
        return v

    # -- block import feed (validator_monitor.rs process_valid_state /
    #    register_attestation_in_block shapes) ------------------------------

    def process_block(self, block, committee_cache_for_epoch, preset) -> None:
        """Called once per imported block with a shuffling-cache closure:
        records the proposal plus every monitored attester the block
        includes."""
        mv = self._get(int(block.proposer_index))
        if mv is not None:
            mv.blocks_proposed += 1
            MONITORED_PROPOSALS.inc()
        for att in block.body.attestations:
            data = att.data
            epoch = int(data.slot) // preset.slots_per_epoch
            try:
                cache = committee_cache_for_epoch(epoch)
                committee = cache.committee(int(data.slot), int(data.index))
            except Exception:  # noqa: BLE001 — unknown shuffling: skip
                continue
            delay = int(block.slot) - int(data.slot)
            for bit, vi in zip(att.aggregation_bits, committee):
                if not bit:
                    continue
                mv = self._get(int(vi))
                if mv is None:
                    continue
                mv.attestations_included += 1
                mv.inclusion_delay_sum += delay
                mv.last_attested_epoch = max(mv.last_attested_epoch, epoch)
                mv.epochs_attested.add(epoch)
                MONITORED_ATTESTATIONS.inc()

    def register_gossip_attestation(self, indexed_or_indices, epoch: int) -> None:
        """Attestation seen ON GOSSIP by monitored validators — the
        wire-vs-included distinction validator_monitor.rs draws with
        register_gossip_unaggregated_attestation: a validator whose votes
        are seen but never included points at packing/propagation, one
        never even seen points at the validator itself."""
        indices = getattr(
            indexed_or_indices, "attesting_indices", indexed_or_indices
        )
        for vi in indices:
            mv = self._get(int(vi))
            if mv is None:
                continue
            mv.attestations_seen_gossip += 1
            mv.epochs_seen_gossip.add(int(epoch))

    def register_missed_block(self, proposer_index: int) -> None:
        """A monitored proposer's slot passed without a block
        (validator_monitor.rs register_missed_block)."""
        mv = self._get(int(proposer_index))
        if mv is not None:
            mv.blocks_missed += 1

    def process_sync_aggregate(self, aggregate, committee_indices) -> None:
        for bit, vi in zip(aggregate.sync_committee_bits, committee_indices):
            if not bit:
                continue
            mv = self._get(int(vi))
            if mv is not None:
                mv.sync_signatures_included += 1

    # -- summaries ---------------------------------------------------------

    def summary(self, epoch: int) -> dict:
        """Per-epoch roll-up (the validator_monitor.rs per-epoch logs)."""
        hit = sum(
            1 for v in self.validators.values() if epoch in v.epochs_attested
        )
        missed = [
            v.index
            for v in self.validators.values()
            if epoch not in v.epochs_attested
        ]
        total_incl = sum(v.attestations_included for v in self.validators.values())
        seen_not_included = [
            v.index
            for v in self.validators.values()
            if epoch in v.epochs_seen_gossip
            and epoch not in v.epochs_attested
        ]
        return {
            "epoch": epoch,
            "monitored": len(self.validators),
            "attested": hit,
            "missed": missed,
            # the diagnostic split: votes on the wire that never landed
            # in a block (packing/propagation) vs never seen at all
            "seen_gossip_not_included": seen_not_included,
            "avg_inclusion_delay": (
                sum(v.inclusion_delay_sum for v in self.validators.values())
                / total_incl
                if total_incl
                else 0.0
            ),
            "blocks_proposed": sum(
                v.blocks_proposed for v in self.validators.values()
            ),
            "blocks_missed": sum(
                v.blocks_missed for v in self.validators.values()
            ),
            "sync_signatures": sum(
                v.sync_signatures_included for v in self.validators.values()
            ),
        }
