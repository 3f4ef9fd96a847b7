"""BN-side naive aggregation of gossip attestation singles.

Twin of beacon_node/beacon_chain/src/naive_aggregation_pool.rs (792 LoC):
the node observes unaggregated attestations on their subnets and merges
them per AttestationData, so produced blocks pack aggregates the node
built ITSELF from gossip singles — not only what aggregators delivered.
"""

from __future__ import annotations

import threading

from ..crypto.bls import api as bls
from ..utils import metrics as M


class NaiveAggregationPool:
    """Merge single-bit attestations per data root; aggregate lazily.

    Thread-safe: gossip handler threads insert while API handler threads
    (GET aggregate_attestation, produce) read — bits and sigs for a group
    must be snapshotted together or a served aggregate's signature can
    disagree with its aggregation_bits."""

    def __init__(self, max_data: int = 1024):
        # data_root -> (data, bits list, [Signature]) — a sig per NEW bit
        self._groups: dict[bytes, tuple[object, list[bool], list]] = {}
        self.max_data = max_data
        self._lock = threading.Lock()
        # resident signatures across groups — the marginal cost of the
        # next get_aggregates() BLS pass.  Disjoint bit-subset storms grow
        # this superlinearly relative to attester count, which is exactly
        # what the pool_estimated_verify_cost gauge is there to expose.
        self._resident_sigs = 0

    def _publish_cost(self) -> None:
        M.POOL_ESTIMATED_VERIFY_COST.set(self._resident_sigs)

    def insert(self, attestation) -> bool:
        """True if the attestation added at least one new attester bit
        (naive_aggregation_pool.rs InsertOutcome::NewItemAdded)."""
        key = attestation.data.root()
        bits = [bool(b) for b in attestation.aggregation_bits]
        sig = bls.Signature.from_bytes(bytes(attestation.signature))
        with self._lock:
            entry = self._groups.get(key)
            if entry is None:
                if len(self._groups) >= self.max_data:
                    evicted = self._groups.pop(next(iter(self._groups)))
                    self._resident_sigs -= len(evicted[2])
                self._groups[key] = (attestation.data, bits, [sig])
                self._resident_sigs += 1
                self._publish_cost()
                return True
            data, have, sigs = entry
            new = [b and not h for b, h in zip(bits, have)]
            if not any(new):
                return False  # every attester already known
            if any(b and h for b, h in zip(bits, have)):
                return False  # overlapping aggregate: cannot merge soundly
            for i, b in enumerate(bits):
                if b:
                    have[i] = True
            sigs.append(sig)
            self._resident_sigs += 1
            self._publish_cost()
            return True

    def _snapshot(self, entry):
        """(data, bits copy, sigs copy) — taken under the lock so the
        signature always covers exactly the claimed bits."""
        data, bits, sigs = entry
        return data, list(bits), list(sigs)

    def get_aggregate(self, data_root: bytes):
        """Best-known aggregate for one data root (the BN half of
        `/eth/v1/validator/aggregate_attestation`,
        http_api/src/lib.rs:319 route tree); None if unseen."""
        from ..consensus.containers import Attestation

        with self._lock:
            entry = self._groups.get(data_root)
            if entry is None:
                return None
            data, bits, sigs = self._snapshot(entry)
        # BLS aggregation runs outside the lock (it is the expensive part)
        return Attestation(
            aggregation_bits=bits,
            data=data,
            signature=bls.AggregateSignature.aggregate(sigs).to_bytes(),
        )

    def get_aggregates(self) -> list:
        """One merged Attestation per data (the produce_block feed)."""
        from ..consensus.containers import Attestation

        with self._lock:
            snaps = [self._snapshot(e) for e in self._groups.values()]
        return [
            Attestation(
                aggregation_bits=bits,
                data=data,
                signature=bls.AggregateSignature.aggregate(sigs).to_bytes(),
            )
            for data, bits, sigs in snaps
        ]

    def prune(self, current_slot: int, preset) -> None:
        """Drop data older than one epoch (the pool's retention window)."""
        with self._lock:
            self._groups = {
                key: entry
                for key, entry in self._groups.items()
                if int(entry[0].slot) + preset.slots_per_epoch >= current_slot
            }
            self._resident_sigs = sum(
                len(e[2]) for e in self._groups.values()
            )
            self._publish_cost()

    def __len__(self) -> int:
        with self._lock:
            return len(self._groups)
