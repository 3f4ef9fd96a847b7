"""Operation pool: exits/slashings/attestations awaiting block inclusion.

Twin of beacon_node/operation_pool: pooled ops keyed for dedup, and
attestation packing as greedy weighted max-coverage (src/max_cover.rs:4-11
documents the same approximation: pick the set covering the most yet-
uncovered validators, mask, repeat).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class OperationPool:
    attestations: dict[bytes, list] = field(default_factory=dict)
    proposer_slashings: dict[int, object] = field(default_factory=dict)
    attester_slashings: list = field(default_factory=list)
    voluntary_exits: dict[int, object] = field(default_factory=dict)
    bls_changes: dict[int, object] = field(default_factory=dict)

    # ---------------------------------------------------------------- insert

    def insert_attestation(self, attestation) -> None:
        """Group by attestation data root (mergeable aggregates); identical
        bit patterns are dropped (re-inserted naive-pool aggregates)."""
        key = attestation.data.root()
        group = self.attestations.setdefault(key, [])
        bits = [bool(b) for b in attestation.aggregation_bits]
        for existing in group:
            if [bool(b) for b in existing.aggregation_bits] == bits:
                return
        group.append(attestation)

    def insert_proposer_slashing(self, slashing) -> None:
        self.proposer_slashings[
            slashing.signed_header_1.message.proposer_index
        ] = slashing

    def insert_attester_slashing(self, slashing) -> None:
        self.attester_slashings.append(slashing)

    def insert_voluntary_exit(self, signed_exit) -> None:
        self.voluntary_exits[signed_exit.message.validator_index] = signed_exit

    # ----------------------------------------------------------------- pack

    def get_attestations_for_block(
        self, state, preset, max_count: int | None = None
    ) -> list:
        """Greedy max-cover packing (max_cover.rs): score = newly covered
        attesters, iteratively masked."""
        max_count = max_count if max_count is not None else preset.max_attestations
        current = state.slot // preset.slots_per_epoch
        previous = max(current, 1) - 1
        candidates = []
        for group in self.attestations.values():
            for att in group:
                epoch = att.data.slot // preset.slots_per_epoch
                if epoch not in (previous, current):
                    continue
                if att.data.slot + 1 > state.slot:
                    continue  # inclusion delay not met
                candidates.append(att)
        covered: set[tuple[bytes, int]] = set()
        packed = []
        while candidates and len(packed) < max_count:
            best, best_new = None, set()
            for att in candidates:
                key = att.data.root()
                new = {
                    (key, i)
                    for i, b in enumerate(att.aggregation_bits)
                    if b and (key, i) not in covered
                }
                if len(new) > len(best_new):
                    best, best_new = att, new
            if best is None or not best_new:
                break
            packed.append(best)
            covered |= best_new
            candidates.remove(best)
        return packed

    def get_slashings_and_exits(self, state, preset, spec=None):
        """Bounded op lists for a block, validity-filtered against the
        packing ``state`` (op_pool/src/lib.rs get_slashings: an op that
        would fail the transition — e.g. a proposer already slashed by an
        earlier inclusion — must not be packed, or the proposal itself
        becomes invalid)."""
        from ..consensus.testing import FAR_FUTURE_EPOCH

        current = state.slot // preset.slots_per_epoch

        def _slashable(idx: int) -> bool:
            if idx >= len(state.validators):
                return False
            v = state.validators[idx]
            return (
                not v.slashed
                and v.activation_epoch <= current < v.withdrawable_epoch
            )

        ps = [
            s for s in self.proposer_slashings.values()
            if _slashable(int(s.signed_header_1.message.proposer_index))
        ][: preset.max_proposer_slashings]
        asl = [
            s for s in self.attester_slashings
            if any(
                _slashable(int(i))
                for i in set(s.attestation_1.attesting_indices)
                & set(s.attestation_2.attesting_indices)
            )
        ][: preset.max_attester_slashings]
        def _exitable(e) -> bool:
            # mirror process_voluntary_exit's full validity ladder — a
            # packed exit that is too young (shard_committee_period), not
            # yet due (exit.epoch in the future), inactive, or already
            # exiting would invalidate the whole proposal
            idx = int(e.message.validator_index)
            if idx >= len(state.validators):
                return False
            v = state.validators[idx]
            period = spec.shard_committee_period if spec is not None else 256
            return (
                v.exit_epoch == FAR_FUTURE_EPOCH
                and v.activation_epoch <= current
                and current >= int(e.message.epoch)
                and current >= v.activation_epoch + period
            )

        exits = [
            e for e in self.voluntary_exits.values() if _exitable(e)
        ][: preset.max_voluntary_exits]
        return ps, asl, exits

    # ---------------------------------------------------------------- prune

    def prune(self, state, preset) -> None:
        """Drop ops made irrelevant by finalization/inclusion."""
        current = state.slot // preset.slots_per_epoch
        previous = max(current, 1) - 1
        for key in list(self.attestations):
            group = [
                a
                for a in self.attestations[key]
                if a.data.slot // preset.slots_per_epoch >= previous
            ]
            if group:
                self.attestations[key] = group
            else:
                del self.attestations[key]
        from ..consensus.testing import FAR_FUTURE_EPOCH

        for idx in list(self.voluntary_exits):
            if (
                idx < len(state.validators)
                and state.validators[idx].exit_epoch != FAR_FUTURE_EPOCH
            ):
                del self.voluntary_exits[idx]
        for idx in list(self.proposer_slashings):
            if idx < len(state.validators) and state.validators[idx].slashed:
                del self.proposer_slashings[idx]

    def num_attestations(self) -> int:
        return sum(len(g) for g in self.attestations.values())
