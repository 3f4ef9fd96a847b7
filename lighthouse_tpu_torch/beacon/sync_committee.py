"""Sync-committee pipelines: gossip verification + aggregation pool.

Twin of beacon_node/beacon_chain/src/sync_committee_verification.rs
(message ladder :290, contribution ladder :617/:678 — the 3-set batch:
selection proof, outer envelope, aggregate body, exactly the shape the
device batch verifier consumes) and the sync half of
naive_aggregation_pool.rs (messages aggregate into contributions per
subcommittee; contributions merge into the SyncAggregate a produced block
carries).
"""

from __future__ import annotations

from ..consensus import spec as S
from ..consensus.state_processing import signature_sets as sets
from ..crypto.bls import api as bls
from ..ops import sha256

TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE = 16

# the infinity G2 compressed encoding — the valid empty-aggregate signature
INFINITY_SIGNATURE = b"\xc0" + bytes(95)


class SyncCommitteeError(Exception):
    pass


def _err(cond: bool, msg: str) -> None:
    if not cond:
        raise SyncCommitteeError(msg)


# ---------------------------------------------------------------------------
# Subcommittee membership helpers (altair validator guide)
# ---------------------------------------------------------------------------


def sync_committee_indices(state) -> list[int]:
    """Validator index per sync-committee POSITION (duplicates allowed)."""
    by_pubkey = {}
    for i, v in enumerate(state.validators):
        by_pubkey.setdefault(bytes(v.pubkey), i)
    return [
        by_pubkey[bytes(pk)] for pk in state.current_sync_committee.pubkeys
    ]


def subnets_for_validator(state, validator_index: int, spec) -> set[int]:
    """compute_subnets_for_sync_committee: which sync subnets this
    validator's positions fall into."""
    size = spec.preset.sync_committee_size // spec.sync_committee_subnet_count
    indices = sync_committee_indices(state)
    return {
        pos // size for pos, vi in enumerate(indices) if vi == validator_index
    }


def is_sync_committee_aggregator(selection_proof: bytes, spec) -> bool:
    """altair is_sync_committee_aggregator: hash-mod selection."""
    preset = spec.preset
    modulo = max(
        1,
        preset.sync_committee_size
        // spec.sync_committee_subnet_count
        // TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE,
    )
    return int.from_bytes(sha256(bytes(selection_proof))[:8], "little") % modulo == 0


# ---------------------------------------------------------------------------
# Gossip verification ladders
# ---------------------------------------------------------------------------


def verify_sync_committee_message(
    chain, msg, subnet_id: int, batch_verify: bool = True
) -> None:
    """sync_committee_verification.rs:290 — slot, membership in the subnet's
    subcommittee, then the signature over the block root."""
    state = chain.head_state()
    spec = chain.spec
    preset = spec.preset
    vi = int(msg.validator_index)
    subnets = subnets_for_validator(state, vi, spec)
    _err(subnets, f"validator {vi} not in the current sync committee")
    _err(
        subnet_id in subnets,
        f"message on subnet {subnet_id}, validator belongs to {sorted(subnets)}",
    )
    s = sets.sync_committee_message_signature_set(
        state,
        chain.get_pubkey,
        vi,
        int(msg.slot),
        bytes(msg.beacon_block_root),
        bytes(msg.signature),
        preset,
    )
    _err(s.verify(), "sync committee message signature invalid")


def verify_sync_contribution(chain, signed) -> None:
    """sync_committee_verification.rs:617 — the contribution's THREE
    signature sets batch-verified together (selection proof, envelope,
    aggregate body), the exact per-aggregate shape the device batch path
    is fed (attestation_verification/batch.rs:78-109 analog)."""
    state = chain.head_state()
    spec = chain.spec
    preset = spec.preset
    msg = signed.message
    contribution = msg.contribution
    sub_idx = int(contribution.subcommittee_index)
    _err(
        sub_idx < spec.sync_committee_subnet_count,
        "subcommittee index out of range",
    )
    _err(
        is_sync_committee_aggregator(bytes(msg.selection_proof), spec),
        "selection proof does not select this aggregator",
    )
    agg_index = int(msg.aggregator_index)
    _err(
        sub_idx in subnets_for_validator(state, agg_index, spec),
        "aggregator not in the contribution's subcommittee",
    )
    size = preset.sync_committee_size // spec.sync_committee_subnet_count
    indices = sync_committee_indices(state)
    sub_positions = indices[sub_idx * size : (sub_idx + 1) * size]
    participants = [
        chain.get_pubkey(vi)
        for bit, vi in zip(contribution.aggregation_bits, sub_positions)
        if bit
    ]
    _err(all(p is not None for p in participants), "unknown participant")
    _err(len(participants) > 0, "empty contribution")
    batch = [
        sets.sync_selection_proof_signature_set(
            state, chain.get_pubkey, agg_index, int(contribution.slot),
            sub_idx, bytes(msg.selection_proof), preset,
        ),
        sets.contribution_and_proof_signature_set(
            state, chain.get_pubkey, signed, preset
        ),
        sets.sync_contribution_signature_set(
            state, contribution, participants, preset
        ),
    ]
    _err(
        bls.verify_signature_sets(batch),
        "contribution batch signature verification failed",
    )


# ---------------------------------------------------------------------------
# Aggregation pool (the sync half of naive_aggregation_pool.rs)
# ---------------------------------------------------------------------------


class SyncContributionPool:
    """Verified messages aggregate per (slot, root, subcommittee); verified
    contributions merge; production drains into one SyncAggregate."""

    def __init__(self, spec):
        self.spec = spec
        # (slot, root, subcommittee) -> {position_in_sub: Signature}
        self._messages: dict[tuple, dict[int, bls.Signature]] = {}
        # (slot, root) -> {subcommittee: (bits, Signature aggregate)}
        self._contributions: dict[tuple, dict[int, tuple[list, bls.Signature]]] = {}

    def insert_message(self, msg, state) -> None:
        """A gossip-verified SyncCommitteeMessage lands at every position
        its validator holds in the subcommittees."""
        preset = self.spec.preset
        size = preset.sync_committee_size // self.spec.sync_committee_subnet_count
        indices = sync_committee_indices(state)
        vi = int(msg.validator_index)
        sig = bls.Signature.from_bytes(bytes(msg.signature))
        for pos, holder in enumerate(indices):
            if holder != vi:
                continue
            key = (int(msg.slot), bytes(msg.beacon_block_root), pos // size)
            self._messages.setdefault(key, {})[pos % size] = sig

    def build_contribution(self, slot: int, root: bytes, subcommittee: int):
        """Aggregate this subcommittee's messages into a contribution
        (the aggregator's 2/3-slot product), or None if empty."""
        from ..consensus.containers import types_for

        key = (int(slot), bytes(root), int(subcommittee))
        have = self._messages.get(key)
        if not have:
            return None
        preset = self.spec.preset
        size = preset.sync_committee_size // self.spec.sync_committee_subnet_count
        bits = [False] * size
        sigs = []
        for pos, sig in sorted(have.items()):
            bits[pos] = True
            sigs.append(sig)
        T = types_for(preset)
        return T.SyncCommitteeContribution(
            slot=slot,
            beacon_block_root=bytes(root),
            subcommittee_index=subcommittee,
            aggregation_bits=bits,
            signature=bls.AggregateSignature.aggregate(sigs).to_bytes(),
        )

    def insert_contribution(self, contribution) -> None:
        """A verified contribution (gossip or self-built) merges into the
        per-root map production reads."""
        key = (int(contribution.slot), bytes(contribution.beacon_block_root))
        per_sub = self._contributions.setdefault(key, {})
        sub = int(contribution.subcommittee_index)
        bits = [bool(b) for b in contribution.aggregation_bits]
        sig = bls.Signature.from_bytes(bytes(contribution.signature))
        old = per_sub.get(sub)
        if old is None or sum(bits) > sum(old[0]):
            per_sub[sub] = (bits, sig)

    def get_sync_aggregate(self, slot: int, root: bytes, T):
        """The SyncAggregate for a block built at ``slot`` whose parent is
        ``root`` (participants signed the PREVIOUS slot's head)."""
        per_sub = self._contributions.get((int(slot), bytes(root)), {})
        preset = self.spec.preset
        size = preset.sync_committee_size // self.spec.sync_committee_subnet_count
        bits = [False] * preset.sync_committee_size
        sigs = []
        for sub, (sub_bits, sig) in sorted(per_sub.items()):
            for i, b in enumerate(sub_bits):
                if b:
                    bits[sub * size + i] = True
            sigs.append(sig)
        if not sigs:
            return T.SyncAggregate(
                sync_committee_bits=bits,
                sync_committee_signature=INFINITY_SIGNATURE,
            )
        return T.SyncAggregate(
            sync_committee_bits=bits,
            sync_committee_signature=bls.AggregateSignature.aggregate(
                sigs
            ).to_bytes(),
        )

    def prune(self, before_slot: int) -> None:
        self._messages = {
            k: v for k, v in self._messages.items() if k[0] >= before_slot
        }
        self._contributions = {
            k: v for k, v in self._contributions.items() if k[0] >= before_slot
        }
