"""Bulk block-signature verification — every set of a block in ONE batch.

Twin of consensus/state_processing/src/per_block_processing/
block_signature_verifier.rs:74-139: collect the (pubkey, message, signature)
sets of a signed block — proposal (:179), randao (:198), proposer slashings
(:215), attester slashings (:244), attestations (:273), exits (:303), sync
aggregate (:327), BLS-to-execution changes (:347) — and verify them all with
one call into the backend's batch verifier.

Where the reference then fans the sets across rayon threads
(ParallelSignatureSets::verify, :396-405), here the whole list goes to the
active BLS backend in one call: on the JAX backend that is one device batch
(the chunk-AND-reduce happens across the mesh inside the kernel), on the CPU
oracle it is the sequential equivalent.  Poisoned-batch attribution is the
caller's job (the beacon_processor analog bisects on device).
"""

from __future__ import annotations

from ...crypto.bls.api import SignatureSet, get_backend
from ..committees import CommitteeCache, get_indexed_attestation
from ..spec import ChainSpec
from . import signature_sets as sets


class BlockSignatureVerifier:
    """Collects signature sets for whole blocks, then verifies once."""

    def __init__(self, state, get_pubkey, spec: ChainSpec):
        self.state = state
        self.get_pubkey = get_pubkey
        self.spec = spec
        self.preset = spec.preset
        self.sets: list[SignatureSet] = []

    # --- collectors (block_signature_verifier.rs:159-360) -----------------

    def include_block_proposal(self, signed_block, block_root=None, proposer_index=None):
        self.sets.append(
            sets.block_proposal_signature_set(
                self.state,
                self.get_pubkey,
                signed_block,
                self.preset,
                block_root=block_root,
                verified_proposer_index=proposer_index,
            )
        )

    def include_randao_reveal(self, block, proposer_index=None):
        self.sets.append(
            sets.randao_signature_set(
                self.state, self.get_pubkey, block, self.preset, proposer_index
            )
        )

    def include_proposer_slashings(self, block):
        for ps in block.body.proposer_slashings:
            self.sets.extend(
                sets.proposer_slashing_signature_set(
                    self.state, self.get_pubkey, ps, self.preset
                )
            )

    def include_attester_slashings(self, block):
        for asl in block.body.attester_slashings:
            self.sets.extend(
                sets.attester_slashing_signature_sets(
                    self.state, self.get_pubkey, asl, self.preset
                )
            )

    def include_attestations(self, block, committee_cache_for_epoch):
        """committee_cache_for_epoch: epoch -> CommitteeCache (the shuffling
        cache closure of block_verification.rs:1258)."""
        for att in block.body.attestations:
            epoch = att.data.slot // self.preset.slots_per_epoch
            cache: CommitteeCache = committee_cache_for_epoch(epoch)
            committee = cache.committee(att.data.slot, att.data.index)
            indexed = get_indexed_attestation(committee, att)
            self.sets.append(
                sets.indexed_attestation_signature_set(
                    self.state, self.get_pubkey, indexed, self.preset
                )
            )

    def include_exits(self, block):
        for ex in block.body.voluntary_exits:
            self.sets.append(
                sets.exit_signature_set(self.state, self.get_pubkey, ex, self.spec)
            )

    def include_sync_aggregate(self, block, participant_indices, block_root_at_prev):
        body = block.body
        if not hasattr(body, "sync_aggregate"):
            return
        s = sets.sync_aggregate_signature_set(
            self.state,
            self.get_pubkey,
            body.sync_aggregate,
            participant_indices,
            block.slot,
            block_root_at_prev,
            self.preset,
        )
        if s is not None:
            self.sets.append(s)

    def include_bls_to_execution_changes(self, block):
        body = block.body
        if not hasattr(body, "bls_to_execution_changes"):
            return
        for ch in body.bls_to_execution_changes:
            self.sets.append(
                sets.bls_execution_change_signature_set(self.state, ch, self.spec)
            )

    # --- driver -----------------------------------------------------------

    def include_all(
        self,
        signed_block,
        committee_cache_for_epoch,
        sync_participants=None,
        block_root_at_prev=None,
    ):
        """verify_entire_block (block_signature_verifier.rs:128-139)."""
        block = signed_block.message
        self.include_block_proposal(signed_block)
        self.include_randao_reveal(block)
        self.include_proposer_slashings(block)
        self.include_attester_slashings(block)
        self.include_attestations(block, committee_cache_for_epoch)
        self.include_exits(block)
        if sync_participants is not None:
            self.include_sync_aggregate(
                block, sync_participants, block_root_at_prev or bytes(32)
            )
        self.include_bls_to_execution_changes(block)
        return self

    def verify(self) -> bool:
        """One backend batch call over every collected set."""
        if not self.sets:
            return True
        return get_backend().verify_signature_sets(self.sets)
