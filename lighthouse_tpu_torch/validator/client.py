"""Validator client: duties, attestation, block production services.

Twin of validator_client/src (ProductionValidatorClient service set,
lib.rs:93-98): DutiesService (duties_service.rs — poll committee/proposer
assignments per epoch), AttestationService (attestation_service.rs — sign
at 1/3 slot, aggregate at 2/3), BlockService, signing through a
ValidatorStore that consults slashing protection before EVERY signature
(signing_method.rs's local-keystore path; a Web3Signer-style remote hook is
the `sign_fn` injection point), and a DoppelgangerService liveness gate.

The beacon-node boundary is the `chain` object (in-process BeaconChain or
the HTTP client from lighthouse_tpu.network.api_client — both expose the
produce/submit surface the services need).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

from ..consensus import committees as cm
from ..consensus import spec as S
from ..consensus.containers import (
    AggregateAndProof,
    Attestation,
    AttestationData,
    Checkpoint,
    SignedAggregateAndProof,
)
from ..consensus.state_processing import signature_sets as sets
from ..crypto.bls import api as bls
from ..utils import get_logger, log_with
from .slashing_protection import SlashingDatabase, SlashingProtectionError


@dataclass
class Duty:
    validator_index: int
    slot: int
    committee_index: int
    committee_position: int
    committee_size: int


@dataclass
class ValidatorStore:
    """Keys + slashing protection (validator_store.rs)."""

    keys: dict[bytes, bls.SecretKey]  # pubkey bytes -> sk
    slashing_db: SlashingDatabase
    index_by_pubkey: dict[bytes, int] = field(default_factory=dict)
    # signing_method.rs: None = local keystore; a RemoteSigner routes every
    # signature over the web3signer wire instead (keys dict then only
    # carries pubkeys as dict keys; secret values may be None)
    signer: object = None

    def __post_init__(self):
        for pk in self.keys:
            self.slashing_db.register_validator(pk)
        self.pk_by_index = {v: k for k, v in self.index_by_pubkey.items()}

    def _sign(self, pubkey: bytes, root: bytes):
        if self.signer is not None:
            return self.signer.sign(pubkey, root)
        return self.keys[pubkey].sign(root)

    def sign_attestation(self, pubkey: bytes, data: AttestationData, state, preset):
        domain = sets.get_domain(
            state.fork,
            state.genesis_validators_root,
            S.DOMAIN_BEACON_ATTESTER,
            int(data.target.epoch),
        )
        root = S.compute_signing_root(data, domain)
        self.slashing_db.check_and_insert_attestation(
            pubkey, int(data.source.epoch), int(data.target.epoch), root
        )
        return self._sign(pubkey, root)

    def sign_block(self, pubkey: bytes, block, state, preset):
        epoch = int(block.slot) // preset.slots_per_epoch
        domain = sets.get_domain(
            state.fork, state.genesis_validators_root,
            S.DOMAIN_BEACON_PROPOSER, epoch,
        )
        root = S.compute_signing_root(block, domain)
        self.slashing_db.check_and_insert_block_proposal(
            pubkey, int(block.slot), root
        )
        return self._sign(pubkey, root)

    def sign_selection_proof(self, pubkey: bytes, slot: int, state, preset):
        from ..consensus.containers import SigningData
        from ..consensus.ssz import U64

        domain = sets.get_domain(
            state.fork, state.genesis_validators_root,
            S.DOMAIN_SELECTION_PROOF, slot // preset.slots_per_epoch,
        )
        root = SigningData(
            object_root=U64.hash_tree_root(slot), domain=domain
        ).root()
        return self._sign(pubkey, root)

    def sign_aggregate_and_proof(self, pubkey: bytes, msg, state, preset):
        """SignedAggregateAndProof envelope signature (shared by the
        in-process and remote aggregation rounds)."""
        domain = sets.get_domain(
            state.fork, state.genesis_validators_root,
            S.DOMAIN_AGGREGATE_AND_PROOF,
            int(msg.aggregate.data.slot) // preset.slots_per_epoch,
        )
        return self._sign(pubkey, S.compute_signing_root(msg, domain))

    # --- sync-committee signing (not slashable: no DB gate) ---------------

    def sign_sync_committee_message(
        self, pubkey: bytes, slot: int, block_root: bytes, state, preset
    ):
        from ..consensus.containers import SigningData
        from ..consensus.ssz import ByteVector

        domain = sets.get_domain(
            state.fork, state.genesis_validators_root,
            S.DOMAIN_SYNC_COMMITTEE, slot // preset.slots_per_epoch,
        )
        root = SigningData(
            object_root=ByteVector(32).hash_tree_root(block_root),
            domain=domain,
        ).root()
        return self._sign(pubkey, root)

    def sign_sync_selection_proof(
        self, pubkey: bytes, slot: int, subcommittee_index: int, state, preset
    ):
        from ..consensus.containers import SyncAggregatorSelectionData

        domain = sets.get_domain(
            state.fork, state.genesis_validators_root,
            S.DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
            slot // preset.slots_per_epoch,
        )
        data = SyncAggregatorSelectionData(
            slot=slot, subcommittee_index=subcommittee_index
        )
        return self._sign(pubkey, S.compute_signing_root(data, domain))

    def sign_contribution_and_proof(self, pubkey: bytes, msg, state, preset):
        domain = sets.get_domain(
            state.fork, state.genesis_validators_root,
            S.DOMAIN_CONTRIBUTION_AND_PROOF,
            int(msg.contribution.slot) // preset.slots_per_epoch,
        )
        return self._sign(pubkey, S.compute_signing_root(msg, domain))


class DutiesService:
    """Compute per-epoch attester + proposer duties for managed keys."""

    def __init__(self, chain, store: ValidatorStore):
        self.chain = chain
        self.store = store

    def attester_duties(self, epoch: int) -> list[Duty]:
        state = self.chain.head_state()
        cache = self.chain.committee_cache(state, epoch)
        managed = {
            self.store.index_by_pubkey.get(pk) for pk in self.store.keys
        } - {None}
        out = []
        preset = self.chain.preset
        for slot, index, committee in cm.iter_epoch_committees(
            cache, epoch, preset
        ):
            for pos, vi in enumerate(committee):
                if int(vi) in managed:
                    out.append(
                        Duty(
                            validator_index=int(vi),
                            slot=slot,
                            committee_index=index,
                            committee_position=pos,
                            committee_size=len(committee),
                        )
                    )
        return out

    def proposer_duties(self, epoch: int) -> dict[int, int]:
        """slot -> proposer validator index for the epoch."""
        state = self.chain.head_state()
        preset = self.chain.preset
        out = {}
        for slot in range(
            max(epoch * preset.slots_per_epoch, 1),
            (epoch + 1) * preset.slots_per_epoch,
        ):
            if slot < int(state.slot):
                continue
            out[slot] = cm.get_beacon_proposer_index(state, slot, preset)
        return out


class AttestationService:
    """Sign + publish attestations at the 1/3-slot mark
    (attestation_service.rs)."""

    def __init__(self, chain, store: ValidatorStore, duties: DutiesService):
        self.chain = chain
        self.store = store
        self.duties = duties
        self.log = get_logger("validator")

    def attest(self, slot: int) -> list[Attestation]:
        preset = self.chain.preset
        epoch = slot // preset.slots_per_epoch
        state = self.chain.head_state()
        head_root = self.chain.head_root
        target_slot = epoch * preset.slots_per_epoch
        if int(state.slot) > target_slot:
            target_root = bytes(
                state.block_roots[target_slot % preset.slots_per_historical_root]
            )
        else:
            target_root = head_root
        produced = []
        pk_by_index = self.store.pk_by_index
        for duty in self.duties.attester_duties(epoch):
            if duty.slot != slot:
                continue
            data = AttestationData(
                slot=slot,
                index=duty.committee_index,
                beacon_block_root=head_root,
                source=state.current_justified_checkpoint,
                target=Checkpoint(epoch=epoch, root=target_root),
            )
            pubkey = pk_by_index[duty.validator_index]
            try:
                sig = self.store.sign_attestation(pubkey, data, state, preset)
            except SlashingProtectionError as e:
                log_with(
                    self.log, logging.WARNING, "Refusing to sign attestation",
                    validator=duty.validator_index, reason=str(e),
                )
                continue
            bits = [False] * duty.committee_size
            bits[duty.committee_position] = True
            produced.append(
                Attestation(
                    aggregation_bits=bits, data=data, signature=sig.to_bytes()
                )
            )
        return produced

    def aggregate(self, slot: int, attestations: list[Attestation]):
        """2/3-slot aggregation round: merge same-data attestations and
        wrap in SignedAggregateAndProof for each selected aggregator."""
        by_data: dict[bytes, list[Attestation]] = {}
        for att in attestations:
            by_data.setdefault(att.data.root(), []).append(att)
        out = []
        state = self.chain.head_state()
        preset = self.chain.preset
        epoch = slot // preset.slots_per_epoch
        duties_by_committee = {}
        for d in self.duties.attester_duties(epoch):
            if d.slot == slot:
                duties_by_committee.setdefault(d.committee_index, []).append(d)
        for group in by_data.values():
            base = group[0]
            bits = list(base.aggregation_bits)
            sigs = [bls.Signature.from_bytes(bytes(base.signature))]
            for other in group[1:]:
                for i, b in enumerate(other.aggregation_bits):
                    if b:
                        bits[i] = True
                sigs.append(bls.Signature.from_bytes(bytes(other.signature)))
            merged = Attestation(
                aggregation_bits=bits,
                data=base.data,
                signature=bls.AggregateSignature.aggregate(sigs).to_bytes(),
            )
            # the aggregator must be a managed validator IN this committee
            committee_duties = duties_by_committee.get(int(base.data.index), [])
            if not committee_duties:
                continue  # no managed member: not our aggregation duty
            agg_index = min(d.validator_index for d in committee_duties)
            pubkey = self.store.pk_by_index[agg_index]
            proof = self.store.sign_selection_proof(pubkey, slot, state, preset)
            msg = AggregateAndProof(
                aggregator_index=agg_index,
                aggregate=merged,
                selection_proof=proof.to_bytes(),
            )
            sig = self.store.sign_aggregate_and_proof(
                pubkey, msg, state, preset
            )
            out.append(
                SignedAggregateAndProof(message=msg, signature=sig.to_bytes())
            )
        return out


class BlockService:
    """Propose when a managed validator has the duty (block_service.rs)."""

    def __init__(self, chain, store: ValidatorStore, duties: DutiesService):
        self.chain = chain
        self.store = store
        self.duties = duties

    def propose(self, slot: int, keypairs) -> bytes | None:
        preset = self.chain.preset
        proposers = self.duties.proposer_duties(slot // preset.slots_per_epoch)
        proposer = proposers.get(slot)
        pk_by_index = {v: k for k, v in self.store.index_by_pubkey.items()}
        if proposer not in pk_by_index:
            return None
        signed = self.chain.produce_block(slot, keypairs)
        # re-sign through slashing protection (produce_block's signature is
        # the harness's; the VC path must gate on the database)
        pubkey = pk_by_index[proposer]
        state = self.chain.head_state()
        sig = self.store.sign_block(pubkey, signed.message, state, preset)
        signed.signature = sig.to_bytes()
        return self.chain.process_block(signed, verify_signatures=False)


class SyncCommitteeService:
    """The sync-duty family (validator_client/src/sync_committee_service.rs,
    647 LoC): every managed validator in the current sync committee signs
    the head root each slot; selected aggregators build contributions from
    the BN pool at 2/3 slot and wrap them in SignedContributionAndProof."""

    def __init__(self, chain, store: ValidatorStore, spec):
        self.chain = chain
        self.store = store
        self.spec = spec
        self.log = get_logger("validator.sync")

    def _managed_committee_members(self, state):
        from ..beacon.sync_committee import subnets_for_validator

        out = []
        for pk, vi in self.store.index_by_pubkey.items():
            subnets = subnets_for_validator(state, vi, self.spec)
            if subnets:
                out.append((pk, vi, subnets))
        return out

    def produce_messages(self, slot: int):
        """[(subnet_id, SyncCommitteeMessage)] for every managed member —
        signed over the CURRENT head root (the 1/3-slot product)."""
        from ..consensus.containers import types_for

        state = self.chain.head_state()
        preset = self.spec.preset
        head_root = self.chain.head_root
        T = types_for(preset)
        out = []
        for pk, vi, subnets in self._managed_committee_members(state):
            sig = self.store.sign_sync_committee_message(
                pk, slot, bytes(head_root), state, preset
            )
            msg = T.SyncCommitteeMessage(
                slot=slot,
                beacon_block_root=bytes(head_root),
                validator_index=vi,
                signature=sig.to_bytes(),
            )
            for subnet in subnets:
                out.append((subnet, msg))
        return out

    def produce_contributions(self, slot: int):
        """[SignedContributionAndProof] from managed aggregators (2/3 slot):
        selection proof → hash-mod gate → pool aggregate → envelope."""
        from ..beacon.sync_committee import is_sync_committee_aggregator
        from ..consensus.containers import types_for

        state = self.chain.head_state()
        preset = self.spec.preset
        head_root = bytes(self.chain.head_root)
        T = types_for(preset)
        out = []
        claimed: set[int] = set()
        for pk, vi, subnets in self._managed_committee_members(state):
            for subnet in subnets:
                if subnet in claimed:
                    continue
                proof = self.store.sign_sync_selection_proof(
                    pk, slot, subnet, state, preset
                )
                if not is_sync_committee_aggregator(proof.to_bytes(), self.spec):
                    continue
                contribution = self.chain.sync_pool.build_contribution(
                    slot, head_root, subnet
                )
                if contribution is None:
                    continue
                claimed.add(subnet)
                msg = T.ContributionAndProof(
                    aggregator_index=vi,
                    contribution=contribution,
                    selection_proof=proof.to_bytes(),
                )
                sig = self.store.sign_contribution_and_proof(
                    pk, msg, state, preset
                )
                out.append(
                    T.SignedContributionAndProof(
                        message=msg, signature=sig.to_bytes()
                    )
                )
        return out


class DoppelgangerService:
    """Liveness gate: refuse signing for the first N epochs after start if
    the validator appears already-active on the network
    (doppelganger_service.rs, 1,463 LoC — this keeps its two load-bearing
    behaviors: the detection-window gate, and BN liveness polling over
    HTTP via the /eth/v1/validator/liveness endpoint)."""

    def __init__(self, detection_epochs: int = 2, client=None,
                 indices: list[int] | None = None):
        self.detection_epochs = detection_epochs
        self.start_epoch: int | None = None
        self.seen_live: set[int] = set()
        self.client = client  # BeaconApiClient (or fallback) for polling
        self.indices = list(indices or [])

    def begin(self, epoch: int) -> None:
        self.start_epoch = epoch

    def observe_liveness(self, validator_index: int) -> None:
        self.seen_live.add(validator_index)

    def poll(self, epoch: int) -> set[int]:
        """One liveness poll against the BN (doppelganger_service.rs
        beacon_node query): any index the CHAIN saw participating during
        our detection window is a doppelganger — we have not signed yet."""
        if self.client is None or not self.indices:
            return set()
        found = set()
        for entry in self.client.validator_liveness(epoch, self.indices):
            if entry.get("is_live"):
                idx = int(entry["index"])
                self.seen_live.add(idx)
                found.add(idx)
        return found

    def signing_enabled(self, validator_index: int, epoch: int) -> bool:
        if self.start_epoch is None:
            return True
        if validator_index in self.seen_live:
            return False  # doppelganger detected: never sign
        return epoch >= self.start_epoch + self.detection_epochs
