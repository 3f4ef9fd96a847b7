"""Signature-set constructors: the exact (pubkey, message, signature) tuples
the device kernel consumes.

Twin of consensus/state_processing/src/per_block_processing/
signature_sets.rs:56-610 — one constructor per consensus message kind, each
computing the spec domain and signing root and resolving validator pubkeys
through a caller-supplied ``get_pubkey`` (the ValidatorPubkeyCache closure of
block_verification.rs:1258). Errors are raised as :class:`SignatureSetError`
(the `Error` enum of signature_sets.rs:24-43): an unknown validator index or
an undecodable signature is a *structural* failure distinct from "signature
invalid", because batch verification must not silently drop sets.
"""

from __future__ import annotations

from typing import Callable

from ...crypto.bls.api import PublicKey, Signature, SignatureSet
from .. import spec as S
from ..containers import (
    AggregateAndProof,
    DepositMessage,
    SigningData,
    VoluntaryExit,
)

GetPubkey = Callable[[int], "PublicKey | None"]


class SignatureSetError(Exception):
    """Structural failure building a set (signature_sets.rs:24-43)."""


def _pubkey(get_pubkey: GetPubkey, index: int) -> PublicKey:
    pk = get_pubkey(index)
    if pk is None:
        raise SignatureSetError(f"validator {index} unknown in state")
    return pk


def _sig(sig_bytes_or_obj) -> Signature:
    if isinstance(sig_bytes_or_obj, Signature):
        return sig_bytes_or_obj
    try:
        return Signature.from_bytes(bytes(sig_bytes_or_obj))
    except Exception as e:  # decompression failure
        raise SignatureSetError(f"invalid signature encoding: {e}") from None


def get_domain(
    fork,
    genesis_validators_root: bytes,
    domain_type: bytes,
    epoch: int,
) -> bytes:
    """Spec get_domain: pick the fork version active at ``epoch``."""
    version = (
        fork.previous_version if epoch < fork.epoch else fork.current_version
    )
    return S.compute_domain(domain_type, version, genesis_validators_root)


def _signing_root(obj, domain: bytes) -> bytes:
    return SigningData(object_root=obj.root(), domain=domain).root()


def _epoch_at(slot: int, preset) -> int:
    return slot // preset.slots_per_epoch


# ---------------------------------------------------------------------------
# Constructors (one per message kind, signature_sets.rs order)
# ---------------------------------------------------------------------------


def block_proposal_signature_set(
    state,
    get_pubkey: GetPubkey,
    signed_block,
    preset,
    block_root: bytes | None = None,
    verified_proposer_index: int | None = None,
) -> SignatureSet:
    """signature_sets.rs:109 block_proposal_signature_set."""
    block = signed_block.message
    proposer_index = (
        verified_proposer_index
        if verified_proposer_index is not None
        else block.proposer_index
    )
    domain = get_domain(
        state.fork,
        state.genesis_validators_root,
        S.DOMAIN_BEACON_PROPOSER,
        _epoch_at(block.slot, preset),
    )
    if block_root is None:
        block_root = block.root()
    message = SigningData(object_root=block_root, domain=domain).root()
    return SignatureSet(
        _sig(signed_block.signature),
        [_pubkey(get_pubkey, proposer_index)],
        message,
    )


def block_header_signature_set(
    state, get_pubkey: GetPubkey, signed_header, preset
) -> SignatureSet:
    """Proposer-slashing header sets (signature_sets.rs:186)."""
    header = signed_header.message
    domain = get_domain(
        state.fork,
        state.genesis_validators_root,
        S.DOMAIN_BEACON_PROPOSER,
        _epoch_at(header.slot, preset),
    )
    message = _signing_root(header, domain)
    return SignatureSet(
        _sig(signed_header.signature),
        [_pubkey(get_pubkey, header.proposer_index)],
        message,
    )


def randao_signature_set(
    state, get_pubkey: GetPubkey, block, preset, verified_proposer_index=None
) -> SignatureSet:
    """signature_sets.rs:157 randao_signature_set: message is the EPOCH's
    hash_tree_root, domain DOMAIN_RANDAO."""
    from ..ssz import U64

    epoch = _epoch_at(block.slot, preset)
    proposer_index = (
        verified_proposer_index
        if verified_proposer_index is not None
        else block.proposer_index
    )
    domain = get_domain(
        state.fork, state.genesis_validators_root, S.DOMAIN_RANDAO, epoch
    )
    epoch_root = U64.hash_tree_root(epoch)
    message = SigningData(object_root=epoch_root, domain=domain).root()
    return SignatureSet(
        _sig(block.body.randao_reveal),
        [_pubkey(get_pubkey, proposer_index)],
        message,
    )


def proposer_slashing_signature_set(
    state, get_pubkey: GetPubkey, proposer_slashing, preset
) -> tuple[SignatureSet, SignatureSet]:
    """signature_sets.rs:186-215: two header sets per slashing."""
    return (
        block_header_signature_set(
            state, get_pubkey, proposer_slashing.signed_header_1, preset
        ),
        block_header_signature_set(
            state, get_pubkey, proposer_slashing.signed_header_2, preset
        ),
    )


def indexed_attestation_signature_set(
    state, get_pubkey: GetPubkey, indexed_attestation, preset,
    signature=None,
) -> SignatureSet:
    """signature_sets.rs:235 indexed_attestation_signature_set: aggregate
    pubkey over attesting indices, message = AttestationData signing root at
    DOMAIN_BEACON_ATTESTER of the target epoch."""
    pubkeys = [
        _pubkey(get_pubkey, int(i))
        for i in indexed_attestation.attesting_indices
    ]
    domain = get_domain(
        state.fork,
        state.genesis_validators_root,
        S.DOMAIN_BEACON_ATTESTER,
        indexed_attestation.data.target.epoch,
    )
    message = _signing_root(indexed_attestation.data, domain)
    sig = signature if signature is not None else indexed_attestation.signature
    return SignatureSet(_sig(sig), pubkeys, message)


def attester_slashing_signature_sets(
    state, get_pubkey: GetPubkey, attester_slashing, preset
) -> tuple[SignatureSet, SignatureSet]:
    """signature_sets.rs:292: both indexed attestations of a slashing."""
    return (
        indexed_attestation_signature_set(
            state, get_pubkey, attester_slashing.attestation_1, preset
        ),
        indexed_attestation_signature_set(
            state, get_pubkey, attester_slashing.attestation_2, preset
        ),
    )


def deposit_pubkey_signature_message(
    deposit_data, spec: S.ChainSpec
) -> tuple[bytes, bytes, bytes]:
    """signature_sets.rs:322 deposit_pubkey_signature_message: deposits are
    signed over DepositMessage with compute_domain (NO fork — valid across
    forks), and are NOT verified against the state's validator set."""
    message = DepositMessage(
        pubkey=deposit_data.pubkey,
        withdrawal_credentials=deposit_data.withdrawal_credentials,
        amount=deposit_data.amount,
    )
    domain = S.compute_domain(S.DOMAIN_DEPOSIT, spec.genesis_fork_version, bytes(32))
    signing_root = _signing_root(message, domain)
    return deposit_data.pubkey, deposit_data.signature, signing_root


def deposit_signature_set(deposit_data, spec: S.ChainSpec) -> SignatureSet:
    pk_bytes, sig_bytes, signing_root = deposit_pubkey_signature_message(
        deposit_data, spec
    )
    try:
        pk = PublicKey.from_bytes(bytes(pk_bytes))
    except Exception as e:
        raise SignatureSetError(f"invalid deposit pubkey: {e}") from None
    return SignatureSet(_sig(sig_bytes), [pk], signing_root)


def exit_signature_set(
    state, get_pubkey: GetPubkey, signed_exit, spec: S.ChainSpec
) -> SignatureSet:
    """signature_sets.rs:370 exit_signature_set. Post-Deneb, exits are
    locked to the CAPELLA fork domain (EIP-7044 stable exits)."""
    exit_msg: VoluntaryExit = signed_exit.message
    preset = spec.preset
    if (
        spec.deneb_fork_epoch is not None
        and state.slot // preset.slots_per_epoch >= spec.deneb_fork_epoch
    ):
        domain = S.compute_domain(
            S.DOMAIN_VOLUNTARY_EXIT,
            spec.capella_fork_version,
            state.genesis_validators_root,
        )
    else:
        domain = get_domain(
            state.fork,
            state.genesis_validators_root,
            S.DOMAIN_VOLUNTARY_EXIT,
            exit_msg.epoch,
        )
    message = _signing_root(exit_msg, domain)
    return SignatureSet(
        _sig(signed_exit.signature),
        [_pubkey(get_pubkey, exit_msg.validator_index)],
        message,
    )


def selection_proof_signature_set(
    state, get_pubkey: GetPubkey, validator_index: int, slot: int,
    selection_proof, preset,
) -> SignatureSet:
    """signature_sets.rs:407 signed_aggregate_selection_proof_signature_set:
    the aggregator proves selection by signing the SLOT."""
    from ..ssz import U64

    domain = get_domain(
        state.fork,
        state.genesis_validators_root,
        S.DOMAIN_SELECTION_PROOF,
        _epoch_at(slot, preset),
    )
    slot_root = U64.hash_tree_root(slot)
    message = SigningData(object_root=slot_root, domain=domain).root()
    return SignatureSet(
        _sig(selection_proof), [_pubkey(get_pubkey, validator_index)], message
    )


def aggregate_and_proof_signature_set(
    state, get_pubkey: GetPubkey, signed_aggregate, preset
) -> SignatureSet:
    """signature_sets.rs:442 signed_aggregate_signature_set: the outer
    signature over the AggregateAndProof container."""
    msg: AggregateAndProof = signed_aggregate.message
    domain = get_domain(
        state.fork,
        state.genesis_validators_root,
        S.DOMAIN_AGGREGATE_AND_PROOF,
        _epoch_at(msg.aggregate.data.slot, preset),
    )
    message = _signing_root(msg, domain)
    return SignatureSet(
        _sig(signed_aggregate.signature),
        [_pubkey(get_pubkey, msg.aggregator_index)],
        message,
    )


def sync_aggregate_signature_set(
    state,
    get_pubkey: GetPubkey,
    sync_aggregate,
    participant_indices: list[int],
    slot: int,
    block_root: bytes,
    preset,
) -> SignatureSet | None:
    """signature_sets.rs:553 sync_aggregate_signature_set: participants sign
    the PREVIOUS slot's block root at DOMAIN_SYNC_COMMITTEE.  Returns None
    when there are no participants and the signature is the infinity point
    (valid empty aggregate)."""
    sig = _sig(sync_aggregate.sync_committee_signature)
    if not participant_indices:
        if sig.is_infinity():
            return None
        raise SignatureSetError("non-infinity signature with no participants")
    previous_slot = max(slot, 1) - 1
    domain = get_domain(
        state.fork,
        state.genesis_validators_root,
        S.DOMAIN_SYNC_COMMITTEE,
        _epoch_at(previous_slot, preset),
    )
    from ..ssz import ByteVector

    root_obj_root = ByteVector(32).hash_tree_root(block_root)
    message = SigningData(object_root=root_obj_root, domain=domain).root()
    pubkeys = [_pubkey(get_pubkey, i) for i in participant_indices]
    return SignatureSet(sig, pubkeys, message)


def sync_committee_message_signature_set(
    state, get_pubkey: GetPubkey, validator_index: int, slot: int,
    block_root: bytes, signature, preset,
) -> SignatureSet:
    """signature_sets.rs:462 sync_committee_message_set: one validator
    signing the head block root at DOMAIN_SYNC_COMMITTEE."""
    from ..ssz import ByteVector

    domain = get_domain(
        state.fork,
        state.genesis_validators_root,
        S.DOMAIN_SYNC_COMMITTEE,
        _epoch_at(slot, preset),
    )
    root_obj = ByteVector(32).hash_tree_root(block_root)
    message = SigningData(object_root=root_obj, domain=domain).root()
    return SignatureSet(
        _sig(signature), [_pubkey(get_pubkey, validator_index)], message
    )


def sync_selection_proof_signature_set(
    state, get_pubkey: GetPubkey, aggregator_index: int, slot: int,
    subcommittee_index: int, selection_proof, preset,
) -> SignatureSet:
    """signature_sets.rs:500 signed_sync_aggregate_selection_proof: the
    aggregator signs SyncAggregatorSelectionData(slot, subcommittee)."""
    from ..containers import SyncAggregatorSelectionData

    data = SyncAggregatorSelectionData(
        slot=slot, subcommittee_index=subcommittee_index
    )
    domain = get_domain(
        state.fork,
        state.genesis_validators_root,
        S.DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
        _epoch_at(slot, preset),
    )
    message = _signing_root(data, domain)
    return SignatureSet(
        _sig(selection_proof), [_pubkey(get_pubkey, aggregator_index)], message
    )


def contribution_and_proof_signature_set(
    state, get_pubkey: GetPubkey, signed_contribution, preset
) -> SignatureSet:
    """signature_sets.rs:529 signed_sync_contribution_and_proof: the outer
    envelope over ContributionAndProof."""
    msg = signed_contribution.message
    domain = get_domain(
        state.fork,
        state.genesis_validators_root,
        S.DOMAIN_CONTRIBUTION_AND_PROOF,
        _epoch_at(msg.contribution.slot, preset),
    )
    message = _signing_root(msg, domain)
    return SignatureSet(
        _sig(signed_contribution.signature),
        [_pubkey(get_pubkey, msg.aggregator_index)],
        message,
    )


def sync_contribution_signature_set(
    state, contribution, participant_pubkeys: list, preset
) -> SignatureSet:
    """signature_sets.rs:553-ish contribution body set: the aggregate of
    the subcommittee participants over the beacon block root."""
    from ..ssz import ByteVector

    domain = get_domain(
        state.fork,
        state.genesis_validators_root,
        S.DOMAIN_SYNC_COMMITTEE,
        _epoch_at(contribution.slot, preset),
    )
    root_obj = ByteVector(32).hash_tree_root(
        bytes(contribution.beacon_block_root)
    )
    message = SigningData(object_root=root_obj, domain=domain).root()
    if not participant_pubkeys:
        raise SignatureSetError("contribution with no participants")
    return SignatureSet(
        _sig(contribution.signature), participant_pubkeys, message
    )


def bls_execution_change_signature_set(
    state, signed_change, spec: S.ChainSpec
) -> SignatureSet:
    """signature_sets.rs:580 bls_execution_change_signature_set: signed with
    the GENESIS fork version (valid across forks) by the withdrawal BLS key
    itself (not a validator's signing key)."""
    domain = S.compute_domain(
        S.DOMAIN_BLS_TO_EXECUTION_CHANGE,
        spec.genesis_fork_version,
        state.genesis_validators_root,
    )
    message = _signing_root(signed_change.message, domain)
    try:
        pk = PublicKey.from_bytes(bytes(signed_change.message.from_bls_pubkey))
    except Exception as e:
        raise SignatureSetError(f"invalid withdrawal pubkey: {e}") from None
    return SignatureSet(_sig(signed_change.signature), [pk], message)
