"""Fork-boundary state upgrades: base → altair → bellatrix → capella → deneb.

Twin of consensus/state_processing/src/upgrade/{altair,merge,capella,deneb}.rs:
each function consumes the pre-fork state and returns the post-fork container
variant with the new fields initialized per spec.  `process_slots` calls these
at scheduled fork epochs (per_slot_processing.rs's upgrade hook).
"""

from __future__ import annotations

from ..containers import Fork, types_for
from ..spec import ChainSpec
from .forks import state_fork_name


def _common_fields(pre) -> dict:
    """Fields shared by every fork variant, copied by reference."""
    return dict(
        genesis_time=pre.genesis_time,
        genesis_validators_root=bytes(pre.genesis_validators_root),
        slot=pre.slot,
        latest_block_header=pre.latest_block_header,
        block_roots=list(pre.block_roots),
        state_roots=list(pre.state_roots),
        historical_roots=list(pre.historical_roots),
        eth1_data=pre.eth1_data,
        eth1_data_votes=list(pre.eth1_data_votes),
        eth1_deposit_index=pre.eth1_deposit_index,
        validators=list(pre.validators),
        balances=list(pre.balances),
        randao_mixes=list(pre.randao_mixes),
        slashings=list(pre.slashings),
        justification_bits=list(pre.justification_bits),
        previous_justified_checkpoint=pre.previous_justified_checkpoint,
        current_justified_checkpoint=pre.current_justified_checkpoint,
        finalized_checkpoint=pre.finalized_checkpoint,
    )


def _altair_fields(pre) -> dict:
    return dict(
        previous_epoch_participation=list(pre.previous_epoch_participation),
        current_epoch_participation=list(pre.current_epoch_participation),
        inactivity_scores=list(pre.inactivity_scores),
        current_sync_committee=pre.current_sync_committee,
        next_sync_committee=pre.next_sync_committee,
    )


def _fork_field(pre, new_version: bytes, epoch: int) -> Fork:
    return Fork(
        previous_version=bytes(pre.fork.current_version),
        current_version=new_version,
        epoch=epoch,
    )


def translate_participation(post, pending_attestations, spec: ChainSpec) -> None:
    """upgrade/altair.rs translate_participation: replay phase0
    PendingAttestations into previous-epoch participation flags."""
    from ..committees import CommitteeCache
    from .per_block import get_attestation_participation_flags

    preset = spec.preset
    participation = list(post.previous_epoch_participation)
    cache = None
    for pending in pending_attestations:
        data = pending.data
        flags = get_attestation_participation_flags(
            post, data, pending.inclusion_delay, spec
        )
        if cache is None or cache.epoch != data.target.epoch:
            cache = CommitteeCache(post, data.target.epoch, preset)
        committee = cache.committee(data.slot, data.index)
        for i, bit in enumerate(pending.aggregation_bits):
            if bit:
                vi = int(committee[i])
                for f in flags:
                    participation[vi] |= 1 << f
    post.previous_epoch_participation = participation


def upgrade_to_altair(pre, spec: ChainSpec):
    """upgrade/altair.rs:30 upgrade_to_altair."""
    from .per_epoch import compute_sync_committee, get_current_epoch

    preset = spec.preset
    T = types_for(preset)
    epoch = get_current_epoch(pre, preset)
    n = len(pre.validators)
    post = T.BeaconState_BY_FORK["altair"](
        **_common_fields(pre),
        fork=_fork_field(pre, spec.altair_fork_version, epoch),
        previous_epoch_participation=[0] * n,
        current_epoch_participation=[0] * n,
        inactivity_scores=[0] * n,
    )
    translate_participation(post, pre.previous_epoch_attestations, spec)
    committee = compute_sync_committee(post, epoch, spec)
    post.current_sync_committee = committee
    post.next_sync_committee = compute_sync_committee(
        post, epoch + preset.epochs_per_sync_committee_period, spec
    )
    return post


def upgrade_to_bellatrix(pre, spec: ChainSpec):
    """upgrade/merge.rs upgrade_to_bellatrix: default (pre-merge) payload
    header; the real one arrives with the merge transition block."""
    from .per_epoch import get_current_epoch

    T = types_for(spec.preset)
    epoch = get_current_epoch(pre, spec.preset)
    return T.BeaconState_BY_FORK["bellatrix"](
        **_common_fields(pre),
        **_altair_fields(pre),
        fork=_fork_field(pre, spec.bellatrix_fork_version, epoch),
        latest_execution_payload_header=T.ExecutionPayloadHeader(),
    )


def upgrade_to_capella(pre, spec: ChainSpec):
    """upgrade/capella.rs: widen the header (withdrawals_root=0), zero the
    withdrawal sweep cursors, start the historical_summaries list."""
    from .per_epoch import get_current_epoch

    T = types_for(spec.preset)
    epoch = get_current_epoch(pre, spec.preset)
    old = pre.latest_execution_payload_header
    header = T.ExecutionPayloadHeaderCapella(
        **{name: getattr(old, name) for name in type(old)._fields},
        withdrawals_root=bytes(32),
    )
    return T.BeaconState_BY_FORK["capella"](
        **_common_fields(pre),
        **_altair_fields(pre),
        fork=_fork_field(pre, spec.capella_fork_version, epoch),
        latest_execution_payload_header=header,
        next_withdrawal_index=0,
        next_withdrawal_validator_index=0,
        historical_summaries=[],
    )


def upgrade_to_deneb(pre, spec: ChainSpec):
    """upgrade/deneb.rs: widen the header with zeroed blob-gas fields."""
    from .per_epoch import get_current_epoch

    T = types_for(spec.preset)
    epoch = get_current_epoch(pre, spec.preset)
    old = pre.latest_execution_payload_header
    header = T.ExecutionPayloadHeaderDeneb(
        **{name: getattr(old, name) for name in type(old)._fields},
        blob_gas_used=0,
        excess_blob_gas=0,
    )
    return T.BeaconState_BY_FORK["deneb"](
        **_common_fields(pre),
        **_altair_fields(pre),
        fork=_fork_field(pre, spec.deneb_fork_version, epoch),
        latest_execution_payload_header=header,
        next_withdrawal_index=pre.next_withdrawal_index,
        next_withdrawal_validator_index=pre.next_withdrawal_validator_index,
        historical_summaries=list(pre.historical_summaries),
    )


_UPGRADES = {
    "altair": ("base", upgrade_to_altair),
    "bellatrix": ("altair", upgrade_to_bellatrix),
    "capella": ("bellatrix", upgrade_to_capella),
    "deneb": ("capella", upgrade_to_deneb),
}


def upgrade_state_at_epoch(state, epoch: int, spec: ChainSpec):
    """Apply whichever upgrade is scheduled exactly at ``epoch`` (the
    per_slot_processing.rs fork hook).  Returns the (possibly new) state."""
    for fork_name, (from_fork, fn) in _UPGRADES.items():
        scheduled = getattr(spec, f"{fork_name}_fork_epoch")
        if scheduled is not None and scheduled == epoch:
            if state_fork_name(state) == from_fork:
                state = fn(state, spec)
    return state
