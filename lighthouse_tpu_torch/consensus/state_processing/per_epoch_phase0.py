"""Phase0 per-epoch processing — the PendingAttestation replay path.

Twin of consensus/state_processing/src/per_epoch_processing/base/ (the
pre-Altair pipeline Lighthouse keeps for historic sync): justification
from attesting balances, the five-component reward/penalty calculus
(source/target/head + inclusion delay + inactivity), and the final
updates that rotate ``previous/current_epoch_attestations``.

Participation is reconstructed by replaying each PendingAttestation's
aggregation bits against the epoch's committees (the reference caches
this as `ParticipationCache`/`ValidatorStatuses` — here it lands in flat
numpy masks over the registry, the same dense-array shape the altair
path and the device use)."""

from __future__ import annotations

import math

import numpy as np

from ..committees import CommitteeCache
from ..spec import ChainSpec
from .arrays import ValidatorArrays
from .per_epoch import (
    _block_root_at_epoch,
    _is_in_inactivity_leak,
    process_eth1_data_reset,
    process_effective_balance_updates,
    process_historical_summaries_update,
    process_justification_with_balances,
    process_randao_mixes_reset,
    process_registry_updates,
    process_slashings,
    process_slashings_reset,
)

BASE_REWARDS_PER_EPOCH = 4


class EpochAttestations:
    """Flat masks + per-validator inclusion info for one epoch's pending
    attestations (ValidatorStatuses analog, base/validator_statuses.rs)."""

    def __init__(self, state, epoch: int, attestations, preset):
        n = len(state.validators)
        self.source = np.zeros(n, dtype=bool)
        self.target = np.zeros(n, dtype=bool)
        self.head = np.zeros(n, dtype=bool)
        self.inclusion_delay = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
        self.inclusion_proposer = np.full(n, -1, dtype=np.int64)
        if not attestations:
            return
        cache = CommitteeCache(state, epoch, preset)
        target_root = _block_root_at_epoch(state, epoch, preset)
        shr = preset.slots_per_historical_root
        for att in attestations:
            committee = cache.committee(att.data.slot, att.data.index)
            bits = att.aggregation_bits
            members = np.asarray(
                [int(committee[i]) for i in range(len(committee)) if bits[i]],
                dtype=np.int64,
            )
            if members.size == 0:
                continue
            # every pending attestation matched source at block processing
            self.source[members] = True
            delay = int(att.inclusion_delay)
            better = delay < self.inclusion_delay[members]
            upd = members[better]
            self.inclusion_delay[upd] = delay
            self.inclusion_proposer[upd] = int(att.proposer_index)
            if bytes(att.data.target.root) == target_root:
                self.target[members] = True
                head_root = bytes(
                    state.block_roots[att.data.slot % shr]
                )
                if bytes(att.data.beacon_block_root) == head_root:
                    self.head[members] = True

    def unslashed(self, mask: np.ndarray, va: ValidatorArrays) -> np.ndarray:
        return mask & ~va.slashed


def process_epoch_phase0(state, spec: ChainSpec) -> None:
    """The full phase0 pipeline in spec order (base/mod.rs)."""
    preset = spec.preset
    va = ValidatorArrays.extract(state)
    current = state.slot // preset.slots_per_epoch
    previous = max(current, 1) - 1
    prev_atts = EpochAttestations(
        state, previous, list(state.previous_epoch_attestations), preset
    )
    curr_atts = EpochAttestations(
        state, current, list(state.current_epoch_attestations), preset
    )

    incr = spec.effective_balance_increment
    total = va.total_active_balance(current, incr)
    prev_target_bal = int(
        va.effective_balance[prev_atts.unslashed(prev_atts.target, va)].sum()
    )
    curr_target_bal = int(
        va.effective_balance[curr_atts.unslashed(curr_atts.target, va)].sum()
    )
    if current > 1:  # GENESIS_EPOCH + 1: checkpoints cannot move yet
        process_justification_with_balances(
            state, total, prev_target_bal, curr_target_bal, current, previous, preset
        )
    process_rewards_and_penalties_phase0(
        state, va, prev_atts, current, previous, spec
    )
    process_registry_updates(state, va, current, spec, activation_cap=False)
    process_slashings(state, va, current, spec, multiplier=1)
    # final updates (base/final_updates.rs order)
    process_eth1_data_reset(state, current, preset)
    process_effective_balance_updates(va, spec)
    process_slashings_reset(state, current, preset)
    process_randao_mixes_reset(state, current, preset)
    process_historical_summaries_update(state, current, preset)
    state.previous_epoch_attestations = list(state.current_epoch_attestations)
    state.current_epoch_attestations = []
    va.writeback(state)


def process_rewards_and_penalties_phase0(
    state, va: ValidatorArrays, prev_atts: EpochAttestations, current, previous, spec
):
    """base/rewards_and_penalties.rs: the five deltas, vectorized."""
    if current == 0:
        return
    preset = spec.preset
    incr = spec.effective_balance_increment
    total = va.total_active_balance(current, incr)
    total_incr = total // incr
    base_reward = (
        va.effective_balance
        * preset.base_reward_factor
        // math.isqrt(total)
        // BASE_REWARDS_PER_EPOCH
    )
    proposer_reward = base_reward // preset.proposer_reward_quotient
    eligible = va.is_eligible(previous)
    in_leak = _is_in_inactivity_leak(state, current, preset)
    delta = np.zeros(len(base_reward), dtype=np.int64)

    # source / target / head component deltas
    for mask in (prev_atts.source, prev_atts.target, prev_atts.head):
        unslashed = prev_atts.unslashed(mask, va)
        attesting_incr = int(va.effective_balance[unslashed].sum()) // incr
        if in_leak:
            # attesters "break even": full base reward regardless of weight
            rewards = base_reward
        else:
            rewards = base_reward * attesting_incr // total_incr
        delta += np.where(eligible & unslashed, rewards, 0)
        delta -= np.where(eligible & ~unslashed, base_reward, 0)

    # inclusion-delay rewards (never penalties)
    src_unslashed = prev_atts.unslashed(prev_atts.source, va)
    max_attester = base_reward - proposer_reward
    delays = np.maximum(prev_atts.inclusion_delay, 1)
    delta += np.where(src_unslashed, max_attester // delays, 0)
    # matching proposers collect per included attester
    proposers = prev_atts.inclusion_proposer[src_unslashed]
    rewards_for_proposer = proposer_reward[src_unslashed]
    np.add.at(delta, proposers[proposers >= 0],
              rewards_for_proposer[proposers >= 0])

    # inactivity penalties under leak
    if in_leak:
        finality_delay = previous - state.finalized_checkpoint.epoch
        delta -= np.where(
            eligible, BASE_REWARDS_PER_EPOCH * base_reward - proposer_reward, 0
        )
        tgt_unslashed = prev_atts.unslashed(prev_atts.target, va)
        leak_pen = (
            va.effective_balance * finality_delay
            // preset.inactivity_penalty_quotient
        )
        delta -= np.where(eligible & ~tgt_unslashed, leak_pen, 0)

    va.balances = np.maximum(va.balances + delta, 0)


__all__ = [
    "EpochAttestations",
    "process_epoch_phase0",
    "process_rewards_and_penalties_phase0",
]
