"""Per-epoch processing (Altair line) — fully vectorized over the registry.

Twin of consensus/state_processing/src/per_epoch_processing/ (altair path:
justification/finalization, inactivity, rewards/penalties, registry updates,
slashings, the reset/rotation steps, sync committee updates).  The reference
iterates validators; every step here is numpy arithmetic over the
ValidatorArrays columns — the same code shape the jax device path uses for
the ~1M-validator mainnet registry (SURVEY §7.7).

Implements the post-Altair participation-flag semantics (phase0's
PendingAttestation replay only matters for historic sync and is layered on
the same array core later).
"""

from __future__ import annotations

import numpy as np

from ...ops import sha256
from ..containers import Checkpoint
from ..spec import ChainSpec
from .arrays import (
    FAR,
    PARTICIPATION_FLAG_WEIGHTS,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_SOURCE_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
    ValidatorArrays,
)
from .forks import (
    inactivity_penalty_quotient,
    proportional_slashing_multiplier,
    state_fork_name,
)


def _flags(state, which: str, n: int) -> np.ndarray:
    lst = getattr(state, f"{which}_epoch_participation")
    arr = np.zeros(n, dtype=np.uint8)
    arr[: len(lst)] = np.asarray(lst, dtype=np.uint8)[:n]
    return arr


def _scores_array(state, n: int) -> np.ndarray:
    """Inactivity scores zero-padded/clipped to registry length."""
    arr = np.zeros(n, dtype=np.int64)
    lst = state.inactivity_scores
    arr[: min(len(lst), n)] = np.asarray(lst, dtype=np.int64)[:n]
    return arr


def _unslashed_participating(va, flags: np.ndarray, flag_index: int, epoch: int):
    return va.is_active(epoch) & (~va.slashed) & ((flags >> flag_index) & 1 == 1)


def get_current_epoch(state, preset) -> int:
    return state.slot // preset.slots_per_epoch


def process_epoch(state, spec: ChainSpec) -> None:
    """Per-epoch dispatch (per_epoch_processing/mod.rs): base states (the
    PendingAttestation forks) replay attestations; altair-line states use
    participation flags."""
    if hasattr(state, "previous_epoch_attestations"):
        from .per_epoch_phase0 import process_epoch_phase0

        process_epoch_phase0(state, spec)
        return
    process_epoch_altair(state, spec)


def device_pipeline():
    """The device branch's balance pipeline: per_epoch_torch's, on the card.
    It raises without CUDA; it never runs the host steps in its place."""
    from .per_epoch_torch import epoch_balance_pipeline

    return epoch_balance_pipeline


def process_epoch_altair(state, spec: ChainSpec, device: bool | None = None) -> None:
    """The full altair per-epoch pipeline in spec order
    (per_epoch_processing/altair/mod.rs).

    ``device=True`` (or LIGHTHOUSE_TPU_DEVICE_EPOCH=1) runs the card's
    balance pipeline (per_epoch_torch, via device_pipeline()) for the O(n)
    steps — inactivity scores, flag rewards/penalties, slashing penalties,
    effective-balance hysteresis; host code keeps the sequential
    checkpoint/queue/committee steps (SURVEY §7.7 split)."""
    import os

    preset = spec.preset
    va = ValidatorArrays.extract(state)
    n = len(state.validators)
    current = get_current_epoch(state, preset)
    previous = max(current, 1) - 1
    prev_flags = _flags(state, "previous", n)
    curr_flags = _flags(state, "current", n)
    if device is None:
        device = os.environ.get("LIGHTHOUSE_TPU_DEVICE_EPOCH", "") == "1"

    process_justification_and_finalization(
        state, va, prev_flags, curr_flags, current, previous, spec
    )
    fork = state_fork_name(state)
    if device and current > 0:
        epoch_balance_pipeline = device_pipeline()

        scores = _scores_array(state, n)
        balances, new_scores, new_eff = epoch_balance_pipeline(
            va,
            prev_flags,
            scores,
            current,
            previous,
            state.finalized_checkpoint.epoch,
            int(np.asarray(state.slashings, dtype=np.int64).sum()),
            spec,
            multiplier=proportional_slashing_multiplier(fork, preset),
            inactivity_quotient=inactivity_penalty_quotient(fork, preset),
        )
        state.inactivity_scores = [int(s) for s in new_scores]
        va.balances = balances
        process_registry_updates(state, va, current, spec)
        process_eth1_data_reset(state, current, preset)
        va.effective_balance = new_eff
    else:
        process_inactivity_updates(state, va, prev_flags, current, previous, spec)
        process_rewards_and_penalties(
            state, va, prev_flags, current, previous, spec
        )
        process_registry_updates(state, va, current, spec)
        process_slashings(
            state, va, current, spec,
            multiplier=proportional_slashing_multiplier(fork, preset),
        )
        process_eth1_data_reset(state, current, preset)
        process_effective_balance_updates(va, spec)
    process_slashings_reset(state, current, preset)
    process_randao_mixes_reset(state, current, preset)
    process_historical_summaries_update(state, current, preset)
    process_participation_flag_updates(state, n)
    process_sync_committee_updates(state, current, spec)
    va.writeback(state)


# ---------------------------------------------------------------------------


def process_justification_and_finalization(
    state, va: ValidatorArrays, prev_flags, curr_flags, current, previous, spec
):
    """weigh_justification_and_finalization (justification_and_finalization
    mod): k-of-n supermajority target participation moves checkpoints."""
    if current <= 1:  # GENESIS_EPOCH + 1
        return
    preset = spec.preset
    incr = spec.effective_balance_increment
    total = va.total_active_balance(current, incr)
    prev_target = int(
        va.effective_balance[
            _unslashed_participating(va, prev_flags, TIMELY_TARGET_FLAG_INDEX, previous)
        ].sum()
    )
    curr_target = int(
        va.effective_balance[
            _unslashed_participating(va, curr_flags, TIMELY_TARGET_FLAG_INDEX, current)
        ].sum()
    )

    process_justification_with_balances(
        state, total, prev_target, curr_target, current, previous, preset
    )


def process_justification_with_balances(
    state, total, prev_target, curr_target, current, previous, preset
):
    """The fork-independent checkpoint math both pipelines share
    (weigh_justification_and_finalization)."""
    old_prev = state.previous_justified_checkpoint
    old_curr = state.current_justified_checkpoint
    bits = list(state.justification_bits)
    bits = [False] + bits[:3]
    state.previous_justified_checkpoint = old_curr
    if prev_target * 3 >= total * 2:
        root = _block_root_at_epoch(state, previous, preset)
        state.current_justified_checkpoint = Checkpoint(epoch=previous, root=root)
        bits[1] = True
    if curr_target * 3 >= total * 2:
        root = _block_root_at_epoch(state, current, preset)
        state.current_justified_checkpoint = Checkpoint(epoch=current, root=root)
        bits[0] = True
    state.justification_bits = bits

    # finalization rules (the 2nd/3rd/4th-most-recent-epoch cases)
    if all(bits[1:4]) and old_prev.epoch + 3 == current:
        state.finalized_checkpoint = old_prev
    if all(bits[1:3]) and old_prev.epoch + 2 == current:
        state.finalized_checkpoint = old_prev
    if all(bits[0:3]) and old_curr.epoch + 2 == current:
        state.finalized_checkpoint = old_curr
    if all(bits[0:2]) and old_curr.epoch + 1 == current:
        state.finalized_checkpoint = old_curr


def _block_root_at_epoch(state, epoch: int, preset) -> bytes:
    slot = epoch * preset.slots_per_epoch
    return bytes(state.block_roots[slot % preset.slots_per_historical_root])


def process_inactivity_updates(state, va, prev_flags, current, previous, spec):
    """altair/inactivity_updates.rs: score drift under non-finality."""
    if current == 0:
        return
    preset = spec.preset
    n = len(state.validators)
    scores = _scores_array(state, n)
    eligible = va.is_eligible(previous)
    target_ok = _unslashed_participating(
        va, prev_flags, TIMELY_TARGET_FLAG_INDEX, previous
    )
    # spec: participants decay by 1; non-participants gain the bias
    # UNCONDITIONALLY; the recovery rate then applies (to the mid-update
    # score) only when not in a leak.
    scores = np.where(eligible & target_ok, scores - np.minimum(1, scores), scores)
    scores = np.where(
        eligible & ~target_ok, scores + preset.inactivity_score_bias, scores
    )
    if not _is_in_inactivity_leak(state, current, preset):
        scores = np.where(
            eligible,
            scores - np.minimum(preset.inactivity_score_recovery_rate, scores),
            scores,
        )
    state.inactivity_scores = [int(s) for s in scores]


def _is_in_inactivity_leak(state, current: int, preset) -> bool:
    finality_delay = max(current, 1) - 1 - state.finalized_checkpoint.epoch
    return finality_delay > preset.min_epochs_to_inactivity_penalty


def process_rewards_and_penalties(state, va, prev_flags, current, previous, spec):
    """altair/rewards_and_penalties.rs: flag rewards + inactivity penalties,
    one vectorized pass per flag."""
    if current == 0:
        return
    preset = spec.preset
    import math

    incr = spec.effective_balance_increment
    total = va.total_active_balance(current, incr)
    total_incr = total // incr
    base_reward_per_increment = (
        incr * preset.base_reward_factor // math.isqrt(total)
    )
    eb_incr = va.effective_balance // incr
    base_reward = eb_incr * base_reward_per_increment
    eligible = va.is_eligible(previous)
    in_leak = _is_in_inactivity_leak(state, current, preset)

    delta = np.zeros(len(base_reward), dtype=np.int64)
    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        participated = _unslashed_participating(
            va, prev_flags, flag_index, previous
        )
        unslashed_incr = int(eb_incr[participated].sum())
        reward_num = base_reward * weight * unslashed_incr
        rewards = reward_num // (total_incr * WEIGHT_DENOMINATOR)
        if flag_index != TIMELY_HEAD_FLAG_INDEX:
            penalties = base_reward * weight // WEIGHT_DENOMINATOR
        else:
            penalties = np.zeros_like(base_reward)
        if in_leak:
            rewards = np.zeros_like(rewards)
        delta += np.where(eligible & participated, rewards, 0)
        delta -= np.where(eligible & ~participated, penalties, 0)

    # inactivity penalties (altair: score-scaled quadratic leak; the
    # quotient drops 3·2^24 → 2^24 at bellatrix, chain_spec.rs)
    scores = _scores_array(state, len(delta))
    target_ok = _unslashed_participating(
        va, prev_flags, TIMELY_TARGET_FLAG_INDEX, previous
    )
    penalty_den = preset.inactivity_score_bias * inactivity_penalty_quotient(
        state_fork_name(state), preset
    )
    inactivity_pen = (va.effective_balance * scores) // penalty_den
    delta -= np.where(eligible & ~target_ok, inactivity_pen, 0)

    va.balances = np.maximum(va.balances + delta, 0)


def process_registry_updates(state, va, current, spec, activation_cap: bool = True):
    """registry_updates.rs: eligibility, ejection, churn-limited activation.
    ``activation_cap`` applies the deneb EIP-7514 cap (off on the phase0
    path)."""
    preset = spec.preset
    # eligibility
    newly_eligible = (va.activation_eligibility_epoch == FAR) & (
        va.effective_balance == spec.max_effective_balance
    )
    va.activation_eligibility_epoch = np.where(
        newly_eligible, np.int64(current + 1), va.activation_eligibility_epoch
    )
    # ejection
    to_eject = (
        va.is_active(current)
        & (va.effective_balance <= spec.ejection_balance)
        & (va.exit_epoch == FAR)
    )
    for i in np.nonzero(to_eject)[0]:
        _initiate_exit(va, int(i), current, spec)
    # activation queue: eligible, not past finalized eligibility
    finalized = state.finalized_checkpoint.epoch
    queue_mask = (
        (va.activation_epoch == FAR)
        & (va.activation_eligibility_epoch != FAR)
        & (va.activation_eligibility_epoch <= finalized)
    )
    queue = np.nonzero(queue_mask)[0]
    order = np.lexsort((queue, va.activation_eligibility_epoch[queue]))
    churn = (
        _activation_churn_limit(va, current, spec)
        if activation_cap
        else _churn_limit(va, current, spec)
    )
    delay_epoch = _activation_exit_epoch(current, preset)
    for i in queue[order][:churn]:
        va.activation_epoch[i] = delay_epoch


def _activation_exit_epoch(epoch: int, preset) -> int:
    return epoch + 1 + preset.max_seed_lookahead


def _churn_limit(va, epoch: int, spec) -> int:
    active = int(va.is_active(epoch).sum())
    return max(spec.min_per_epoch_churn_limit, active // spec.churn_limit_quotient)


def _activation_churn_limit(va, epoch: int, spec) -> int:
    # deneb caps activation churn (EIP-7514)
    return min(spec.max_per_epoch_activation_churn_limit, _churn_limit(va, epoch, spec))


def _initiate_exit(va, index: int, current: int, spec) -> None:
    """initiate_validator_exit: pick the churn-limited exit epoch."""
    if va.exit_epoch[index] != FAR:
        return
    delay = _activation_exit_epoch(current, spec.preset)
    exiting = va.exit_epoch[va.exit_epoch != FAR]
    exit_epoch = max(int(exiting.max()) if len(exiting) else 0, delay)
    while int((va.exit_epoch == exit_epoch).sum()) >= _churn_limit(va, current, spec):
        exit_epoch += 1
    va.exit_epoch[index] = exit_epoch
    va.withdrawable_epoch[index] = (
        exit_epoch + spec.min_validator_withdrawability_delay
    )


def process_slashings(state, va, current, spec, multiplier: int = 2):
    """slashings.rs: proportional penalty at the halfway point.
    ``multiplier`` IS the full proportional multiplier relative to the
    preset base: phase0 1, altair 2, bellatrix+ 3 (forks.py)."""
    preset = spec.preset
    epoch_to_penalize = current + preset.epochs_per_slashings_vector // 2
    targeted = va.slashed & (va.withdrawable_epoch == epoch_to_penalize)
    if not targeted.any():
        return
    incr = spec.effective_balance_increment
    total = va.total_active_balance(current, incr)
    mult = preset.proportional_slashing_multiplier * multiplier
    total_slashings = int(np.asarray(state.slashings, dtype=np.int64).sum())
    adj = min(total_slashings * mult, total)
    # spec: penalty_numerator = eb // incr * adj; penalty = num // total * incr
    penalty = (va.effective_balance // incr) * adj // total * incr
    va.balances = np.where(
        targeted, np.maximum(va.balances - penalty, 0), va.balances
    )


def process_eth1_data_reset(state, current, preset):
    if (current + 1) % preset.epochs_per_eth1_voting_period == 0:
        state.eth1_data_votes = []


def process_effective_balance_updates(va, spec):
    """effective_balance_updates.rs: hysteresis re-targeting."""
    incr = spec.effective_balance_increment
    hysteresis = incr // 4  # HYSTERESIS_QUOTIENT
    down = va.balances + hysteresis * 1 < va.effective_balance  # DOWNWARD x1
    up = va.effective_balance + hysteresis * 5 < va.balances  # UPWARD x5
    new_eb = np.minimum(
        va.balances - va.balances % incr, spec.max_effective_balance
    )
    va.effective_balance = np.where(down | up, new_eb, va.effective_balance)


def process_slashings_reset(state, current, preset):
    idx = (current + 1) % preset.epochs_per_slashings_vector
    s = list(state.slashings)
    s[idx] = 0
    state.slashings = s


def process_randao_mixes_reset(state, current, preset):
    idx = (current + 1) % preset.epochs_per_historical_vector
    mixes = list(state.randao_mixes)
    mixes[idx] = mixes[current % preset.epochs_per_historical_vector]
    state.randao_mixes = mixes


def process_historical_summaries_update(state, current, preset):
    """capella historical_summaries (falls back to historical_roots batch on
    pre-capella states that lack the field)."""
    next_epoch = current + 1
    period = preset.slots_per_historical_root // preset.slots_per_epoch
    if next_epoch % period != 0:
        return
    from ..containers import Root, types_for
    from ..ssz import Vector

    if hasattr(state, "historical_summaries"):
        from ..containers import HistoricalSummary

        roots_t = Vector(Root, preset.slots_per_historical_root)
        state.historical_summaries = list(state.historical_summaries) + [
            HistoricalSummary(
                block_summary_root=roots_t.hash_tree_root(state.block_roots),
                state_summary_root=roots_t.hash_tree_root(state.state_roots),
            )
        ]
    else:
        fam = types_for(preset)
        batch = fam.HistoricalBatch(
            block_roots=list(state.block_roots),
            state_roots=list(state.state_roots),
        )
        state.historical_roots = list(state.historical_roots) + [batch.root()]


def process_participation_flag_updates(state, n: int):
    state.previous_epoch_participation = list(state.current_epoch_participation)
    state.current_epoch_participation = [0] * n


def process_sync_committee_updates(state, current, spec):
    preset = spec.preset
    if (current + 1) % preset.epochs_per_sync_committee_period != 0:
        return
    state.current_sync_committee = state.next_sync_committee
    state.next_sync_committee = compute_sync_committee(
        state, current + 1 + preset.epochs_per_sync_committee_period, spec
    )


def compute_sync_committee(state, epoch: int, spec: ChainSpec):
    """get_next_sync_committee: effective-balance-weighted sampling."""
    from ..committees import get_active_validator_indices, get_seed
    from ..shuffle import compute_shuffled_index
    from ..spec import DOMAIN_SYNC_COMMITTEE
    from ...crypto.bls import api as bls

    preset = spec.preset
    indices = get_active_validator_indices(state, epoch)
    seed = get_seed(state, epoch, DOMAIN_SYNC_COMMITTEE, preset)
    total = len(indices)
    picked = []
    i = 0
    MAX_RANDOM_BYTE = 255
    while len(picked) < preset.sync_committee_size:
        shuffled = compute_shuffled_index(
            i % total, total, seed, preset.shuffle_round_count
        )
        candidate = int(indices[shuffled])
        random_byte = sha256(seed + (i // 32).to_bytes(8, "little"))[i % 32]
        eb = state.validators[candidate].effective_balance
        if eb * MAX_RANDOM_BYTE >= spec.max_effective_balance * random_byte:
            picked.append(candidate)
        i += 1
    fam_pubkeys = [bytes(state.validators[v].pubkey) for v in picked]
    agg = bls.AggregatePublicKey.aggregate(
        [bls.PublicKey.from_bytes(pk) for pk in fam_pubkeys]
    )
    from ...crypto.bls.curve import g1_to_bytes
    from ..containers import types_for

    T = types_for(preset)
    return T.SyncCommittee(
        pubkeys=fam_pubkeys,
        aggregate_pubkey=g1_to_bytes(agg.point),
    )
