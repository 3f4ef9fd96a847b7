"""Per-epoch balance processing on the card, over int64 validator columns.

Port of the JAX package's ``consensus/state_processing/per_epoch_jax.py``.
Per-epoch processing over ~1M validators is a dense, embarrassingly
parallel array workload (the reference client walks ``Vec<Validator>`` in
per_epoch_processing/altair/*.rs).  The balance-moving steps (inactivity
score drift, the three participation-flag reward components,
inactivity-leak penalties, slashing penalties and effective-balance
hysteresis) run as one program over int64 columns:

    new_balances, new_scores, new_eff = epoch_kernel(cols..., scalars..., **static)

What is sequential or tiny (justification, churn-limited queues,
sync-committee sampling) stays on the host.  The reference has no Pallas
kernel here (XLA fuses its elementwise int64 ops), so the port is plain
PyTorch on the card: no kernel is written by hand for it.  Division is floor
division and every operand is nonnegative where it divides, as in the
reference; torch needs no x64 flag.

Padding contract: lanes padded with ``effective_balance == 0`` and inactive
epochs get zero deltas, keep their scores and keep their effective balance.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .arrays import (
    PARTICIPATION_FLAG_WEIGHTS,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
    ValidatorArrays,
)


@dataclass(frozen=True)
class EpochPreset:
    """The preset fields the pipeline reads, at the mainnet preset's values
    (the JAX package's consensus/spec.py ``Preset`` and ``MAINNET``; the
    phase0 values of the two fork-dependent quotients, which the callers
    scale by fork through ``multiplier`` and ``inactivity_quotient``)."""

    slots_per_epoch: int = 32
    min_epochs_to_inactivity_penalty: int = 4
    epochs_per_slashings_vector: int = 8192
    base_reward_factor: int = 64
    inactivity_penalty_quotient: int = 2**26
    proportional_slashing_multiplier: int = 1
    inactivity_score_bias: int = 4
    inactivity_score_recovery_rate: int = 16


@dataclass(frozen=True)
class EpochSpec:
    """The chain-spec fields the pipeline reads (``spec.preset`` and the two
    gwei values), shaped like the JAX package's ``ChainSpec``."""

    preset: EpochPreset = field(default_factory=EpochPreset)
    effective_balance_increment: int = 1_000_000_000
    max_effective_balance: int = 32_000_000_000


MAINNET = EpochSpec()
# the post-Bellatrix values of the fork-dependent quotients (chain_spec.rs
# proportional_slashing_multiplier_bellatrix, inactivity_penalty_quotient_bellatrix)
BELLATRIX_SLASHING_MULTIPLIER = 3
BELLATRIX_INACTIVITY_QUOTIENT = 2**24

COLUMNS = 9  # the leading positional operands that are (n,) columns


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def epoch_kernel(
    effective_balance,  # (n,) int64 gwei
    balances,  # (n,) int64 gwei
    prev_flags,  # (n,) int64 participation bitmask
    slashed,  # (n,) bool
    scores,  # (n,) int64 inactivity scores
    active_prev,  # (n,) bool: active in the previous epoch
    active_curr,  # (n,) bool: active in the current epoch
    eligible,  # (n,) bool
    slash_target,  # (n,) bool: withdrawable at the penalty epoch
    base_reward_per_increment: int,
    in_leak: bool,
    adj_total_slashing: int,  # min(sum * multiplier, total)
    *,
    inactivity_score_bias: int,
    inactivity_score_recovery_rate: int,
    inactivity_penalty_quotient: int,
    effective_balance_increment: int,
    max_effective_balance: int,
):
    """The body of the reference's ``_epoch_kernel`` on tensors of one
    device: (new_balances, new_scores, new_eff), int64, enqueued without a
    host sync (the column sums stay on the device)."""
    incr = effective_balance_increment
    zero = torch.zeros((), dtype=torch.int64, device=balances.device)
    eb_incr = _fdiv(effective_balance, incr)
    total = torch.clamp(torch.where(active_curr, effective_balance, zero).sum(), min=incr)
    total_incr = _fdiv(total, incr)
    base_reward = eb_incr * base_reward_per_increment

    # inactivity score updates (altair/inactivity_updates.rs): participants
    # decay by 1; non-participants gain the bias; recovery applies to the
    # mid-update score outside a leak
    unslashed_prev = active_prev & ~slashed
    target_ok = unslashed_prev & (((prev_flags >> TIMELY_TARGET_FLAG_INDEX) & 1) == 1)
    new_scores = torch.where(eligible & target_ok, scores - torch.clamp(scores, max=1), scores)
    new_scores = torch.where(eligible & ~target_ok, new_scores + inactivity_score_bias,
                             new_scores)
    if not in_leak:
        new_scores = torch.where(
            eligible, new_scores - torch.clamp(new_scores, max=inactivity_score_recovery_rate),
            new_scores)

    # flag rewards and penalties (altair/rewards_and_penalties.rs)
    delta = torch.zeros_like(balances)
    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        participated = unslashed_prev & (((prev_flags >> flag_index) & 1) == 1)
        unslashed_incr = torch.where(participated, eb_incr, zero).sum()
        if in_leak:
            rewards = torch.zeros_like(base_reward)
        else:
            rewards = _fdiv(base_reward * weight * unslashed_incr,
                            total_incr * WEIGHT_DENOMINATOR)
        delta = delta + torch.where(eligible & participated, rewards, zero)
        if flag_index != TIMELY_HEAD_FLAG_INDEX:
            penalties = _fdiv(base_reward * weight, WEIGHT_DENOMINATOR)
            delta = delta - torch.where(eligible & ~participated, penalties, zero)

    # inactivity-leak penalties (the scores are updated before they are read)
    leak_pen = _fdiv(effective_balance * new_scores,
                     inactivity_score_bias * inactivity_penalty_quotient)
    delta = delta - torch.where(eligible & ~target_ok, leak_pen, zero)

    # slashing penalties (slashings.rs; the multiplier is in adj_total_slashing)
    slash_pen = _fdiv(eb_incr * adj_total_slashing, total) * incr
    delta = delta - torch.where(slash_target & slashed, slash_pen, zero)

    new_balances = torch.clamp(balances + delta, min=0)

    # effective-balance hysteresis (effective_balance_updates.rs)
    hysteresis = incr // 4
    down = new_balances + hysteresis < effective_balance
    up = effective_balance + 5 * hysteresis < new_balances
    retarget = torch.clamp(new_balances - torch.remainder(new_balances, incr),
                           max=max_effective_balance)
    new_eff = torch.where(down | up, retarget, effective_balance)
    return new_balances, new_scores, new_eff


def kernel_inputs(
    va: ValidatorArrays,
    prev_flags: np.ndarray,
    scores: np.ndarray,
    current: int,
    previous: int,
    finalized_epoch: int,
    total_slashings: int,
    spec,
    multiplier: int = 2,
    inactivity_quotient: int | None = None,
) -> tuple[list, dict]:
    """Host state -> the kernel's (positional, static) arguments: the one
    place the scalar prep (base reward per increment, leak flag, adjusted
    slashings, penalty epoch) lives.  ``spec`` is read for the same fields
    as in the reference (``spec.preset.*``, ``effective_balance_increment``,
    ``max_effective_balance``): the JAX package's ``ChainSpec`` or
    ``EpochSpec``."""
    preset = spec.preset
    incr = spec.effective_balance_increment
    total = va.total_active_balance(current, incr)
    brpi = incr * preset.base_reward_factor // math.isqrt(total)
    finality_delay = previous - finalized_epoch
    in_leak = finality_delay > preset.min_epochs_to_inactivity_penalty
    mult = preset.proportional_slashing_multiplier * multiplier
    adj = min(total_slashings * mult, total)
    epoch_to_penalize = current + preset.epochs_per_slashings_vector // 2
    positional = [
        va.effective_balance,
        va.balances,
        prev_flags.astype(np.int64),
        va.slashed,
        scores.astype(np.int64),
        np.asarray(va.is_active(previous)),
        np.asarray(va.is_active(current)),
        np.asarray(va.is_eligible(previous)),
        np.asarray(va.withdrawable_epoch == epoch_to_penalize),
        np.int64(brpi),
        bool(in_leak),
        np.int64(adj),
    ]
    static = dict(
        inactivity_score_bias=preset.inactivity_score_bias,
        inactivity_score_recovery_rate=preset.inactivity_score_recovery_rate,
        inactivity_penalty_quotient=(inactivity_quotient if inactivity_quotient is not None
                                     else preset.inactivity_penalty_quotient),
        effective_balance_increment=incr,
        max_effective_balance=spec.max_effective_balance,
    )
    return positional, static


def upload(positional: list, device) -> list:
    """The kernel's positional arguments on ``device``: the columns as int64
    or bool tensors (from pinned memory on a card), the scalars as Python
    numbers."""
    device = torch.device(device)
    out = []
    for i, x in enumerate(positional):
        if i < COLUMNS:
            t = torch.from_numpy(np.ascontiguousarray(x))
            if t.dtype != torch.bool:
                t = t.to(torch.int64)
            out.append(t.pin_memory().to(device, non_blocking=True) if device.type == "cuda"
                       else t.to(device))
        else:
            out.append(bool(x) if isinstance(x, (bool, np.bool_)) else int(x))
    return out


def epoch_balance_pipeline(
    va: ValidatorArrays,
    prev_flags: np.ndarray,
    scores: np.ndarray,
    current: int,
    previous: int,
    finalized_epoch: int,
    total_slashings: int,
    spec,
    multiplier: int = 2,
    inactivity_quotient: int | None = None,
    device=None,
):
    """Run the pipeline on ``device`` (the card unless ``device="cpu"``);
    returns (balances, scores, eff_bal) as int64 numpy arrays.  The order is
    process_epoch_altair's: inactivity, rewards, slashings, effective
    balance."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("epoch_balance_pipeline: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    positional, static = kernel_inputs(
        va, prev_flags, scores, current, previous, finalized_epoch, total_slashings, spec,
        multiplier, inactivity_quotient)
    with torch.inference_mode():
        out = epoch_kernel(*upload(positional, device), **static)
        return tuple(x.cpu().numpy() for x in out)
