"""Twin of tests/test_epoch_device.py on the port's copy of per_epoch.py:
the device pipeline (per_epoch_torch, reached through the copy's
``device_pipeline()`` seam) must reproduce the host path's post-state
bit-for-bit across randomized registries — balances, inactivity scores,
effective balances — including leak dynamics and slashing penalties
(per_epoch_processing/altair/*.rs semantics).

Here the seam is pointed at the CPU (``cpu_pipeline``): the same
``epoch_balance_pipeline`` with ``device="cpu"``.  Unpointed, the device
branch runs on the card and raises without one; it never runs the host
steps in its place.  On the card the same comparison is chip_smoke.py's
node phase.
"""

import copy
import functools
import random

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu_torch.consensus import spec as S
from lighthouse_tpu_torch.consensus.state_processing import per_epoch as PE
from lighthouse_tpu_torch.consensus.state_processing import per_epoch_torch as PT
from lighthouse_tpu_torch.consensus.state_processing.per_epoch import (
    process_epoch_altair,
)
from lighthouse_tpu_torch.consensus.testing import interop_state, phase0_spec

N = 32


@pytest.fixture
def cpu_pipeline(monkeypatch):
    """The device branch's pipeline on the CPU; counts its calls."""
    calls = []

    def route():
        calls.append(1)
        return functools.partial(PT.epoch_balance_pipeline, device="cpu")

    monkeypatch.setattr(PE, "device_pipeline", route)
    return calls


def _randomize(state, spec, rng, leak: bool = False, slashed_frac: float = 0.2):
    n = len(state.validators)
    preset = spec.preset
    state.previous_epoch_participation = [
        rng.choice([0, 1, 3, 7, 2]) for _ in range(n)
    ]
    state.current_epoch_participation = [rng.choice([0, 7]) for _ in range(n)]
    state.inactivity_scores = [rng.choice([0, 1, 4, 100]) for _ in range(n)]
    state.balances = [
        rng.randrange(
            spec.ejection_balance, spec.max_effective_balance + 2 * 10**9
        )
        for _ in range(n)
    ]
    current = state.slot // preset.slots_per_epoch
    for i, v in enumerate(state.validators):
        if rng.random() < slashed_frac:
            v.slashed = True
            # half of them right at the penalty epoch
            v.withdrawable_epoch = (
                current + preset.epochs_per_slashings_vector // 2
                if rng.random() < 0.5
                else current + 5
            )
    slashings = list(state.slashings)
    slashings[0] = 64 * 10**9
    state.slashings = slashings
    if not leak:
        from lighthouse_tpu_torch.consensus.containers import Checkpoint

        state.finalized_checkpoint = Checkpoint(
            epoch=max(current - 2, 0), root=b"\x01" * 32
        )


@pytest.mark.parametrize("leak", [False, True], ids=["finalizing", "leak"])
def test_device_matches_host(leak, cpu_pipeline):
    spec = phase0_spec(S.MINIMAL)
    rng = random.Random(42 + leak)
    state, _ = interop_state(N, spec, fork="altair")
    per_epoch = spec.preset.slots_per_epoch
    # park the state mid-chain so epoch math is nontrivial
    state.slot = 8 * per_epoch - 1 + 1  # epoch 8 boundary
    _randomize(state, spec, rng, leak=leak)

    host = copy.deepcopy(state)
    dev = copy.deepcopy(state)
    process_epoch_altair(host, spec, device=False)
    process_epoch_altair(dev, spec, device=True)

    assert list(dev.balances) == list(host.balances)
    assert list(dev.inactivity_scores) == list(host.inactivity_scores)
    assert [v.effective_balance for v in dev.validators] == [
        v.effective_balance for v in host.validators
    ]
    assert [v.exit_epoch for v in dev.validators] == [
        v.exit_epoch for v in host.validators
    ]
    assert dev.current_justified_checkpoint == host.current_justified_checkpoint
    assert cpu_pipeline == [1]


def test_inactivity_bias_applies_outside_leak(cpu_pipeline):
    """Spec process_inactivity_updates: a non-participating eligible
    validator gains INACTIVITY_SCORE_BIAS unconditionally, then the
    recovery rate applies (to the mid-update score) outside a leak:
    score 20 -> 20 + 4 - 16 = 8, NOT 20 - 16 = 4 (r3 review finding)."""
    spec = phase0_spec(S.MINIMAL)
    assert spec.preset.inactivity_score_bias == 4
    assert spec.preset.inactivity_score_recovery_rate == 16
    for device in (False, True):
        state, _ = interop_state(8, spec, fork="altair")
        state.slot = 8 * spec.preset.slots_per_epoch
        state.previous_epoch_participation = [0] * 8  # nobody hit target
        state.inactivity_scores = [20] * 8
        from lighthouse_tpu_torch.consensus.containers import Checkpoint

        state.finalized_checkpoint = Checkpoint(epoch=6, root=b"\x01" * 32)
        process_epoch_altair(state, spec, device=device)
        assert list(state.inactivity_scores) == [8] * 8, (
            f"device={device}: bias must apply before recovery"
        )
    assert cpu_pipeline == [1]


def test_padded_lanes_are_inert():
    """The padding contract: zero-EB inactive lanes produce zero deltas."""
    spec = phase0_spec(S.MINIMAL)
    from lighthouse_tpu_torch.consensus.state_processing.arrays import (
        FAR,
        ValidatorArrays,
    )
    epoch_balance_pipeline = functools.partial(PT.epoch_balance_pipeline, device="cpu")

    n, pad = 8, 8
    total_n = n + pad
    rng = np.random.default_rng(7)
    va = ValidatorArrays(
        effective_balance=np.concatenate(
            [np.full(n, 32 * 10**9, dtype=np.int64), np.zeros(pad, dtype=np.int64)]
        ),
        slashed=np.zeros(total_n, dtype=bool),
        activation_eligibility_epoch=np.zeros(total_n, dtype=np.int64),
        activation_epoch=np.concatenate(
            [np.zeros(n, dtype=np.int64), np.full(pad, FAR)]
        ),
        exit_epoch=np.full(total_n, FAR),
        withdrawable_epoch=np.full(total_n, FAR),
        balances=np.concatenate(
            [np.full(n, 32 * 10**9, dtype=np.int64), np.zeros(pad, dtype=np.int64)]
        ),
    )
    flags = np.concatenate(
        [rng.integers(0, 8, n).astype(np.int64), np.zeros(pad, dtype=np.int64)]
    )
    scores = np.concatenate(
        [rng.integers(0, 50, n).astype(np.int64), np.full(pad, 33, dtype=np.int64)]
    )
    balances, new_scores, new_eff = epoch_balance_pipeline(
        va, flags, scores, current=8, previous=7, finalized_epoch=6,
        total_slashings=0, spec=spec,
    )
    assert (balances[n:] == 0).all(), "padded balances must stay zero"
    assert (new_scores[n:] == scores[n:]).all(), "padded scores preserved"
    assert (new_eff[n:] == 0).all(), "padded effective balance unchanged"



@pytest.mark.skipif(torch.cuda.is_available(), reason="shows the refusal without a card")
@pytest.mark.parametrize("how", ["argument", "environment"])
def test_device_branch_without_a_card_raises(how, monkeypatch):
    """``device=True`` (or LIGHTHOUSE_TPU_DEVICE_EPOCH=1) routes to the
    card; without CUDA it raises and leaves the balances as they were."""
    spec = phase0_spec(S.MINIMAL)
    state, _ = interop_state(8, spec, fork="altair")
    state.slot = 8 * spec.preset.slots_per_epoch
    before = list(state.balances)
    if how == "environment":
        monkeypatch.setenv("LIGHTHOUSE_TPU_DEVICE_EPOCH", "1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        process_epoch_altair(state, spec, device=True if how == "argument" else None)
    assert list(state.balances) == before
    assert PE.device_pipeline() is PT.epoch_balance_pipeline
