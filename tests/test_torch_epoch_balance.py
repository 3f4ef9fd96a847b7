"""The port's epoch balance pipeline (per_epoch_torch) against the JAX package's.

On the three corpora of tests/test_epoch_device.py (a finalizing chain, an
inactivity leak, and the inactivity bias outside a leak) the JAX package's
``process_epoch_altair(device=True)`` runs with its
``epoch_balance_pipeline`` wrapped: each call also runs the port's pipeline
on the CPU, on the same columns carried into the port's ``ValidatorArrays``,
and requires the same int64 outputs; the wrapper hands the port's outputs
on, and the post-state must equal the host path's
(``process_epoch_altair(device=False)``) exactly.  The padding contract
holds on the port, and its ``MAINNET`` record equals the JAX package's
mainnet values.
"""

import copy
import dataclasses
import random

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

pytest.importorskip("jax")

from lighthouse_tpu.consensus import spec as S  # noqa: E402
from lighthouse_tpu.consensus.containers import Checkpoint  # noqa: E402
from lighthouse_tpu.consensus.state_processing import arrays as RA  # noqa: E402
from lighthouse_tpu.consensus.state_processing import forks  # noqa: E402
from lighthouse_tpu.consensus.state_processing import per_epoch_jax  # noqa: E402
from lighthouse_tpu.consensus.state_processing.per_epoch import process_epoch_altair  # noqa: E402
from lighthouse_tpu.consensus.testing import interop_state, phase0_spec  # noqa: E402
from lighthouse_tpu_torch.consensus.state_processing import arrays as PA  # noqa: E402
from lighthouse_tpu_torch.consensus.state_processing import per_epoch_torch as PT  # noqa: E402

N = 32


def _port_arrays(va) -> PA.ValidatorArrays:
    """The JAX package's ValidatorArrays -> the port's, column for column."""
    return PA.ValidatorArrays(**{f.name: np.array(getattr(va, f.name))
                                 for f in dataclasses.fields(PA.ValidatorArrays)})


@pytest.fixture
def twin(monkeypatch):
    """Wrap the JAX pipeline that process_epoch_altair(device=True) calls:
    every call also runs the port's on the CPU and must agree; the port's
    outputs go on into the state.  Yields the list of calls."""
    reference = per_epoch_jax.epoch_balance_pipeline
    calls = []

    def both(va, *args, **kw):
        ref = reference(va, *args, **kw)
        port = PT.epoch_balance_pipeline(_port_arrays(va), *args, **kw, device="cpu")
        assert [x.dtype for x in port] == [np.dtype(np.int64)] * 3
        for r, p in zip(ref, port):
            assert np.array_equal(np.asarray(r).astype(np.int64), p)
        calls.append(len(va.balances))
        return port

    monkeypatch.setattr(per_epoch_jax, "epoch_balance_pipeline", both)
    return calls


def _randomize(state, spec, rng, leak: bool = False, slashed_frac: float = 0.2):
    """The corpus of tests/test_epoch_device.py."""
    n = len(state.validators)
    preset = spec.preset
    state.previous_epoch_participation = [rng.choice([0, 1, 3, 7, 2]) for _ in range(n)]
    state.current_epoch_participation = [rng.choice([0, 7]) for _ in range(n)]
    state.inactivity_scores = [rng.choice([0, 1, 4, 100]) for _ in range(n)]
    state.balances = [rng.randrange(spec.ejection_balance, spec.max_effective_balance + 2 * 10**9)
                      for _ in range(n)]
    current = state.slot // preset.slots_per_epoch
    for v in state.validators:
        if rng.random() < slashed_frac:
            v.slashed = True
            # half of them right at the penalty epoch
            v.withdrawable_epoch = (current + preset.epochs_per_slashings_vector // 2
                                    if rng.random() < 0.5 else current + 5)
    slashings = list(state.slashings)
    slashings[0] = 64 * 10**9
    state.slashings = slashings
    if not leak:
        state.finalized_checkpoint = Checkpoint(epoch=max(current - 2, 0), root=b"\x01" * 32)


@pytest.mark.parametrize("leak", [False, True], ids=["finalizing", "leak"])
def test_port_matches_jax_and_the_host_path(twin, leak):
    spec = phase0_spec(S.MINIMAL)
    rng = random.Random(42 + leak)
    state, _ = interop_state(N, spec, fork="altair")
    state.slot = 8 * spec.preset.slots_per_epoch  # the epoch 8 boundary
    _randomize(state, spec, rng, leak=leak)
    host, dev = copy.deepcopy(state), copy.deepcopy(state)
    process_epoch_altair(host, spec, device=False)
    process_epoch_altair(dev, spec, device=True)
    assert twin == [N]
    assert list(dev.balances) == list(host.balances)
    assert list(dev.inactivity_scores) == list(host.inactivity_scores)
    assert [v.effective_balance for v in dev.validators] == [
        v.effective_balance for v in host.validators]
    assert [v.exit_epoch for v in dev.validators] == [v.exit_epoch for v in host.validators]
    assert dev.current_justified_checkpoint == host.current_justified_checkpoint
    assert list(dev.balances) != list(state.balances)  # the epoch moved balances


def test_inactivity_bias_applies_outside_leak(twin):
    """A non-participating eligible validator gains the bias, then the
    recovery rate applies outside a leak: 20 -> 20 + 4 - 16 = 8."""
    spec = phase0_spec(S.MINIMAL)
    for device in (False, True):
        state, _ = interop_state(8, spec, fork="altair")
        state.slot = 8 * spec.preset.slots_per_epoch
        state.previous_epoch_participation = [0] * 8  # nobody hit the target
        state.inactivity_scores = [20] * 8
        state.finalized_checkpoint = Checkpoint(epoch=6, root=b"\x01" * 32)
        process_epoch_altair(state, spec, device=device)
        assert list(state.inactivity_scores) == [8] * 8, f"device={device}"
    assert twin == [8]


def test_padded_lanes_are_inert():
    """The padding contract: zero-EB inactive lanes get zero deltas, keep
    their scores and their effective balance; the rest equals JAX."""
    spec = phase0_spec(S.MINIMAL)
    n, pad = 8, 8
    total_n = n + pad
    rng = np.random.default_rng(7)
    cols = dict(
        effective_balance=np.concatenate([np.full(n, 32 * 10**9, dtype=np.int64),
                                          np.zeros(pad, dtype=np.int64)]),
        slashed=np.zeros(total_n, dtype=bool),
        activation_eligibility_epoch=np.zeros(total_n, dtype=np.int64),
        activation_epoch=np.concatenate([np.zeros(n, dtype=np.int64), np.full(pad, PA.FAR)]),
        exit_epoch=np.full(total_n, PA.FAR),
        withdrawable_epoch=np.full(total_n, PA.FAR),
        balances=np.concatenate([np.full(n, 32 * 10**9, dtype=np.int64),
                                 np.zeros(pad, dtype=np.int64)]),
    )
    flags = np.concatenate([rng.integers(0, 8, n).astype(np.int64), np.zeros(pad, np.int64)])
    scores = np.concatenate([rng.integers(0, 50, n).astype(np.int64),
                             np.full(pad, 33, dtype=np.int64)])
    kw = dict(current=8, previous=7, finalized_epoch=6, total_slashings=0, spec=spec)
    balances, new_scores, new_eff = PT.epoch_balance_pipeline(
        PA.ValidatorArrays(**cols), flags, scores, **kw, device="cpu")
    assert (balances[n:] == 0).all(), "padded balances must stay zero"
    assert (new_scores[n:] == scores[n:]).all(), "padded scores preserved"
    assert (new_eff[n:] == 0).all(), "padded effective balance unchanged"
    ref = per_epoch_jax.epoch_balance_pipeline(RA.ValidatorArrays(**cols), flags, scores, **kw)
    for r, p in zip(ref, (balances, new_scores, new_eff)):
        assert np.array_equal(np.asarray(r).astype(np.int64), p)


def test_mainnet_record_matches_the_jax_spec():
    """The port's MAINNET parameters are the JAX package's mainnet values,
    and the post-Bellatrix quotients its fork table's; the pipeline reads
    the same result from either spec object."""
    ref = S.ChainSpec(preset=S.MAINNET)
    for f in dataclasses.fields(PT.EpochPreset):
        assert getattr(PT.MAINNET.preset, f.name) == getattr(S.MAINNET, f.name), f.name
    assert PT.MAINNET.effective_balance_increment == ref.effective_balance_increment
    assert PT.MAINNET.max_effective_balance == ref.max_effective_balance
    assert PT.BELLATRIX_SLASHING_MULTIPLIER == forks.proportional_slashing_multiplier(
        "bellatrix", S.MAINNET)
    assert PT.BELLATRIX_INACTIVITY_QUOTIENT == forks.inactivity_penalty_quotient(
        "bellatrix", S.MAINNET)
    rng = np.random.default_rng(11)
    n = 64
    va = PA.ValidatorArrays(
        effective_balance=rng.integers(17, 33, n).astype(np.int64) * 10**9,
        slashed=rng.random(n) < 0.1,
        activation_eligibility_epoch=np.zeros(n, np.int64),
        activation_epoch=np.zeros(n, np.int64),
        exit_epoch=np.full(n, PA.FAR),
        withdrawable_epoch=np.where(rng.random(n) < 0.5, 100 + 4096, PA.FAR).astype(np.int64),
        balances=rng.integers(16 * 10**9, 34 * 10**9, n).astype(np.int64),
    )
    flags, scores = rng.integers(0, 8, n), rng.integers(0, 64, n)
    for finalized in (98, 80):  # finalizing, leaking
        args = (flags, scores, 100, 99, finalized, 96 * 10**9)
        kw = dict(multiplier=3, inactivity_quotient=2**24)
        a = PT.epoch_balance_pipeline(va, *args, PT.MAINNET, **kw, device="cpu")
        b = PT.epoch_balance_pipeline(va, *args, ref, **kw, device="cpu")
        c = per_epoch_jax.epoch_balance_pipeline(
            RA.ValidatorArrays(**dataclasses.asdict(va)), *args, ref, **kw)
        for x, y, z in zip(a, b, c):
            assert np.array_equal(x, y) and np.array_equal(x, np.asarray(z))


def test_pipeline_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    va = PA.ValidatorArrays(*(np.zeros(1, np.int64),) * 7)
    with pytest.raises(RuntimeError, match="CUDA"):
        PT.epoch_balance_pipeline(va, np.zeros(1), np.zeros(1), 1, 0, 0, 0, PT.MAINNET)
