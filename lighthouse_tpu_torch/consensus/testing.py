"""Deterministic test fixtures: interop keypairs + synthetic states/blocks.

Twin of the reference's interop genesis + harness seeding
(beacon_node/genesis/src/interop.rs, beacon_chain/src/test_utils.rs:324
`generate_deterministic_keypairs`): validator i's secret key is the standard
interop derivation sha256(uint64_le(i) padded to 32) reduced mod the curve
order, so fixtures here are reproducible and match other interop tooling.
"""

from __future__ import annotations

from functools import lru_cache

from ..crypto.bls import api as bls
from ..crypto.bls.params import R as CURVE_ORDER
from ..ops import sha256
from .containers import BeaconBlockHeader, Checkpoint, Fork, Validator, types_for
from .spec import ChainSpec, Preset

FAR_FUTURE_EPOCH = 2**64 - 1


@lru_cache(maxsize=4096)
def interop_secret_key(index: int) -> bls.SecretKey:
    sk = (
        int.from_bytes(sha256(index.to_bytes(32, "little")), "little")
        % CURVE_ORDER
    )
    return bls.SecretKey(sk)


@lru_cache(maxsize=64)
def _interop_keypairs_cached(n: int) -> tuple:
    return tuple(
        (interop_secret_key(i), interop_secret_key(i).public_key())
        for i in range(n)
    )


def interop_keypairs(n: int) -> list[tuple[bls.SecretKey, bls.PublicKey]]:
    return list(_interop_keypairs_cached(n))


def phase0_spec(preset: Preset) -> ChainSpec:
    """A forks-off ChainSpec: everything stays at the genesis fork version
    (the shape most unit fixtures want; fork-transition tests override)."""
    return ChainSpec(
        preset=preset,
        config_name=f"{preset.name}-phase0-test",
        altair_fork_epoch=None,
        bellatrix_fork_epoch=None,
        capella_fork_epoch=None,
        deneb_fork_epoch=None,
    )


# Built genesis states keyed by every spec field the construction reads.
# interop_state is called once per node per test, and the altair+ variants
# pay a sync-committee computation each time — caching lets a scenario run
# dozens of in-process nodes off one genesis build.  Values are deep-copied
# on the way out, so callers mutate freely (same semantics as rebuilding).
_INTEROP_STATE_CACHE: dict[tuple, object] = {}
_INTEROP_STATE_CACHE_MAX = 16


def interop_state(
    n_validators: int,
    spec: ChainSpec,
    balance: int | None = None,
    fork: str = "base",
    registry_padding: int = 0,
):
    """Genesis-like BeaconState (chosen fork variant) with n interop
    validators, plus the keypairs.  genesis_validators_root is computed per
    spec (the root of the validator registry).

    ``registry_padding`` appends that many *inactive* synthetic validators
    (never-activated, zero balance) after the interop set, and freezes the
    whole registry for copy-on-write sharing — the cheap-node path that lets
    scenarios run registry-scale states across dozens of in-process nodes.
    """
    key = (
        n_validators, balance, fork, spec.preset, spec.config_name,
        spec.max_effective_balance, spec.min_genesis_time,
        bytes(spec.genesis_fork_version),
        bytes(getattr(spec, f"{fork}_fork_version"))
        if fork != "base"
        and getattr(spec, f"{fork}_fork_epoch", None) is not None
        else None,
        registry_padding,
    )
    cached = _INTEROP_STATE_CACHE.get(key)
    if cached is not None:
        return cached.copy(), interop_keypairs(n_validators)
    state, keypairs = _build_interop_state(
        n_validators, spec, balance, fork, registry_padding
    )
    if len(_INTEROP_STATE_CACHE) >= _INTEROP_STATE_CACHE_MAX:
        _INTEROP_STATE_CACHE.pop(next(iter(_INTEROP_STATE_CACHE)))
    _INTEROP_STATE_CACHE[key] = state.copy()
    return state, keypairs


def _padding_validators(count: int, offset: int) -> list:
    """Inactive registry filler: unique synthetic pubkeys (no BLS key behind
    them — they never sign), FAR epochs everywhere, zero effective balance.
    Kept frozen so copies/roots share them."""
    out = []
    for i in range(count):
        v = Validator(
            pubkey=b"\xfa" + (offset + i).to_bytes(8, "little") + b"\x00" * 39,
            withdrawal_credentials=b"\x00" * 32,
            effective_balance=0,
            slashed=False,
            activation_eligibility_epoch=FAR_FUTURE_EPOCH,
            activation_epoch=FAR_FUTURE_EPOCH,
            exit_epoch=FAR_FUTURE_EPOCH,
            withdrawable_epoch=FAR_FUTURE_EPOCH,
        )
        out.append(v.freeze())
    return out


def _build_interop_state(
    n_validators: int,
    spec: ChainSpec,
    balance: int | None = None,
    fork: str = "base",
    registry_padding: int = 0,
):
    preset = spec.preset
    T = types_for(preset)
    balance = balance if balance is not None else spec.max_effective_balance
    keypairs = interop_keypairs(n_validators)
    validators = [
        Validator(
            pubkey=pk.to_bytes(),
            withdrawal_credentials=b"\x00" * 32,
            effective_balance=spec.max_effective_balance,
            slashed=False,
            activation_eligibility_epoch=0,
            activation_epoch=0,
            exit_epoch=FAR_FUTURE_EPOCH,
            withdrawable_epoch=FAR_FUTURE_EPOCH,
        )
        for _, pk in keypairs
    ]
    if registry_padding:
        for v in validators:
            v.freeze()
        validators += _padding_validators(registry_padding, n_validators)
        Validator.bulk_roots(validators)
    state_cls = T.BeaconState_BY_FORK[fork]
    # A genesis state at a scheduled fork carries that fork's version (the
    # reference harness does the same when spawning e.g. a bellatrix-genesis
    # chain); forks-off specs keep the genesis version everywhere.
    version = spec.genesis_fork_version
    if fork != "base" and getattr(spec, f"{fork}_fork_epoch", None) is not None:
        version = getattr(spec, f"{fork}_fork_version")
    state = state_cls(
        genesis_time=spec.min_genesis_time,
        slot=0,
        fork=Fork(
            previous_version=version,
            current_version=version,
            epoch=0,
        ),
        latest_block_header=BeaconBlockHeader(),
        validators=validators,
        balances=[balance] * n_validators + [0] * registry_padding,
        randao_mixes=[bytes(32)] * preset.epochs_per_historical_vector,
        finalized_checkpoint=Checkpoint(),
    )
    gvr = state_cls._fields["validators"].hash_tree_root(validators)
    state.genesis_validators_root = gvr
    n_total = len(validators)
    if fork != "base":
        state.previous_epoch_participation = [0] * n_total
        state.current_epoch_participation = [0] * n_total
        state.inactivity_scores = [0] * n_total
        from .state_processing.per_epoch import compute_sync_committee

        state.current_sync_committee = compute_sync_committee(state, 0, spec)
        state.next_sync_committee = compute_sync_committee(
            state, preset.epochs_per_sync_committee_period, spec
        )
    return state, keypairs


def pubkey_getter(state):
    """A decompression cache over the state's validators — the
    ValidatorPubkeyCache analog (validator_pubkey_cache.rs:9-16)."""
    cache: dict[int, bls.PublicKey] = {}

    def get(index: int):
        if index in cache:
            return cache[index]
        if index >= len(state.validators):
            return None
        pk = bls.PublicKey.from_bytes(bytes(state.validators[index].pubkey))
        cache[index] = pk
        return pk

    return get


def apply_epoch_handler(state, handler: str, spec) -> None:
    """Run ONE epoch-processing sub-step on ``state`` in place — the
    dispatch the EF `epoch_processing` runner families use
    (testing/ef_tests/src/cases/epoch_processing.rs runs exactly one
    sub-transition per case)."""
    from .state_processing import per_epoch as E
    from .state_processing.arrays import ValidatorArrays

    preset = spec.preset
    va = ValidatorArrays.extract(state)
    n = len(state.validators)
    current = E.get_current_epoch(state, preset)
    previous = max(current, 1) - 1
    prev_flags = E._flags(state, "previous", n)
    curr_flags = E._flags(state, "current", n)
    if handler == "justification_and_finalization":
        E.process_justification_and_finalization(
            state, va, prev_flags, curr_flags, current, previous, spec
        )
    elif handler == "inactivity_updates":
        E.process_inactivity_updates(
            state, va, prev_flags, current, previous, spec
        )
    elif handler == "rewards_and_penalties":
        E.process_rewards_and_penalties(
            state, va, prev_flags, current, previous, spec
        )
    elif handler == "registry_updates":
        E.process_registry_updates(state, va, current, spec)
    elif handler == "slashings":
        from .state_processing.forks import (
            proportional_slashing_multiplier,
            state_fork_name,
        )

        E.process_slashings(
            state, va, current, spec,
            multiplier=proportional_slashing_multiplier(
                state_fork_name(state), preset
            ),
        )
    elif handler == "effective_balance_updates":
        E.process_effective_balance_updates(va, spec)
    else:
        raise KeyError(f"unknown epoch handler {handler}")
    va.writeback(state)


def apply_operation(state, handler: str, op, spec, verify: bool = False):
    """Apply ONE block operation in place (the EF `operations` runner
    dispatch — testing/ef_tests/src/cases/operations.rs); raises on an
    invalid operation."""
    from .state_processing import per_block as PB

    get_pk = pubkey_getter(state)
    if handler == "attestation":
        from . import committees as cm

        cc = cm.CommitteeCache(state, int(op.data.target.epoch), spec.preset)
        PB.process_attestation(state, op, spec, cc, verify, get_pk)
    elif handler == "proposer_slashing":
        PB.process_proposer_slashing(state, op, spec, verify, get_pk)
    elif handler == "attester_slashing":
        PB.process_attester_slashing(state, op, spec, verify, get_pk)
    elif handler == "voluntary_exit":
        PB.process_voluntary_exit(state, op, spec, verify, get_pk)
    elif handler == "deposit":
        PB.process_deposit(state, op, spec)
    else:
        raise KeyError(f"unknown operation handler {handler}")
