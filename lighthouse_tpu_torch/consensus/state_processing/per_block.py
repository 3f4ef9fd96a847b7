"""Per-block processing (Altair line) — header, randao, operations, sync.

Twin of consensus/state_processing/src/per_block_processing.rs:100-196 and
per_block_processing/{process_operations,altair/sync_committee}.rs.
Signature strategy mirrors the reference's `BlockSignatureStrategy` enum
(per_block_processing.rs:54-63): callers either pre-verify in bulk with
BlockSignatureVerifier (VerifyBulk — the TPU path) and pass
``verify_signatures=False`` here, or let each operation verify individually
(VerifyIndividual).
"""

from __future__ import annotations

import numpy as np

from ...ops import sha256
from ..committees import CommitteeCache, get_beacon_proposer_index, get_indexed_attestation
from ..containers import Eth1Data, PendingAttestation  # noqa: F401
from ..spec import ChainSpec
from .arrays import (
    FAR_FUTURE_EPOCH,
    PARTICIPATION_FLAG_WEIGHTS,
    PROPOSER_WEIGHT,
    SYNC_REWARD_WEIGHT,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_SOURCE_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
)
from . import signature_sets as sets
from .forks import (
    fork_at_least,
    min_slashing_penalty_quotient,
    state_fork_name,
)


class BlockProcessingError(Exception):
    pass


def _err(cond: bool, msg: str) -> None:
    if not cond:
        raise BlockProcessingError(msg)


def process_block(
    state,
    signed_block,
    spec: ChainSpec,
    committee_cache: CommitteeCache | None = None,
    verify_signatures: bool = True,
    get_pubkey=None,
) -> None:
    """per_block_processing.rs:100: the full per-block pipeline (consensus
    portion; execution-payload handling is the execution layer's gate)."""
    block = signed_block.message
    preset = spec.preset
    if committee_cache is None:
        committee_cache = CommitteeCache(
            state, state.slot // preset.slots_per_epoch, preset
        )
    if get_pubkey is None:
        from ..testing import pubkey_getter

        get_pubkey = pubkey_getter(state)

    process_block_header(state, block, spec)
    # bellatrix+ execution pipeline (per_block_processing.rs:169-175 order:
    # withdrawals before the payload, both before randao), gated on
    # is_execution_enabled exactly as the spec gates both steps pre-merge
    if hasattr(block.body, "execution_payload") and is_execution_enabled(
        state, block.body
    ):
        if hasattr(state, "next_withdrawal_index"):
            process_withdrawals(state, block.body.execution_payload, spec)
        process_execution_payload(state, block.body, spec)
    process_randao(state, block, spec, verify_signatures, get_pubkey)
    process_eth1_data(state, block.body, spec)
    process_operations(
        state, block.body, spec, committee_cache, verify_signatures, get_pubkey
    )
    if hasattr(block.body, "sync_aggregate"):
        process_sync_aggregate(
            state, block.body.sync_aggregate, spec, verify_signatures, get_pubkey
        )


def process_block_header(state, block, spec: ChainSpec) -> None:
    """per_block_processing.rs process_block_header."""
    from ..containers import BeaconBlockHeader

    preset = spec.preset
    _err(block.slot == state.slot, "block slot != state slot")
    _err(
        block.slot > state.latest_block_header.slot,
        "block older than latest header",
    )
    expected = get_beacon_proposer_index(state, block.slot, preset)
    _err(block.proposer_index == expected, "wrong proposer index")
    _err(
        block.parent_root == state.latest_block_header.root(),
        "parent root mismatch",
    )
    v = state.validators[block.proposer_index]
    _err(not v.slashed, "proposer is slashed")
    state.latest_block_header = BeaconBlockHeader(
        slot=block.slot,
        proposer_index=block.proposer_index,
        parent_root=block.parent_root,
        state_root=bytes(32),  # filled by per-slot caching
        body_root=type(block)._fields["body"].hash_tree_root(block.body),
    )


def process_randao(state, block, spec, verify_signatures, get_pubkey) -> None:
    preset = spec.preset
    epoch = state.slot // preset.slots_per_epoch
    if verify_signatures:
        s = sets.randao_signature_set(state, get_pubkey, block, preset)
        _err(s.verify(), "randao signature invalid")
    mix_idx = epoch % preset.epochs_per_historical_vector
    mixes = list(state.randao_mixes)
    old = bytes(mixes[mix_idx])
    reveal_digest = sha256(bytes(block.body.randao_reveal))
    mixes[mix_idx] = bytes(a ^ b for a, b in zip(old, reveal_digest))
    state.randao_mixes = mixes


def process_eth1_data(state, body, spec) -> None:
    """Majority vote over the eth1 voting period."""
    state.eth1_data_votes = list(state.eth1_data_votes) + [body.eth1_data]
    period_slots = (
        spec.preset.epochs_per_eth1_voting_period * spec.preset.slots_per_epoch
    )
    votes = [v for v in state.eth1_data_votes if v == body.eth1_data]
    if len(votes) * 2 > period_slots:
        state.eth1_data = body.eth1_data


def process_operations(
    state, body, spec, committee_cache, verify_signatures, get_pubkey
) -> None:
    """process_operations.rs: counts gate then each operation in order."""
    preset = spec.preset
    # expected deposit count (spec: min(MAX_DEPOSITS, pending))
    expected_deposits = min(
        preset.max_deposits,
        state.eth1_data.deposit_count - state.eth1_deposit_index,
    )
    _err(
        len(body.deposits) == expected_deposits,
        f"expected {expected_deposits} deposits, block has {len(body.deposits)}",
    )
    for ps in body.proposer_slashings:
        process_proposer_slashing(state, ps, spec, verify_signatures, get_pubkey)
    for asl in body.attester_slashings:
        process_attester_slashing(state, asl, spec, verify_signatures, get_pubkey)
    for att in body.attestations:
        process_attestation(
            state, att, spec, committee_cache, verify_signatures, get_pubkey
        )
    for dep in body.deposits:
        process_deposit(state, dep, spec)
    for ex in body.voluntary_exits:
        process_voluntary_exit(state, ex, spec, verify_signatures, get_pubkey)
    if hasattr(body, "bls_to_execution_changes"):
        for ch in body.bls_to_execution_changes:
            process_bls_to_execution_change(state, ch, spec, verify_signatures)


# ---------------------------------------------------------------------------


def _current_epoch(state, preset) -> int:
    return state.slot // preset.slots_per_epoch


def _update_validator(state, index: int, **changes) -> None:
    """Apply field changes to a registry entry.  Frozen entries (cheap-node
    copy-on-write registries) are replaced via thawed()+freeze() with the
    list rebound, so shared frozen registries never mutate in place; mutable
    entries are updated directly."""
    v = state.validators[index]
    if v.__dict__.get("_frozen"):
        vs = list(state.validators)
        vs[index] = v.thawed(**changes).freeze()
        state.validators = vs
    else:
        for k, val in changes.items():
            setattr(v, k, val)


def slash_validator(
    state, slashed_index: int, spec: ChainSpec, whistleblower: int | None = None
) -> None:
    """process_slashings::slash_validator (altair constants)."""
    preset = spec.preset
    epoch = _current_epoch(state, preset)
    _initiate_validator_exit(state, slashed_index, spec)
    v = state.validators[slashed_index]
    _update_validator(
        state,
        slashed_index,
        slashed=True,
        withdrawable_epoch=max(
            v.withdrawable_epoch, epoch + preset.epochs_per_slashings_vector
        ),
    )
    v = state.validators[slashed_index]
    s = list(state.slashings)
    s[epoch % preset.epochs_per_slashings_vector] += v.effective_balance
    state.slashings = s
    fork = state_fork_name(state)
    # 128 (phase0) → 64 (altair) → 32 (bellatrix+), chain_spec.rs quotients
    penalty = v.effective_balance // min_slashing_penalty_quotient(fork, preset)
    _decrease_balance(state, slashed_index, penalty)
    proposer = get_beacon_proposer_index(state, state.slot, preset)
    whistleblower = whistleblower if whistleblower is not None else proposer
    wb_reward = v.effective_balance // preset.whistleblower_reward_quotient
    if fork == "base":
        proposer_reward = wb_reward // preset.proposer_reward_quotient
    else:
        proposer_reward = wb_reward * PROPOSER_WEIGHT // WEIGHT_DENOMINATOR
    _increase_balance(state, proposer, proposer_reward)
    _increase_balance(state, whistleblower, wb_reward - proposer_reward)


def _increase_balance(state, index: int, delta: int) -> None:
    b = list(state.balances)
    b[index] += delta
    state.balances = b


def _decrease_balance(state, index: int, delta: int) -> None:
    b = list(state.balances)
    b[index] = max(0, b[index] - delta)
    state.balances = b


def _initiate_validator_exit(state, index: int, spec: ChainSpec) -> None:
    preset = spec.preset
    v = state.validators[index]
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        return
    epoch = _current_epoch(state, preset)
    delay = epoch + 1 + preset.max_seed_lookahead
    exit_epochs = [
        w.exit_epoch for w in state.validators if w.exit_epoch != FAR_FUTURE_EPOCH
    ]
    exit_epoch = max(exit_epochs + [delay])
    active = sum(
        1 for w in state.validators if w.activation_epoch <= epoch < w.exit_epoch
    )
    churn = max(spec.min_per_epoch_churn_limit, active // spec.churn_limit_quotient)
    while sum(1 for e in exit_epochs if e == exit_epoch) >= churn:
        exit_epoch += 1
    _update_validator(
        state,
        index,
        exit_epoch=exit_epoch,
        withdrawable_epoch=exit_epoch + spec.min_validator_withdrawability_delay,
    )


def process_proposer_slashing(state, ps, spec, verify_signatures, get_pubkey):
    preset = spec.preset
    h1, h2 = ps.signed_header_1.message, ps.signed_header_2.message
    _err(h1.slot == h2.slot, "slashing headers differ in slot")
    _err(h1.proposer_index == h2.proposer_index, "different proposers")
    _err(h1.root() != h2.root(), "identical headers are not slashable")
    v = state.validators[h1.proposer_index]
    _err(_is_slashable_validator(v, _current_epoch(state, preset)), "not slashable")
    if verify_signatures:
        for s in sets.proposer_slashing_signature_set(
            state, get_pubkey, ps, preset
        ):
            _err(s.verify(), "proposer slashing signature invalid")
    slash_validator(state, h1.proposer_index, spec)


def _is_slashable_validator(v, epoch: int) -> bool:
    return (not v.slashed) and (
        v.activation_epoch <= epoch < v.withdrawable_epoch
    )


def is_slashable_attestation_data(d1, d2) -> bool:
    """double vote or surround vote."""
    double = d1.root() != d2.root() and d1.target.epoch == d2.target.epoch
    surround = (
        d1.source.epoch < d2.source.epoch and d2.target.epoch < d1.target.epoch
    )
    return double or surround


def process_attester_slashing(state, asl, spec, verify_signatures, get_pubkey):
    preset = spec.preset
    a1, a2 = asl.attestation_1, asl.attestation_2
    _err(
        is_slashable_attestation_data(a1.data, a2.data),
        "attestations are not slashable",
    )
    for a in (a1, a2):
        _err(_indices_valid(a), "indexed attestation indices invalid")
        if verify_signatures:
            s = sets.indexed_attestation_signature_set(
                state, get_pubkey, a, preset
            )
            _err(s.verify(), "attester slashing signature invalid")
    epoch = _current_epoch(state, preset)
    common = sorted(
        set(map(int, a1.attesting_indices)) & set(map(int, a2.attesting_indices))
    )
    slashed_any = False
    for idx in common:
        if _is_slashable_validator(state.validators[idx], epoch):
            slash_validator(state, idx, spec)
            slashed_any = True
    _err(slashed_any, "no validator slashed by attester slashing")


def _indices_valid(indexed) -> bool:
    idx = list(map(int, indexed.attesting_indices))
    return len(idx) > 0 and idx == sorted(idx) and len(set(idx)) == len(idx)


def get_attestation_participation_flags(
    state, data, inclusion_delay: int, spec: ChainSpec
) -> list[int]:
    """altair get_attestation_participation_flag_indices."""
    preset = spec.preset
    current = _current_epoch(state, preset)
    if data.target.epoch == current:
        justified = state.current_justified_checkpoint
    else:
        justified = state.previous_justified_checkpoint
    is_matching_source = data.source == justified
    _err(is_matching_source, "attestation source does not match justified")
    target_root = _block_root_at_slot(
        state, data.target.epoch * preset.slots_per_epoch, preset
    )
    is_matching_target = is_matching_source and bytes(data.target.root) == target_root
    head_root = _block_root_at_slot(state, data.slot, preset)
    is_matching_head = is_matching_target and bytes(data.beacon_block_root) == head_root
    flags = []
    import math

    if is_matching_source and inclusion_delay <= math.isqrt(preset.slots_per_epoch):
        flags.append(TIMELY_SOURCE_FLAG_INDEX)
    # deneb (EIP-7045) drops the inclusion-delay cap on the target flag;
    # altair..capella keep the one-epoch window.
    target_in_window = fork_at_least(state_fork_name(state), "deneb") or (
        inclusion_delay <= preset.slots_per_epoch
    )
    if is_matching_target and target_in_window:
        flags.append(TIMELY_TARGET_FLAG_INDEX)
    if is_matching_head and inclusion_delay == spec.min_attestation_inclusion_delay:
        flags.append(TIMELY_HEAD_FLAG_INDEX)
    return flags


def _block_root_at_slot(state, slot: int, preset) -> bytes:
    _err(
        slot < state.slot <= slot + preset.slots_per_historical_root,
        "slot out of block-roots range",
    )
    return bytes(state.block_roots[slot % preset.slots_per_historical_root])


def process_attestation(
    state, attestation, spec, committee_cache, verify_signatures, get_pubkey
):
    """process_operations.rs altair::process_attestation: validity window,
    committee membership, participation-flag updates, proposer reward."""
    preset = spec.preset
    data = attestation.data
    current = _current_epoch(state, preset)
    previous = max(current, 1) - 1
    _err(data.target.epoch in (previous, current), "target epoch out of range")
    _err(
        data.target.epoch == data.slot // preset.slots_per_epoch,
        "target/slot mismatch",
    )
    _err(
        data.slot + spec.min_attestation_inclusion_delay <= state.slot,
        "attestation too fresh",
    )
    cache = committee_cache
    if cache.epoch != data.target.epoch:
        cache = CommitteeCache(state, data.target.epoch, preset)
    _err(data.index < cache.committees_per_slot, "committee index out of range")
    committee = cache.committee(data.slot, data.index)
    _err(
        len(attestation.aggregation_bits) == len(committee),
        "aggregation bits length mismatch",
    )
    if verify_signatures:
        indexed = get_indexed_attestation(committee, attestation)
        s = sets.indexed_attestation_signature_set(state, get_pubkey, indexed, preset)
        _err(s.verify(), "attestation signature invalid")

    inclusion_delay = state.slot - data.slot
    which = "current" if data.target.epoch == current else "previous"
    if hasattr(state, "previous_epoch_attestations"):
        # phase0 path (base::process_attestation): record a
        # PendingAttestation; rewards happen at the epoch boundary.
        justified = (
            state.current_justified_checkpoint
            if data.target.epoch == current
            else state.previous_justified_checkpoint
        )
        _err(data.source == justified, "attestation source does not match justified")
        # phase0 keeps the upper inclusion window (dropped in deneb)
        _err(
            state.slot <= data.slot + preset.slots_per_epoch,
            "attestation past the phase0 inclusion window",
        )
        pending = PendingAttestation(
            aggregation_bits=list(attestation.aggregation_bits),
            data=data,
            inclusion_delay=inclusion_delay,
            proposer_index=get_beacon_proposer_index(state, state.slot, preset),
        )
        lst = list(getattr(state, f"{which}_epoch_attestations"))
        setattr(state, f"{which}_epoch_attestations", lst + [pending])
        return
    flags = get_attestation_participation_flags(state, data, inclusion_delay, spec)
    participation = list(getattr(state, f"{which}_epoch_participation"))
    if len(participation) < len(state.validators):
        participation += [0] * (len(state.validators) - len(participation))

    import math

    incr = spec.effective_balance_increment
    total = max(
        sum(
            v.effective_balance
            for v in state.validators
            if v.activation_epoch <= current < v.exit_epoch
        ),
        incr,
    )
    base_reward_per_increment = (
        incr * preset.base_reward_factor // math.isqrt(total)
    )
    proposer_reward_numerator = 0
    members = [int(committee[i]) for i, b in enumerate(attestation.aggregation_bits) if b]
    for vi in members:
        eb_incr = state.validators[vi].effective_balance // incr
        base_reward = eb_incr * base_reward_per_increment
        for f in flags:
            if not (participation[vi] >> f) & 1:
                participation[vi] |= 1 << f
                proposer_reward_numerator += (
                    base_reward * PARTICIPATION_FLAG_WEIGHTS[f]
                )
    setattr(state, f"{which}_epoch_participation", participation)
    denom = (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT) * WEIGHT_DENOMINATOR // PROPOSER_WEIGHT
    proposer_reward = proposer_reward_numerator // denom
    proposer = get_beacon_proposer_index(state, state.slot, preset)
    _increase_balance(state, proposer, proposer_reward)


def process_deposit(state, deposit, spec: ChainSpec, verify_proof: bool = True):
    """process_operations.rs process_deposit: merkle proof against
    eth1_data.deposit_root, then apply (BLS check gates NEW validators)."""
    from ..merkle import verify_merkle_proof

    if verify_proof:
        leaf = deposit.data.root()
        _err(
            verify_merkle_proof(
                leaf,
                [bytes(p) for p in deposit.proof],
                spec.deposit_contract_tree_depth + 1,
                state.eth1_deposit_index,
                bytes(state.eth1_data.deposit_root),
            ),
            "deposit merkle proof invalid",
        )
    state.eth1_deposit_index += 1
    apply_deposit(state, deposit.data, spec)


def apply_deposit(state, data, spec: ChainSpec) -> None:
    pubkeys = [bytes(v.pubkey) for v in state.validators]
    pk = bytes(data.pubkey)
    if pk in pubkeys:
        _increase_balance(state, pubkeys.index(pk), data.amount)
        return
    # new validator: the deposit signature must verify (proof of possession)
    try:
        s = sets.deposit_signature_set(data, spec)
        if not s.verify():
            return  # invalid signature: deposit is skipped, not an error
    except sets.SignatureSetError:
        return
    from ..containers import Validator

    eb = min(
        data.amount - data.amount % spec.effective_balance_increment,
        spec.max_effective_balance,
    )
    new_v = Validator(
        pubkey=pk,
        withdrawal_credentials=bytes(data.withdrawal_credentials),
        effective_balance=eb,
        slashed=False,
        activation_eligibility_epoch=FAR_FUTURE_EPOCH,
        activation_epoch=FAR_FUTURE_EPOCH,
        exit_epoch=FAR_FUTURE_EPOCH,
        withdrawable_epoch=FAR_FUTURE_EPOCH,
    )
    vs = list(state.validators)
    if vs and vs[0].__dict__.get("_frozen"):
        new_v.freeze()  # keep a frozen registry uniformly frozen
    state.validators = vs + [new_v]
    state.balances = list(state.balances) + [data.amount]
    if hasattr(state, "previous_epoch_participation"):
        state.previous_epoch_participation = list(
            state.previous_epoch_participation
        ) + [0]
        state.current_epoch_participation = list(
            state.current_epoch_participation
        ) + [0]
    if hasattr(state, "inactivity_scores"):
        state.inactivity_scores = list(state.inactivity_scores) + [0]


def process_voluntary_exit(state, signed_exit, spec, verify_signatures, get_pubkey):
    preset = spec.preset
    exit_msg = signed_exit.message
    epoch = _current_epoch(state, preset)
    v = state.validators[exit_msg.validator_index]
    _err(v.activation_epoch <= epoch < v.exit_epoch, "validator not active")
    _err(v.exit_epoch == FAR_FUTURE_EPOCH, "exit already initiated")
    _err(epoch >= exit_msg.epoch, "exit epoch in the future")
    _err(
        epoch >= v.activation_epoch + spec.shard_committee_period,
        "validator too young to exit",
    )
    if verify_signatures:
        s = sets.exit_signature_set(state, get_pubkey, signed_exit, spec)
        _err(s.verify(), "exit signature invalid")
    _initiate_validator_exit(state, exit_msg.validator_index, spec)


# ---------------------------------------------------------------------------
# Execution payloads + withdrawals (bellatrix → deneb)
# ---------------------------------------------------------------------------


from functools import lru_cache


@lru_cache(maxsize=32)
def _default_root(cls) -> bytes:
    """hash_tree_root of a default instance — a per-class constant on the
    block-import hot path (merge-complete / empty-payload detection)."""
    return cls().root()


def is_merge_transition_complete(state) -> bool:
    """bellatrix helper: the state has seen a real payload (its stored
    header differs from the default instance)."""
    header = state.latest_execution_payload_header
    return header.root() != _default_root(type(header))


def is_execution_enabled(state, body) -> bool:
    """bellatrix is_execution_enabled: merge complete, or this block IS the
    merge-transition block (carries a non-default payload)."""
    if is_merge_transition_complete(state):
        return True
    payload = body.execution_payload
    return payload.root() != _default_root(type(payload))


def compute_timestamp_at_slot(state, slot: int, spec: ChainSpec) -> int:
    return state.genesis_time + slot * spec.seconds_per_slot


def process_execution_payload(state, body, spec: ChainSpec) -> None:
    """per_block_processing.rs:410 partially_verify_execution_payload +
    header assignment.  The EL validity verdict (notify_new_payload) is the
    chain pipeline's job (beacon/execution.py) — this is the consensus
    portion: parent linkage, randao, timestamp, blob-count gate, header
    update."""
    preset = spec.preset
    payload = body.execution_payload
    if is_merge_transition_complete(state):
        _err(
            bytes(payload.parent_hash)
            == bytes(state.latest_execution_payload_header.block_hash),
            "payload parent_hash does not chain to the stored header",
        )
    elif payload.root() == _default_root(type(payload)):
        # pre-merge bellatrix block with an empty (default) payload:
        # execution is not yet enabled, nothing to process.
        return
    epoch = _current_epoch(state, preset)
    _err(
        bytes(payload.prev_randao)
        == bytes(state.randao_mixes[epoch % preset.epochs_per_historical_vector]),
        "payload prev_randao mismatch",
    )
    _err(
        payload.timestamp == compute_timestamp_at_slot(state, state.slot, spec),
        "payload timestamp mismatch",
    )
    if hasattr(body, "blob_kzg_commitments"):
        _err(
            len(body.blob_kzg_commitments) <= preset.max_blobs_per_block,
            "too many blob kzg commitments",
        )
    state.latest_execution_payload_header = _header_from_payload(state, payload)


def _header_from_payload(state, payload):
    """ExecutionPayloadHeader::from(payload): copy scalars, root the lists."""
    header_cls = type(state.latest_execution_payload_header)
    payload_fields = type(payload)._fields
    kwargs = {}
    for name in header_cls._fields:
        if name == "transactions_root":
            kwargs[name] = payload_fields["transactions"].hash_tree_root(
                payload.transactions
            )
        elif name == "withdrawals_root":
            kwargs[name] = payload_fields["withdrawals"].hash_tree_root(
                payload.withdrawals
            )
        else:
            kwargs[name] = getattr(payload, name)
    return header_cls(**kwargs)


def has_eth1_withdrawal_credential(validator) -> bool:
    return bytes(validator.withdrawal_credentials)[:1] == b"\x01"


def is_fully_withdrawable_validator(validator, balance: int, epoch: int) -> bool:
    return (
        has_eth1_withdrawal_credential(validator)
        and validator.withdrawable_epoch <= epoch
        and balance > 0
    )


def is_partially_withdrawable_validator(validator, balance: int, spec) -> bool:
    return (
        has_eth1_withdrawal_credential(validator)
        and validator.effective_balance == spec.max_effective_balance
        and balance > spec.max_effective_balance
    )


def get_expected_withdrawals(state, spec: ChainSpec) -> list:
    """capella get_expected_withdrawals: a bounded sweep over the registry
    from next_withdrawal_validator_index (per_block_processing.rs:545 twin)."""
    from ..containers import Withdrawal

    preset = spec.preset
    epoch = _current_epoch(state, preset)
    withdrawal_index = state.next_withdrawal_index
    validator_index = state.next_withdrawal_validator_index
    n = len(state.validators)
    withdrawals = []
    for _ in range(min(n, preset.max_validators_per_withdrawals_sweep)):
        v = state.validators[validator_index]
        balance = state.balances[validator_index]
        if is_fully_withdrawable_validator(v, balance, epoch):
            withdrawals.append(
                Withdrawal(
                    index=withdrawal_index,
                    validator_index=validator_index,
                    address=bytes(v.withdrawal_credentials)[12:],
                    amount=balance,
                )
            )
            withdrawal_index += 1
        elif is_partially_withdrawable_validator(v, balance, spec):
            withdrawals.append(
                Withdrawal(
                    index=withdrawal_index,
                    validator_index=validator_index,
                    address=bytes(v.withdrawal_credentials)[12:],
                    amount=balance - spec.max_effective_balance,
                )
            )
            withdrawal_index += 1
        if len(withdrawals) == preset.max_withdrawals_per_payload:
            break
        validator_index = (validator_index + 1) % n
    return withdrawals


def process_withdrawals(state, payload, spec: ChainSpec) -> None:
    """capella process_withdrawals: the payload's withdrawals must equal the
    state's expected list; balances decrease; sweep cursors advance."""
    preset = spec.preset
    expected = get_expected_withdrawals(state, spec)
    got = list(payload.withdrawals)
    _err(len(got) == len(expected), "withdrawal count mismatch")
    for w_got, w_exp in zip(got, expected):
        _err(w_got.root() == w_exp.root(), "withdrawal mismatch")
    for w in expected:
        _decrease_balance(state, w.validator_index, w.amount)
    if expected:
        state.next_withdrawal_index = expected[-1].index + 1
    n = len(state.validators)
    if len(expected) == preset.max_withdrawals_per_payload:
        # full payload: resume right after the last withdrawn validator
        state.next_withdrawal_validator_index = (
            expected[-1].validator_index + 1
        ) % n
    else:
        # sweep exhausted: jump the cursor a full sweep ahead
        state.next_withdrawal_validator_index = (
            state.next_withdrawal_validator_index
            + preset.max_validators_per_withdrawals_sweep
        ) % n


def process_bls_to_execution_change(
    state, signed_change, spec: ChainSpec, verify_signatures: bool = True
) -> None:
    """capella process_bls_to_execution_change: rotate 0x00 BLS withdrawal
    credentials to a 0x01 execution address (signature over the GENESIS
    domain — signature_sets.rs:580)."""
    change = signed_change.message
    _err(change.validator_index < len(state.validators), "unknown validator")
    v = state.validators[change.validator_index]
    wc = bytes(v.withdrawal_credentials)
    _err(wc[:1] == b"\x00", "credentials are not BLS (0x00) form")
    _err(
        wc[1:] == sha256(bytes(change.from_bls_pubkey))[1:],
        "withdrawal credentials do not commit to this pubkey",
    )
    if verify_signatures:
        s = sets.bls_execution_change_signature_set(state, signed_change, spec)
        _err(s.verify(), "bls-to-execution-change signature invalid")
    _update_validator(
        state,
        change.validator_index,
        withdrawal_credentials=(
            b"\x01" + bytes(11) + bytes(change.to_execution_address)
        ),
    )


def process_sync_aggregate(state, aggregate, spec, verify_signatures, get_pubkey):
    """altair/sync_committee.rs: verify over previous slot's block root,
    reward participants + proposer, penalize absentees."""
    import math

    preset = spec.preset
    committee_pubkeys = [bytes(p) for p in state.current_sync_committee.pubkeys]
    pubkey_to_index = {bytes(v.pubkey): i for i, v in enumerate(state.validators)}
    participant_indices = []
    all_indices = []
    for bit, pk in zip(aggregate.sync_committee_bits, committee_pubkeys):
        vi = pubkey_to_index.get(pk)
        _err(vi is not None, "sync committee pubkey unknown")
        all_indices.append(vi)
        if bit:
            participant_indices.append(vi)
    if verify_signatures:
        prev_slot = max(state.slot, 1) - 1
        block_root = _block_root_at_slot(state, prev_slot, preset)
        s = sets.sync_aggregate_signature_set(
            state,
            get_pubkey,
            aggregate,
            participant_indices,
            state.slot,
            block_root,
            preset,
        )
        if s is not None:
            _err(s.verify(), "sync aggregate signature invalid")
    # rewards (spec: total_base_rewards * SYNC_REWARD_WEIGHT split)
    incr = spec.effective_balance_increment
    current = _current_epoch(state, preset)
    total = max(
        sum(
            v.effective_balance
            for v in state.validators
            if v.activation_epoch <= current < v.exit_epoch
        ),
        incr,
    )
    total_incr = total // incr
    base_reward_per_increment = incr * preset.base_reward_factor // math.isqrt(total)
    total_base_rewards = base_reward_per_increment * total_incr
    max_participant_rewards = (
        total_base_rewards
        * SYNC_REWARD_WEIGHT
        // WEIGHT_DENOMINATOR
        // preset.slots_per_epoch
    )
    participant_reward = max_participant_rewards // preset.sync_committee_size
    proposer_reward = (
        participant_reward
        * PROPOSER_WEIGHT
        // (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT)
    )
    proposer = get_beacon_proposer_index(state, state.slot, preset)
    for bit, vi in zip(aggregate.sync_committee_bits, all_indices):
        if bit:
            _increase_balance(state, vi, participant_reward)
            _increase_balance(state, proposer, proposer_reward)
        else:
            _decrease_balance(state, vi, participant_reward)
