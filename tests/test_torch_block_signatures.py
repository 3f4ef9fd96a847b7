"""Twin of tests/test_block_signatures.py on the port's copies: a synthetic
signed block's sets verify through the batch path.

Mirrors the reference's block_signature_verifier tests: build a minimal-spec
interop state, sign a block (proposal + randao + attestation + exit +
proposer slashing) with the real interop keys, collect every set with
BlockSignatureVerifier, verify in one batch — then poison one signature and
require rejection (the AND-reduce semantics of
block_signature_verifier.rs:396-405).  The port's registry starts with no
engine: each test runs on its python oracle (``port_oracle``).  The same
verifier over ``TorchBackend`` is in test_torch_node_differential.py.
"""

import pytest
import torch
from test_torch_node_rig import port_oracle  # noqa: F401

torch.set_num_threads(1)

from lighthouse_tpu_torch.consensus import committees as cm
from lighthouse_tpu_torch.consensus import spec as S
from lighthouse_tpu_torch.consensus.containers import (  # noqa: E402
    Attestation,
    AttestationData,
    BeaconBlockHeader,
    Checkpoint,
    ProposerSlashing,
    SignedBeaconBlockHeader,
    SignedVoluntaryExit,
    VoluntaryExit,
    types_for,
)
from lighthouse_tpu_torch.consensus.state_processing import signature_sets as sets
from lighthouse_tpu_torch.consensus.state_processing.block_signature_verifier import (  # noqa: E402
    BlockSignatureVerifier,
)
from lighthouse_tpu_torch.consensus.testing import (  # noqa: E402
    interop_state,
    phase0_spec,
    pubkey_getter,
)
from lighthouse_tpu_torch.crypto.bls import api as bls

N_VALIDATORS = 32


@pytest.fixture(scope="module")
def fixture():
    spec = phase0_spec(S.MINIMAL)
    state, keypairs = interop_state(N_VALIDATORS, spec)
    return spec, state, keypairs


def _sign(sk, obj, domain):
    return sk.sign(S.compute_signing_root(obj, domain)).to_bytes()


def _build_signed_block(spec, state, keypairs, slot=1):
    preset = spec.preset
    T = types_for(preset)
    cache = cm.CommitteeCache(state, 0, preset)
    get_pk = pubkey_getter(state)
    fork = state.fork
    gvr = state.genesis_validators_root

    # --- attestation signed by its real committee -------------------------
    att_slot, att_index = 0, 0
    committee = cache.committee(att_slot, att_index)
    data = AttestationData(
        slot=att_slot,
        index=att_index,
        beacon_block_root=b"\x42" * 32,
        source=Checkpoint(epoch=0, root=bytes(32)),
        target=Checkpoint(epoch=0, root=b"\x10" * 32),
    )
    att_domain = sets.get_domain(fork, gvr, S.DOMAIN_BEACON_ATTESTER, 0)
    root = S.compute_signing_root(data, att_domain)
    sigs = [keypairs[v][0].sign(root) for v in committee]
    agg = bls.AggregateSignature.aggregate(sigs)
    attestation = Attestation(
        aggregation_bits=[True] * len(committee),
        data=data,
        signature=agg.to_bytes(),
    )

    # --- voluntary exit ----------------------------------------------------
    exiting = 7
    exit_msg = VoluntaryExit(epoch=0, validator_index=exiting)
    exit_domain = sets.get_domain(fork, gvr, S.DOMAIN_VOLUNTARY_EXIT, 0)
    signed_exit = SignedVoluntaryExit(
        message=exit_msg, signature=_sign(keypairs[exiting][0], exit_msg, exit_domain)
    )

    # --- proposer slashing (two conflicting headers, same slot) ------------
    slashed = 9
    prop_domain = sets.get_domain(fork, gvr, S.DOMAIN_BEACON_PROPOSER, 0)
    h1 = BeaconBlockHeader(slot=0, proposer_index=slashed, body_root=b"\x01" * 32)
    h2 = BeaconBlockHeader(slot=0, proposer_index=slashed, body_root=b"\x02" * 32)
    slashing = ProposerSlashing(
        signed_header_1=SignedBeaconBlockHeader(
            message=h1, signature=_sign(keypairs[slashed][0], h1, prop_domain)
        ),
        signed_header_2=SignedBeaconBlockHeader(
            message=h2, signature=_sign(keypairs[slashed][0], h2, prop_domain)
        ),
    )

    # --- the block ----------------------------------------------------------
    proposer = cm.get_beacon_proposer_index(state, slot, preset)
    sk_prop = keypairs[proposer][0]
    epoch = slot // preset.slots_per_epoch
    randao_domain = sets.get_domain(fork, gvr, S.DOMAIN_RANDAO, epoch)
    from lighthouse_tpu_torch.consensus.ssz import U64
    from lighthouse_tpu_torch.consensus.containers import SigningData

    randao_root = SigningData(
        object_root=U64.hash_tree_root(epoch), domain=randao_domain
    ).root()
    body = T.BeaconBlockBody(
        randao_reveal=sk_prop.sign(randao_root).to_bytes(),
        attestations=[attestation],
        voluntary_exits=[signed_exit],
        proposer_slashings=[slashing],
    )
    block = T.BeaconBlock(
        slot=slot, proposer_index=proposer, parent_root=b"\x33" * 32, body=body
    )
    block_domain = sets.get_domain(
        fork, gvr, S.DOMAIN_BEACON_PROPOSER, slot // preset.slots_per_epoch
    )
    signed_block = T.SignedBeaconBlock(
        message=block, signature=_sign(sk_prop, block, block_domain)
    )
    return signed_block, cache, get_pk


def test_entire_block_verifies(fixture, port_oracle):
    spec, state, keypairs = fixture
    signed_block, cache, get_pk = _build_signed_block(spec, state, keypairs)
    v = BlockSignatureVerifier(state, get_pk, spec)
    v.include_all(signed_block, lambda epoch: cache)
    assert len(v.sets) == 6  # proposal, randao, 2x slashing hdr, attestation, exit
    assert v.verify() is True


def test_poisoned_block_rejected(fixture, port_oracle):
    spec, state, keypairs = fixture
    signed_block, cache, get_pk = _build_signed_block(spec, state, keypairs)
    # corrupt the randao reveal (swap in the signature of a different epoch)
    signed_block.message.body.randao_reveal = keypairs[0][0].sign(b"\xee" * 32).to_bytes()
    v = BlockSignatureVerifier(state, get_pk, spec)
    v.include_all(signed_block, lambda epoch: cache)
    assert v.verify() is False


def test_unknown_validator_is_structural_error(fixture, port_oracle):
    spec, state, keypairs = fixture
    signed_block, cache, get_pk = _build_signed_block(spec, state, keypairs)
    signed_block.message.proposer_index = 10_000
    v = BlockSignatureVerifier(state, get_pk, spec)
    with pytest.raises(sets.SignatureSetError):
        v.include_block_proposal(signed_block)


def test_committee_cache_shapes(fixture, port_oracle):
    spec, state, _ = fixture
    cache = cm.CommitteeCache(state, 0, spec.preset)
    per_slot = cache.committees_per_slot
    assert per_slot >= 1
    total = sum(
        len(c)
        for s in range(spec.preset.slots_per_epoch)
        for c in cache.committees_at_slot(s)
    )
    assert total == N_VALIDATORS  # every active validator sits in exactly one
