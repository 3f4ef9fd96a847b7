"""The port's node layers against the JAX package's, on the same seeded run.

The interop harness (deterministic keys, the minimal preset) runs the same
slots in both packages, each over its python oracle, with every block's
signatures bulk-verified on import (``verify_signatures=True``): the head
root, the head state's root, the justified and finalized checkpoints and
every block's verdict must agree, and a block with one poisoned signature
must be refused by both.  The slow cases run long enough to finalize, and
put one block's signature sets through the port's ``BlockSignatureVerifier``
with ``TorchBackend(device="cpu")`` active (the plain versions of the
kernels: one B = 8 verify costs 25-30 s on one core), against the
reference's verdict.
"""

import copy

import pytest
import torch
from test_torch_node_rig import port_oracle  # noqa: F401

torch.set_num_threads(1)

pytest.importorskip("jax")

from lighthouse_tpu.beacon.harness import BeaconChainHarness as JHarness  # noqa: E402
from lighthouse_tpu.crypto.bls import api as japi  # noqa: E402
from lighthouse_tpu_torch.beacon.harness import BeaconChainHarness as THarness  # noqa: E402

N_VALIDATORS = 16


@pytest.fixture
def both_oracles(port_oracle, monkeypatch):
    """The python oracle active in both packages for one test."""
    monkeypatch.setattr(japi, "_ACTIVE", [japi._BACKENDS["python"]])
    return port_oracle, japi


def _run(harness_cls, slots: int) -> dict:
    """``slots`` blocks, each imported with its signatures verified and
    attested to by every committee; then a next block with its proposer
    signature replaced by the parent's, which must be refused."""
    h = harness_cls(n_validators=N_VALIDATORS, verify_signatures=True)
    verdicts = []
    start = int(h.chain.head_state().slot) + 1
    for slot in range(start, start + slots):
        try:
            root, signed = h.add_block_at_slot(slot)
            verdicts.append(root is not None)
        except Exception:  # noqa: BLE001 — a refused block is a False verdict
            verdicts.append(False)
        h.attest_to_head(slot)
    slot = start + slots
    h.set_slot(slot)
    poisoned = h.chain.produce_block(slot, h.keypairs)
    poisoned = copy.deepcopy(poisoned)
    poisoned.signature = bytes(signed.signature)
    try:
        h.chain.process_block(poisoned, verify_signatures=True)
        poisoned_verdict = True
    except Exception:  # noqa: BLE001
        poisoned_verdict = False
    state = h.head_state()
    return {
        "head": bytes(h.chain.head_root),
        "state_root": bytes(state.root()),
        "slot": int(state.slot),
        "justified": (int(state.current_justified_checkpoint.epoch),
                      bytes(state.current_justified_checkpoint.root)),
        "finalized": tuple(h.chain.fork_choice.finalized_checkpoint[:1])
        + (bytes(h.chain.fork_choice.finalized_checkpoint[1]),),
        "verdicts": verdicts,
        "poisoned": poisoned_verdict,
    }


def _compare(slots: int):
    port, ref = _run(THarness, slots), _run(JHarness, slots)
    assert port == ref
    assert port["verdicts"] == [True] * slots and port["poisoned"] is False
    assert port["slot"] == slots
    return port


def test_seeded_harness_agrees_with_the_reference(both_oracles):
    out = _compare(10)
    assert out["justified"][0] == 0


@pytest.mark.slow
def test_seeded_harness_agrees_through_finality(both_oracles):
    out = _compare(34)
    assert out["finalized"][0] >= 1 and out["justified"][0] >= 2


@pytest.mark.slow
def test_block_sets_through_the_torch_backend_give_the_references_verdict(
        port_oracle, monkeypatch):
    """A signed block's six sets (padded to B = 8) through the port's
    ``BlockSignatureVerifier`` with ``TorchBackend(device="cpu")`` active:
    True, and False with the randao reveal poisoned, as the reference's
    verifier says on its oracle."""
    import test_block_signatures as JB
    import test_torch_block_signatures as TBS
    from lighthouse_tpu.consensus.state_processing.block_signature_verifier import (
        BlockSignatureVerifier as JVerifier)
    from lighthouse_tpu.consensus import spec as JS
    from lighthouse_tpu.consensus.testing import interop_state as j_interop, phase0_spec as j_spec
    from lighthouse_tpu_torch.consensus import spec as TS
    from lighthouse_tpu_torch.consensus.state_processing.block_signature_verifier import (
        BlockSignatureVerifier as TVerifier)
    from lighthouse_tpu_torch.consensus.testing import (
        interop_state as t_interop, phase0_spec as t_spec)
    from lighthouse_tpu_torch.crypto.bls.torch_backend.backend import TorchBackend

    monkeypatch.setattr(japi, "_ACTIVE", [japi._BACKENDS["python"]])
    bk = TorchBackend(device="cpu")
    monkeypatch.setattr(port_oracle, "_BACKENDS", {**port_oracle._BACKENDS, "torch": bk})
    port_oracle.set_backend("torch")

    def verdicts(mod, verifier, spec_fn, interop, S):
        spec = spec_fn(S.MINIMAL)
        state, keypairs = interop(JB.N_VALIDATORS, spec)
        out = []
        for poison in (False, True):
            signed, cache, get_pk = mod._build_signed_block(spec, state, keypairs)
            if poison:
                signed.message.body.randao_reveal = keypairs[0][0].sign(b"\xee" * 32).to_bytes()
            v = verifier(state, get_pk, spec)
            v.include_all(signed, lambda epoch: cache)
            out.append((len(v.sets), v.verify()))
        return out

    port = verdicts(TBS, TVerifier, t_spec, t_interop, TS)
    ref = verdicts(JB, JVerifier, j_spec, j_interop, JS)
    assert port == ref == [(6, True), (6, False)]
    assert [k[0] for k in bk.builds] == [8]
