"""BeaconChainHarness: the in-process integration rig.

Twin of beacon_node/beacon_chain/src/test_utils.rs:149-638 (deterministic
keypairs :324, TestingSlotClock :490, MemoryStore default): drives a real
BeaconChain — produce blocks, attest with every scheduled committee, hop
slots — against the minimal preset.  Crypto runs either for real (oracle
backend) or skipped (the fake_crypto pattern: consensus logic isolated from
crypto cost, Makefile:142-145).
"""

from __future__ import annotations

from ..consensus import committees as cm
from ..consensus import spec as S
from ..consensus.containers import (
    Attestation,
    AttestationData,
    Checkpoint,
)
from ..consensus.state_processing import signature_sets as sets
from ..consensus.testing import interop_state, phase0_spec, interop_keypairs
from ..crypto.bls import api as bls
from ..utils import ManualSlotClock
from .chain import BeaconChain


class BeaconChainHarness:
    def __init__(
        self,
        n_validators: int = 32,
        spec: S.ChainSpec | None = None,
        fork: str = "altair",
        verify_signatures: bool = False,
        store=None,
    ):
        self.spec = spec or phase0_spec(S.MINIMAL)
        self.preset = self.spec.preset
        self.fork = fork
        self.verify_signatures = verify_signatures
        state, self.keypairs = interop_state(n_validators, self.spec, fork=fork)
        self.clock = ManualSlotClock(
            genesis_time=float(state.genesis_time),
            seconds_per_slot=self.spec.seconds_per_slot,
        )
        self.chain = BeaconChain(
            self.spec, state, store=store, slot_clock=self.clock, fork=fork
        )

    # ------------------------------------------------------------ driving

    def set_slot(self, slot: int) -> None:
        self.clock.set_slot(slot)

    def make_attestations(self, slot: int, head_root: bytes | None = None):
        """Sign attestations for every committee scheduled at `slot`, from
        the head state's view (the harness's attest_to_current_epoch)."""
        head_root = head_root or self.chain.head_root
        state = self.chain.state_for_block(head_root)
        epoch = slot // self.preset.slots_per_epoch
        cache = self.chain.committee_cache(state, epoch)
        out = []
        target_slot = epoch * self.preset.slots_per_epoch
        target_root = (
            head_root
            if int(state.slot) <= target_slot
            else bytes(
                state.block_roots[
                    target_slot % self.preset.slots_per_historical_root
                ]
            )
        )
        for index in range(cache.committees_per_slot):
            committee = cache.committee(slot, index)
            data = AttestationData(
                slot=slot,
                index=index,
                beacon_block_root=head_root,
                source=state.current_justified_checkpoint,
                target=Checkpoint(epoch=epoch, root=target_root),
            )
            domain = sets.get_domain(
                state.fork,
                state.genesis_validators_root,
                S.DOMAIN_BEACON_ATTESTER,
                epoch,
            )
            root = S.compute_signing_root(data, domain)
            sigs = [self.keypairs[int(v)][0].sign(root) for v in committee]
            out.append(
                Attestation(
                    aggregation_bits=[True] * len(committee),
                    data=data,
                    signature=bls.AggregateSignature.aggregate(sigs).to_bytes(),
                )
            )
        return out

    def add_block_at_slot(self, slot: int):
        """Produce + import one block (with whatever the op pool holds)."""
        self.set_slot(slot)
        signed = self.chain.produce_block(slot, self.keypairs)
        root = self.chain.process_block(
            signed, verify_signatures=self.verify_signatures
        )
        return root, signed

    def attest_to_head(self, slot: int) -> int:
        """All committees at `slot` attest to the current head; fed through
        the chain's gossip path.  Returns attestation count."""
        atts = self.make_attestations(slot)
        for att in atts:
            self.chain.process_attestation(att, current_slot=slot)
        return len(atts)

    def extend_chain(self, num_blocks: int, attest: bool = True) -> list[bytes]:
        """Block per slot from the next slot on, attesting each slot (the
        harness extend_chain)."""
        start = int(self.chain.head_state().slot) + 1
        roots = []
        for slot in range(start, start + num_blocks):
            root, _ = self.add_block_at_slot(slot)
            if attest:
                self.attest_to_head(slot)
            roots.append(root)
        return roots

    # ------------------------------------------------------------- views

    def head_state(self):
        return self.chain.head_state()

    def finalized_epoch(self) -> int:
        return self.chain.fork_choice.finalized_checkpoint[0]

    def justified_epoch(self) -> int:
        return int(self.head_state().current_justified_checkpoint.epoch)
