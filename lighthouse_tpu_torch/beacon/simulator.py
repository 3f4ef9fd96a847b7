"""In-process multi-node simulator.

Twin of testing/simulator (+node_test_rig): N beacon nodes in one process
(testing/simulator/src/main.rs:1-14), minimal spec, shared interop genesis,
connected over the in-process gossip mesh (lighthouse_tpu.network.gossip)
speaking the real wire encodings (SSZ + snappy + spec message ids).  Each
node runs a full BeaconChain; one node proposes per slot (the validator set
is partitioned across nodes, but any node's keys can propose since interop
keys are shared — mirroring the simulator's local validator clients), and
every node imports blocks/attestations only through its gossip handlers.

Liveness checks (checks.rs analog) live in the tests: all heads converge,
finalization advances on every node.
"""

from __future__ import annotations

from ..consensus import spec as S
from ..consensus.containers import Attestation, types_for
from ..consensus.testing import interop_state, phase0_spec
from ..network import gossip, topics
from ..utils import ManualSlotClock
from .chain import BeaconChain, BlockError
from .harness import BeaconChainHarness


class SimNode:
    def __init__(self, node_id: str, spec: S.ChainSpec, genesis_state,
                 router: gossip.GossipRouter, fork: str = "altair",
                 committee_caches: dict | None = None,
                 slasher: bool = False,
                 pubkey_cache=None):
        self.node_id = node_id
        self.spec = spec
        self.clock = ManualSlotClock(
            genesis_time=float(genesis_state.genesis_time),
            seconds_per_slot=spec.seconds_per_slot,
        )
        self.chain = BeaconChain(
            spec, genesis_state, store=None, slot_clock=self.clock, fork=fork,
            committee_caches=committee_caches, pubkey_cache=pubkey_cache,
        )
        self.gossip = gossip.GossipNode(node_id, router)
        self.fork = fork
        # optional in-node slasher (service.rs analog): every gossiped
        # block's header is fed BEFORE import so equivocations are seen
        # even when fork choice never adopts the second block.  Constructed
        # lazily on first access (cheap-node path: dozens of nodes, most of
        # which never see a slashable offence, skip the surface setup).
        self._slasher_enabled = slasher
        self._slasher = None
        gvr = bytes(genesis_state.genesis_validators_root)
        digest = topics.fork_digest(spec, 0, gvr)
        self.block_topic = topics.topic("beacon_block", digest)
        self.att_topics = [
            topics.attestation_subnet_topic(i, digest)
            for i in range(spec.attestation_subnet_count)
        ]
        self.gossip.subscribe(self.block_topic, self._on_block)
        for t in self.att_topics:
            self.gossip.subscribe(t, self._on_attestation)

    @property
    def slasher(self):
        if self._slasher is None and self._slasher_enabled:
            from ..slasher import Slasher

            self._slasher = Slasher()
        return self._slasher

    # ------------------------------------------------------- gossip handlers

    def _on_block(self, payload: bytes, from_peer: str) -> str:
        cls = self.chain.types.SignedBeaconBlock_BY_FORK[self.fork]
        try:
            signed = cls.deserialize_value(payload)
        except Exception:
            return "reject"
        self._feed_slasher_header(signed)
        try:
            self.chain.process_block(signed, verify_signatures=False)
            return "accept"
        except BlockError as e:
            if "already known" in str(e):
                return "ignore"
            return "reject"

    def _feed_slasher_header(self, signed_block) -> None:
        if self.slasher is None:
            return
        from ..consensus.containers import (
            BeaconBlockHeader,
            SignedBeaconBlockHeader,
        )

        msg = signed_block.message
        self.slasher.accept_block_header(
            SignedBeaconBlockHeader(
                message=BeaconBlockHeader(
                    slot=int(msg.slot),
                    proposer_index=int(msg.proposer_index),
                    parent_root=bytes(msg.parent_root),
                    state_root=bytes(msg.state_root),
                    body_root=msg.body.root(),
                ),
                signature=bytes(signed_block.signature),
            )
        )

    def poll_slasher(self) -> tuple[list, list]:
        """One slasher tick: process queued headers/attestations, push any
        slashings into the op pool so this node's next proposal carries
        them.  Returns (attester_slashings, proposer_slashings)."""
        if self.slasher is None:
            return [], []
        epoch = int(self.chain.head_state().slot) // (
            self.spec.preset.slots_per_epoch
        )
        att_slashings, prop_slashings = self.slasher.process_queued(epoch)
        for s in att_slashings:
            self.chain.op_pool.insert_attester_slashing(s)
        for s in prop_slashings:
            self.chain.op_pool.insert_proposer_slashing(s)
        return att_slashings, prop_slashings

    def _on_attestation(self, payload: bytes, from_peer: str) -> str:
        try:
            att = Attestation.deserialize_value(payload)
        except Exception:
            return "reject"
        try:
            self.chain.process_attestation(
                att, current_slot=self.clock.current_slot()
            )
            return "accept"
        except Exception:
            return "ignore"  # e.g. dedup or unknown head during sync races

    # ------------------------------------------------------------ publishing

    def publish_block(self, signed) -> None:
        self.chain.process_block(signed, verify_signatures=False)
        self.gossip.publish(self.block_topic, signed.encode())

    def publish_attestation(self, att: Attestation) -> None:
        cps = self.chain.committee_cache(
            self.chain.head_state(),
            int(att.data.slot) // self.spec.preset.slots_per_epoch,
        ).committees_per_slot
        subnet = topics.compute_subnet_for_attestation(
            self.spec, int(att.data.slot), int(att.data.index), cps
        )
        try:
            self.chain.process_attestation(
                att, current_slot=self.clock.current_slot()
            )
        except Exception:
            pass
        self.gossip.publish(self.att_topics[subnet], att.encode())


class Simulator:
    """N in-process SimNodes over one gossip mesh.

    ``injector``: optional FaultInjector wired into the router's
    per-delivery ``gossip.route`` site (lossy/corrupting wire).
    ``slasher``: give every node an in-node slasher service.
    All nodes share one committee-cache dict (identical histories →
    identical shufflings) and the cached interop genesis, so dozens of
    nodes cost roughly one node's setup.
    """

    def __init__(self, n_nodes: int = 3, n_validators: int = 32,
                 fork: str = "altair", injector=None, slasher: bool = False,
                 registry_padding: int = 0,
                 spec_overrides: tuple = ()):
        import dataclasses

        from .chain import ValidatorPubkeyCache

        spec = phase0_spec(S.MINIMAL)
        if spec_overrides:
            kv = dict(spec_overrides)
            # route preset-level keys (slots_per_epoch, max_deposits, ...)
            # into the nested Preset so scenarios can reshape drain math
            preset_kv = {
                k: kv.pop(k)
                for k in list(kv)
                if k not in spec.__dataclass_fields__
                and k in spec.preset.__dataclass_fields__
            }
            if preset_kv:
                spec = dataclasses.replace(
                    spec,
                    preset=dataclasses.replace(spec.preset, **preset_kv),
                )
            if kv:
                spec = dataclasses.replace(spec, **kv)
        self.spec = spec
        genesis, self.keypairs = interop_state(
            n_validators, self.spec, fork=fork,
            registry_padding=registry_padding,
        )
        self.router = gossip.GossipRouter(injector=injector)
        shared_caches: dict = {}
        # one lazy pubkey cache for the whole mesh: the registry prefix is
        # identical chain-wide, so decompressing a pubkey once serves all
        # nodes (cheap-node path)
        shared_pubkeys = ValidatorPubkeyCache()
        self.nodes = [
            SimNode(f"node{i}", self.spec, genesis, self.router, fork,
                    committee_caches=shared_caches, slasher=slasher,
                    pubkey_cache=shared_pubkeys)
            for i in range(n_nodes)
        ]
        # a driver harness view for producing blocks/attestations with keys
        self._producer = BeaconChainHarness.__new__(BeaconChainHarness)
        self._producer.spec = self.spec
        self._producer.preset = self.spec.preset
        self._producer.fork = fork
        self._producer.keypairs = self.keypairs

    def run_slot(self, slot: int) -> None:
        """One protocol slot: the proposer node builds + gossips a block;
        every node's committees attest through gossip."""
        proposer_node = self.proposer_node(slot)
        for node in self.nodes:
            node.clock.set_slot(slot)
        signed = proposer_node.chain.produce_block(slot, self.keypairs)
        proposer_node.publish_block(signed)
        self.attest(slot, proposer_node)

    # ---------------------------------------------------- scenario hooks

    def proposer_node(self, slot: int) -> SimNode:
        return self.nodes[slot % len(self.nodes)]

    def set_slot(self, slot: int) -> None:
        for node in self.nodes:
            node.clock.set_slot(slot)

    def attest(self, slot: int, view_node: SimNode | None = None,
               keep=None) -> list:
        """Sign + gossip every committee attestation scheduled at ``slot``
        from ``view_node``'s head view (committees are identical across
        honest nodes).  ``keep`` (att -> bool) suppresses publication of
        filtered-out attestations — the finality-stall lever.  Returns the
        published attestations for traffic shapes that re-publish or flood
        them."""
        view_node = view_node or self.proposer_node(slot)
        self._producer.chain = view_node.chain
        atts = BeaconChainHarness.make_attestations(self._producer, slot)
        if keep is not None:
            atts = [att for att in atts if keep(att)]
        for att in atts:
            attester_node = self.nodes[int(att.data.index) % len(self.nodes)]
            attester_node.publish_attestation(att)
        return atts

    def propose_on(self, slot: int, parent_root: bytes,
                   graffiti: bytes = b"", node: SimNode | None = None):
        """Build + gossip a block at ``slot`` anchored on an explicit
        ``parent_root`` instead of the producing node's head — the lever
        behind proposer-reorg and equivocation traffic shapes."""
        node = node or self.proposer_node(slot)
        chain = node.chain
        prev_head = chain.head_root
        chain.head_root = parent_root
        try:
            signed = chain.produce_block(slot, self.keypairs,
                                         graffiti=graffiti)
        finally:
            chain.head_root = prev_head
        node.publish_block(signed)
        return signed

    def propose_equivocation(self, slot: int) -> tuple:
        """The scheduled proposer double-proposes: two conflicting blocks
        for the same slot on the same parent (differing graffiti), both
        gossiped — the slashable offence the in-node slashers must catch.
        Returns (block_a, block_b)."""
        node = self.proposer_node(slot)
        self.set_slot(slot)
        parent = node.chain.head_root
        a = node.chain.produce_block(slot, self.keypairs, graffiti=b"a")
        node.publish_block(a)
        b = self.propose_on(slot, parent, graffiti=b"b", node=node)
        return a, b

    def poll_slashers(self) -> int:
        """Tick every node's slasher; total slashings found this poll."""
        found = 0
        for node in self.nodes:
            atts, props = node.poll_slasher()
            found += len(atts) + len(props)
        return found

    def run_slots(self, first: int, count: int) -> None:
        for slot in range(first, first + count):
            self.run_slot(slot)

    # ---------------------------------------------------------- liveness

    def heads(self) -> list[bytes]:
        return [n.chain.recompute_head() for n in self.nodes]

    def finalized_epochs(self) -> list[int]:
        return [n.chain.fork_choice.finalized_checkpoint[0] for n in self.nodes]
