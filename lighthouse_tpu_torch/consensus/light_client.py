"""Light-client sync protocol: bootstrap/update containers + branch proofs.

Twin of the reference's light-client surface (consensus/types light-client
containers; beacon_node light-client server feeding the
light_client_{finality,optimistic}_update gossip topics in topics.rs).

Proof machinery: a container's fields form the leaves of its Merkle tree
(padded to a power of two), so any field has a generalized index
``2^depth + field_index``; `field_proof` produces the branch and
`verify_merkle_proof` (consensus.merkle) checks it — e.g. the altair
BeaconState's next_sync_committee sits at gindex 55 (field 23 of 24, depth
5), matching the spec constant because the field ORDER here matches the
spec order.
"""

from __future__ import annotations

from .containers import BeaconBlockHeader, Container, F
from .merkle import merkle_root_from_branch
from .ssz import SSZList, U64, Vector, _merkleize_chunks, _zero_hashes


def _field_roots(obj) -> list[bytes]:
    cls = type(obj)
    return [t.hash_tree_root(getattr(obj, f)) for f, t in cls._fields.items()]


def field_index(cls, field_name: str) -> int:
    return list(cls._fields).index(field_name)


def field_gindex(cls, field_name: str) -> int:
    n = len(cls._fields)
    depth = max(n - 1, 0).bit_length()
    return (1 << depth) + field_index(cls, field_name)


def field_proof(obj, field_name: str) -> tuple[bytes, list[bytes], int]:
    """(leaf_root, branch, depth) for one field of a container instance.
    Branch is bottom-up, suitable for merkle.verify_merkle_proof with
    index = field_index."""
    cls = type(obj)
    leaves = _field_roots(obj)
    n = len(leaves)
    depth = max(n - 1, 0).bit_length()
    size = 1 << depth
    nodes = leaves + [_zero_hashes[0]] * (size - n)
    idx = field_index(cls, field_name)
    branch: list[bytes] = []
    from ..ops import sha256

    level_nodes = nodes
    i = idx
    for level in range(depth):
        sibling = i ^ 1
        branch.append(
            level_nodes[sibling]
            if sibling < len(level_nodes)
            else _zero_hashes[level]
        )
        level_nodes = [
            sha256(level_nodes[2 * k] + level_nodes[2 * k + 1])
            for k in range(len(level_nodes) // 2)
        ]
        i //= 2
    return leaves[idx], branch, depth


# ---------------------------------------------------------------------------
# containers (per-preset family would only vary SyncCommittee size; built
# against a supplied types family)
# ---------------------------------------------------------------------------


class LightClientHeader(Container):
    fields = {
        "beacon": F(BeaconBlockHeader),
    }


def light_client_types(T):
    """Build the preset-shaped light-client containers over a TypesFamily
    (cached on T — class identity must be stable across calls)."""
    cached = getattr(T, "_lc_types", None)
    if cached is not None:
        return cached

    class LightClientBootstrap(Container):
        fields = {
            "header": F(LightClientHeader),
            "current_sync_committee": F(T.SyncCommittee),
            "current_sync_committee_branch": SSZList(
                __import__(
                    "lighthouse_tpu_torch.consensus.containers", fromlist=["Root"]
                ).Root,
                16,
            ),
        }

    class LightClientUpdate(Container):
        fields = {
            "attested_header": F(LightClientHeader),
            "next_sync_committee": F(T.SyncCommittee),
            "next_sync_committee_branch": SSZList(
                __import__(
                    "lighthouse_tpu_torch.consensus.containers", fromlist=["Root"]
                ).Root,
                16,
            ),
            "finalized_header": F(LightClientHeader),
            "finality_branch": SSZList(
                __import__(
                    "lighthouse_tpu_torch.consensus.containers", fromlist=["Root"]
                ).Root,
                16,
            ),
            "sync_aggregate": F(T.SyncAggregate),
            "signature_slot": U64,
        }

    T._lc_types = (LightClientBootstrap, LightClientUpdate)
    return T._lc_types


# ---------------------------------------------------------------------------
# server + verifier
# ---------------------------------------------------------------------------


def build_bootstrap(state, header: BeaconBlockHeader, T):
    """The light-client server half: prove current_sync_committee into the
    state root the header commits to."""
    Bootstrap, _ = light_client_types(T)
    leaf, branch, depth = field_proof(state, "current_sync_committee")
    return Bootstrap(
        header=LightClientHeader(beacon=header),
        current_sync_committee=state.current_sync_committee,
        current_sync_committee_branch=branch,
    )


def verify_bootstrap(bootstrap, T) -> bool:
    """Client half: the committee must prove into the header's state root."""
    state_cls = T.BeaconState_BY_FORK["altair"]
    idx = field_index(state_cls, "current_sync_committee")
    depth = max(len(state_cls._fields) - 1, 0).bit_length()
    if len(bootstrap.current_sync_committee_branch) != depth:
        return False  # attacker-length branch must not crash the caller
    leaf = T.SyncCommittee.hash_tree_root_value(
        bootstrap.current_sync_committee
    )
    root = merkle_root_from_branch(
        leaf,
        [bytes(b) for b in bootstrap.current_sync_committee_branch],
        depth,
        idx,
    )
    return root == bytes(bootstrap.header.beacon.state_root)


# ---------------------------------------------------------------------------
# finality / optimistic updates (types/src/light_client_{finality,
# optimistic}_update.rs) + the follower-side store (consensus/src/
# light_client_update.rs process flow, scaled to in-repo proofs)
# ---------------------------------------------------------------------------


def light_client_update_types(T):
    """(LightClientFinalityUpdate, LightClientOptimisticUpdate) over a
    TypesFamily — the two gossip-served update shapes.  Cached on T:
    these sit on the per-gossip-message path, and Container equality
    requires identical classes across calls."""
    cached = getattr(T, "_lc_update_types", None)
    if cached is not None:
        return cached
    from .containers import Root

    class LightClientFinalityUpdate(Container):
        fields = {
            "attested_header": F(LightClientHeader),
            "finalized_header": F(LightClientHeader),
            "finality_branch": SSZList(Root, 16),
            "sync_aggregate": F(T.SyncAggregate),
            "signature_slot": U64,
        }

    class LightClientOptimisticUpdate(Container):
        fields = {
            "attested_header": F(LightClientHeader),
            "sync_aggregate": F(T.SyncAggregate),
            "signature_slot": U64,
        }

    T._lc_update_types = (LightClientFinalityUpdate, LightClientOptimisticUpdate)
    return T._lc_update_types


def build_optimistic_update(attested_header, sync_aggregate, signature_slot,
                            T):
    _, Optimistic = light_client_update_types(T)
    return Optimistic(
        attested_header=LightClientHeader(beacon=attested_header),
        sync_aggregate=sync_aggregate,
        signature_slot=signature_slot,
    )


def build_finality_update(
    attested_state, attested_header, finalized_header, sync_aggregate,
    signature_slot, T,
):
    """Prove the attested state's finalized_checkpoint and wrap the whole
    finality evidence (the server half feeding the
    light_client_finality_update topic)."""
    Finality, _ = light_client_update_types(T)
    leaf, state_branch, depth = field_proof(
        attested_state, "finalized_checkpoint"
    )
    # spec-shaped two-level branch (FINALIZED_ROOT gindex): the leaf is
    # checkpoint.ROOT; the checkpoint's epoch leaf rides as the first
    # sibling (root is field 1 of Checkpoint{epoch, root})
    epoch_leaf = U64.hash_tree_root(
        attested_state.finalized_checkpoint.epoch
    )
    return Finality(
        attested_header=LightClientHeader(beacon=attested_header),
        finalized_header=LightClientHeader(beacon=finalized_header),
        finality_branch=[epoch_leaf] + [bytes(b) for b in state_branch],
        sync_aggregate=sync_aggregate,
        signature_slot=signature_slot,
    )


def _verify_sync_aggregate(
    attested_header, sync_aggregate, committee_pubkeys, spec,
    genesis_validators_root, signature_slot: int,
) -> bool:
    """The signature check shared by both update kinds: the participating
    committee members signed the attested block root under
    DOMAIN_SYNC_COMMITTEE at the SIGNING slot's epoch — signature_slot-1,
    the message slot (mirrors ValidatorStore.sign_sync_committee_message
    and the spec; the attested slot can lag across skipped slots and
    would pick the wrong fork version at a boundary)."""
    from ..crypto.bls import api as bls
    from . import spec as S
    from .containers import SigningData
    from .ssz import ByteVector

    bits = [bool(b) for b in sync_aggregate.sync_committee_bits]
    participants = [
        pk for pk, bit in zip(committee_pubkeys, bits) if bit
    ]
    if not participants:
        return False
    epoch = max(int(signature_slot), 1) - 1
    epoch //= spec.preset.slots_per_epoch
    fork_version = spec.fork_version_at_epoch(epoch)
    domain = S.compute_domain(
        S.DOMAIN_SYNC_COMMITTEE, fork_version, genesis_validators_root
    )
    block_root = attested_header.root()
    signing_root = SigningData(
        object_root=ByteVector(32).hash_tree_root(block_root), domain=domain
    ).root()
    try:
        pks = [bls.PublicKey.from_bytes(bytes(pk)) for pk in participants]
        sig = bls.Signature.from_bytes(
            bytes(sync_aggregate.sync_committee_signature)
        )
        return bls.fast_aggregate_verify(pks, signing_root, sig)
    except Exception:  # noqa: BLE001
        return False


def verify_optimistic_update(
    update, committee_pubkeys, spec, genesis_validators_root
) -> bool:
    return _verify_sync_aggregate(
        update.attested_header.beacon, update.sync_aggregate,
        committee_pubkeys, spec, genesis_validators_root,
        int(update.signature_slot),
    )


def verify_finality_update(
    update, committee_pubkeys, spec, genesis_validators_root, T,
    min_participation_num: int = 2, min_participation_den: int = 3,
) -> bool:
    """Signature + supermajority + the finality branch proving the
    finalized checkpoint into the attested header's state root."""
    bits = [bool(b) for b in update.sync_aggregate.sync_committee_bits]
    if sum(bits) * min_participation_den < len(bits) * min_participation_num:
        return False
    if not _verify_sync_aggregate(
        update.attested_header.beacon, update.sync_aggregate,
        committee_pubkeys, spec, genesis_validators_root,
        int(update.signature_slot),
    ):
        return False
    from .ssz import ByteVector

    state_cls = T.BeaconState_BY_FORK["altair"]
    idx = field_index(state_cls, "finalized_checkpoint")
    depth = max(len(state_cls._fields) - 1, 0).bit_length()
    # two-level proof: checkpoint.root is field 1 of Checkpoint, so the
    # generalized position is idx*2 + 1 at depth+1, with the epoch leaf
    # as the first sibling in the branch (build_finality_update's shape)
    if len(update.finality_branch) != depth + 1:
        return False  # wrong-length branch is a malformed update, not a crash
    finalized_root = update.finalized_header.beacon.root()
    root = merkle_root_from_branch(
        ByteVector(32).hash_tree_root(finalized_root),
        [bytes(b) for b in update.finality_branch],
        depth + 1,
        idx * 2 + 1,
    )
    return root == bytes(update.attested_header.beacon.state_root)


class LightClientStore:
    """Follower state (the reference light-client's Store): bootstrap
    pins the committee; gossip updates advance the optimistic and
    finalized heads; full LightClientUpdates rotate the committee across
    sync-committee periods — no block download, ever."""

    def __init__(self, bootstrap, spec, genesis_validators_root, T):
        if not verify_bootstrap(bootstrap, T):
            raise ValueError("bootstrap proof invalid")
        self.T = T
        self.spec = spec
        self.gvr = genesis_validators_root
        self.committee_pubkeys = [
            bytes(pk) for pk in bootstrap.current_sync_committee.pubkeys
        ]
        self.period = sync_committee_period(
            int(bootstrap.header.beacon.slot), spec
        )
        self.next_committee_pubkeys: list[bytes] | None = None
        self.optimistic_header = bootstrap.header.beacon
        self.finalized_header = bootstrap.header.beacon

    def _lookup_committee(self, signature_slot: int):
        """(pubkeys, rotates) for the committee whose signature covers
        ``signature_slot`` (signing happens at signature_slot - 1), or
        None if the store cannot verify that period.  PURE — rotation is
        committed by _commit_rotation only AFTER a signature verifies, so
        garbage updates cannot consume the rotation fuel."""
        period = sync_committee_period(
            max(signature_slot, 1) - 1, self.spec
        )
        if period == self.period:
            return self.committee_pubkeys, False
        if period == self.period + 1 and self.next_committee_pubkeys:
            return self.next_committee_pubkeys, True
        return None

    def _commit_rotation(self, rotates: bool) -> None:
        if rotates:
            self.committee_pubkeys = self.next_committee_pubkeys
            self.next_committee_pubkeys = None
            self.period += 1

    def process_light_client_update(self, update) -> bool:
        """Full update: learn the NEXT committee (rotation fuel).  The
        attested header must sit in the SAME period as the signature —
        a boundary-straddling update would teach the wrong committee."""
        sig_slot = int(update.signature_slot)
        looked = self._lookup_committee(sig_slot)
        if looked is None:
            return False
        pks, rotates = looked
        sig_period = sync_committee_period(
            max(sig_slot, 1) - 1, self.spec
        )
        att_period = sync_committee_period(
            int(update.attested_header.beacon.slot), self.spec
        )
        if att_period != sig_period:
            return False
        if not verify_light_client_update(
            update, pks, self.spec, self.gvr, self.T
        ):
            return False
        self._commit_rotation(rotates)
        self.next_committee_pubkeys = [
            bytes(pk) for pk in update.next_sync_committee.pubkeys
        ]
        return True

    def process_optimistic_update(self, update) -> bool:
        if int(update.attested_header.beacon.slot) <= int(
            self.optimistic_header.slot
        ) and int(self.optimistic_header.slot) > 0:
            return False
        looked = self._lookup_committee(int(update.signature_slot))
        if looked is None:
            return False
        pks, rotates = looked
        if not verify_optimistic_update(
            update, pks, self.spec, self.gvr
        ):
            return False
        self._commit_rotation(rotates)
        self.optimistic_header = update.attested_header.beacon
        return True

    def process_finality_update(self, update) -> bool:
        # monotonic: a replayed older (still validly signed) update must
        # not regress finality
        if int(update.finalized_header.beacon.slot) <= int(
            self.finalized_header.slot
        ) and int(self.finalized_header.slot) > 0:
            return False
        looked = self._lookup_committee(int(update.signature_slot))
        if looked is None:
            return False
        pks, rotates = looked
        if not verify_finality_update(
            update, pks, self.spec, self.gvr, self.T
        ):
            return False
        self._commit_rotation(rotates)
        self.finalized_header = update.finalized_header.beacon
        if int(update.attested_header.beacon.slot) > int(
            self.optimistic_header.slot
        ):
            self.optimistic_header = update.attested_header.beacon
        return True


# ---------------------------------------------------------------------------
# full LightClientUpdate: sync-committee ROTATION (the piece that keeps a
# follower alive past a period boundary — light_client_update.rs +
# LightClientUpdatesByRange in rpc/protocol.rs)
# ---------------------------------------------------------------------------


def sync_committee_period(slot: int, spec) -> int:
    return int(slot) // (
        spec.preset.slots_per_epoch
        * spec.preset.epochs_per_sync_committee_period
    )


def build_light_client_update(
    attested_state, attested_header, sync_aggregate, signature_slot, T
):
    """Full update proving the attested state's NEXT sync committee —
    what a follower needs to cross the period boundary."""
    _, Update = light_client_types(T)
    leaf, branch, depth = field_proof(attested_state, "next_sync_committee")
    return Update(
        attested_header=LightClientHeader(beacon=attested_header),
        next_sync_committee=attested_state.next_sync_committee,
        next_sync_committee_branch=[bytes(b) for b in branch],
        finalized_header=LightClientHeader(),
        finality_branch=[],
        sync_aggregate=sync_aggregate,
        signature_slot=signature_slot,
    )


def verify_light_client_update(
    update, committee_pubkeys, spec, genesis_validators_root, T,
    min_participation_num: int = 2, min_participation_den: int = 3,
) -> bool:
    """Signature by the CURRENT committee + the next-committee branch
    proving into the attested header's state root.  Rotation fuel is the
    highest-trust artifact a follower consumes — a SUPERMAJORITY of the
    current committee must back it, or a single compromised signer could
    hand the follower an attacker-chosen next committee (the spec gates
    next-committee application the same way)."""
    bits = [bool(b) for b in update.sync_aggregate.sync_committee_bits]
    if sum(bits) * min_participation_den < len(bits) * min_participation_num:
        return False
    if not _verify_sync_aggregate(
        update.attested_header.beacon, update.sync_aggregate,
        committee_pubkeys, spec, genesis_validators_root,
        int(update.signature_slot),
    ):
        return False
    state_cls = T.BeaconState_BY_FORK["altair"]
    idx = field_index(state_cls, "next_sync_committee")
    depth = max(len(state_cls._fields) - 1, 0).bit_length()
    if len(update.next_sync_committee_branch) != depth:
        return False  # wrong-length branch is a malformed update, not a crash
    leaf = T.SyncCommittee.hash_tree_root_value(update.next_sync_committee)
    root = merkle_root_from_branch(
        leaf,
        [bytes(b) for b in update.next_sync_committee_branch],
        depth,
        idx,
    )
    return root == bytes(update.attested_header.beacon.state_root)
