"""Deneb blob pipeline: sidecar construction, verification, availability.

Twin of beacon_node/beacon_chain/src/blob_verification.rs (gossip ladder:
index range, header signature, inclusion proof, KZG proof),
data_availability_checker.rs (block import parks until every committed blob
is seen and verified), and kzg_utils.rs:11-35 (batch KZG verification at the
import gate).  The KZG crypto itself is the shared pairing core
(crypto/kzg) — the same BLS12-381 stack the signature path batches on the
device, so blob batches ride the existing crypto path rather than a foreign
library.
"""

from __future__ import annotations

from ..consensus.light_client import field_index, field_proof
from ..consensus.merkle import verify_merkle_proof
from ..consensus.ssz import _zero_hashes
from ..crypto.kzg import kzg as K
from ..ops import sha256


class BlobError(Exception):
    pass


def _err(cond: bool, msg: str) -> None:
    if not cond:
        raise BlobError(msg)


# ---------------------------------------------------------------------------
# Inclusion proofs (BlobSidecar.kzg_commitment_inclusion_proof)
# ---------------------------------------------------------------------------

_COMMITMENT_LIST_DEPTH = 12  # ceil(log2(MAX_BLOB_COMMITMENTS_PER_BLOCK=4096))


def _sparse_branch(leaves: list[bytes], depth: int, index: int) -> list[bytes]:
    """Bottom-up merkle branch for ``leaves[index]`` in a tree padded with
    zero-subtrees to 2**depth leaves (nodes past the populated prefix are
    the standard zero hashes, so only the populated prefix is hashed)."""
    nodes = list(leaves)
    branch: list[bytes] = []
    i = index
    for level in range(depth):
        sib = i ^ 1
        branch.append(
            nodes[sib] if sib < len(nodes) else _zero_hashes[level]
        )
        nodes = [
            sha256(
                nodes[2 * k]
                + (nodes[2 * k + 1] if 2 * k + 1 < len(nodes) else _zero_hashes[level])
            )
            for k in range((len(nodes) + 1) // 2)
        ]
        i //= 2
    return branch


def _commitment_roots(commitments: list[bytes]) -> list[bytes]:
    # ByteVector(48) hash_tree_root: two 32-byte chunks (48 bytes zero-padded)
    return [
        sha256(bytes(c)[:32] + bytes(c)[32:].ljust(32, b"\x00"))
        for c in commitments
    ]


def commitment_inclusion_proof(body, index: int) -> list[bytes]:
    """The 17-node branch proving body.blob_kzg_commitments[index] against
    the body root: 12 levels inside the commitment list, the length mix-in,
    then the body's field tree (preset kzg_commitment_inclusion_proof_depth)."""
    commitments = list(body.blob_kzg_commitments)
    list_branch = _sparse_branch(
        _commitment_roots(commitments), _COMMITMENT_LIST_DEPTH, index
    )
    length_chunk = len(commitments).to_bytes(32, "little")
    _, body_branch, _ = field_proof(body, "blob_kzg_commitments")
    return list_branch + [length_chunk] + body_branch


def verify_commitment_inclusion(sidecar, preset) -> bool:
    """verify_blob_sidecar_inclusion_proof: the sidecar's commitment is the
    committed list element of the header's body."""
    body_cls_fields_index = _BODY_FIELD_INDEX
    depth = preset.kzg_commitment_inclusion_proof_depth
    index = int(sidecar.index) | (
        body_cls_fields_index << (_COMMITMENT_LIST_DEPTH + 1)
    )
    leaf = _commitment_roots([bytes(sidecar.kzg_commitment)])[0]
    return verify_merkle_proof(
        leaf,
        [bytes(p) for p in sidecar.kzg_commitment_inclusion_proof],
        depth,
        index,
        bytes(sidecar.signed_block_header.message.body_root),
    )


# field position of blob_kzg_commitments in the deneb body (stable across
# presets: the container layout is preset-invariant)
_BODY_FIELD_INDEX = 11


def build_blob_sidecars(signed_block, blobs: list[bytes], proofs: list[bytes], T):
    """BlobSidecar::new for every blob of a block (blob_sidecar.rs):
    header + per-index inclusion proof + the EL bundle's proofs."""
    from ..consensus.containers import SignedBeaconBlockHeader, BeaconBlockHeader

    block = signed_block.message
    body = block.body
    commitments = list(body.blob_kzg_commitments)
    _err(len(blobs) == len(commitments), "blob count != commitment count")
    header = SignedBeaconBlockHeader(
        message=BeaconBlockHeader(
            slot=block.slot,
            proposer_index=block.proposer_index,
            parent_root=bytes(block.parent_root),
            state_root=bytes(block.state_root),
            body_root=type(block)._fields["body"].hash_tree_root(body),
        ),
        signature=bytes(signed_block.signature),
    )
    out = []
    for i, blob in enumerate(blobs):
        out.append(
            T.BlobSidecar(
                index=i,
                blob=blob,
                kzg_commitment=bytes(commitments[i]),
                kzg_proof=bytes(proofs[i]),
                signed_block_header=header,
                kzg_commitment_inclusion_proof=commitment_inclusion_proof(
                    body, i
                ),
            )
        )
    return out


# ---------------------------------------------------------------------------
# Gossip verification ladder (blob_verification.rs GossipVerifiedBlob)
# ---------------------------------------------------------------------------


def verify_blob_sidecar_for_gossip(
    sidecar,
    spec,
    get_pubkey,
    fork,
    genesis_validators_root: bytes,
    setup: K.TrustedSetup | None = None,
) -> None:
    """Index range → inclusion proof → header proposer signature → KZG
    proof.  Raises BlobError on the first failing rung.  ``fork`` is the
    chain state's Fork container (domain selection follows get_domain)."""
    preset = spec.preset
    _err(
        int(sidecar.index) < preset.max_blobs_per_block,
        f"blob index {int(sidecar.index)} out of range",
    )
    _err(
        verify_commitment_inclusion(sidecar, preset),
        "commitment inclusion proof invalid",
    )
    header = sidecar.signed_block_header
    pk = get_pubkey(int(header.message.proposer_index))
    _err(pk is not None, "unknown proposer")
    from ..consensus import spec as S
    from ..consensus.state_processing.signature_sets import get_domain

    domain = get_domain(
        fork,
        genesis_validators_root,
        S.DOMAIN_BEACON_PROPOSER,
        int(header.message.slot) // preset.slots_per_epoch,
    )
    sig_root = S.compute_signing_root(header.message, domain)
    from ..crypto.bls import api as bls

    try:
        sig = bls.Signature.from_bytes(bytes(header.signature))
    except ValueError as e:
        raise BlobError(f"header signature undecodable: {e}") from None
    _err(bls.verify(pk, sig_root, sig), "header signature invalid")
    if setup is not None:
        _err(
            K.verify_blob_kzg_proof(
                bytes(sidecar.blob),
                bytes(sidecar.kzg_commitment),
                bytes(sidecar.kzg_proof),
                setup,
            ),
            "kzg proof invalid",
        )


# ---------------------------------------------------------------------------
# Data availability checker (data_availability_checker.rs)
# ---------------------------------------------------------------------------


class DataAvailabilityChecker:
    """Tracks verified blobs per block root; a deneb block imports only when
    every committed blob has arrived and verified (the import gate), and
    blocks seen first park until their blobs complete (reprocess queue)."""

    def __init__(self, setup: K.TrustedSetup | None = None, capacity: int = 256):
        self.setup = setup
        self.capacity = capacity
        # block_root -> {index: sidecar}
        self._blobs: dict[bytes, dict[int, object]] = {}

    def put_sidecar(self, sidecar) -> bytes:
        """Record a VERIFIED sidecar; returns its block root."""
        root = sidecar.signed_block_header.message.root()
        slot_map = self._blobs.setdefault(bytes(root), {})
        slot_map[int(sidecar.index)] = sidecar
        if len(self._blobs) > self.capacity:
            self._blobs.pop(next(iter(self._blobs)))
        return bytes(root)

    def missing_indices(self, block_root: bytes, commitments: list) -> list[int]:
        have = self._blobs.get(bytes(block_root), {})
        missing = []
        for i, c in enumerate(commitments):
            side = have.get(i)
            if side is None or bytes(side.kzg_commitment) != bytes(c):
                missing.append(i)
        return missing

    def verify_batch(self, block_root: bytes, commitments: list) -> bool:
        """kzg_utils.rs:23-35 verify_blob_kzg_proof_batch over a block's
        sidecars (one batched pairing check on the shared core)."""
        if self.setup is None or not commitments:
            return True
        have = self._blobs.get(bytes(block_root), {})
        sidecars = [have[i] for i in range(len(commitments))]
        return K.verify_blob_kzg_proof_batch(
            [bytes(s.blob) for s in sidecars],
            [bytes(s.kzg_commitment) for s in sidecars],
            [bytes(s.kzg_proof) for s in sidecars],
            self.setup,
        )

    def pop(self, block_root: bytes) -> list:
        have = self._blobs.pop(bytes(block_root), {})
        return [have[i] for i in sorted(have)]

    def get(self, block_root: bytes) -> list:
        have = self._blobs.get(bytes(block_root), {})
        return [have[i] for i in sorted(have)]
