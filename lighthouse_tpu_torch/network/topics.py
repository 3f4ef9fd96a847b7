"""Gossip topics + subnet computation.

Twin of lighthouse_network/src/types/topics.rs (GossipKind :78,107) and the
subnet mapping of consensus/types/src/subnet_id.rs: topic strings are
`/eth2/<fork_digest_hex>/<kind>/ssz_snappy`, attestation load is sharded
over ATTESTATION_SUBNET_COUNT subnets (the protocol's own data-parallel
axis, SURVEY §2.8.4).
"""

from __future__ import annotations

from ..consensus.spec import ChainSpec, compute_fork_digest

ENCODING = "ssz_snappy"

CORE_KINDS = (
    "beacon_block",
    "beacon_aggregate_and_proof",
    "voluntary_exit",
    "proposer_slashing",
    "attester_slashing",
    "sync_committee_contribution_and_proof",
    "bls_to_execution_change",
    "light_client_finality_update",
    "light_client_optimistic_update",
)


def topic(kind: str, fork_digest: bytes) -> str:
    return f"/eth2/{fork_digest.hex()}/{kind}/{ENCODING}"


def attestation_subnet_topic(subnet_id: int, fork_digest: bytes) -> str:
    return topic(f"beacon_attestation_{subnet_id}", fork_digest)


def sync_subnet_topic(subnet_id: int, fork_digest: bytes) -> str:
    return topic(f"sync_committee_{subnet_id}", fork_digest)


def blob_sidecar_topic(index: int, fork_digest: bytes) -> str:
    return topic(f"blob_sidecar_{index}", fork_digest)


def core_topics(fork_digest: bytes) -> list[str]:
    return [topic(k, fork_digest) for k in CORE_KINDS]


def all_topics(spec: ChainSpec, fork_digest: bytes) -> list[str]:
    out = core_topics(fork_digest)
    out += [
        attestation_subnet_topic(i, fork_digest)
        for i in range(spec.attestation_subnet_count)
    ]
    out += [
        sync_subnet_topic(i, fork_digest)
        for i in range(spec.sync_committee_subnet_count)
    ]
    out += [
        blob_sidecar_topic(i, fork_digest)
        for i in range(spec.preset.max_blobs_per_block)
    ]
    return out


def parse_topic(t: str) -> tuple[bytes, str]:
    """-> (fork_digest, kind); raises ValueError on malformed topics."""
    parts = t.split("/")
    if len(parts) != 5 or parts[1] != "eth2" or parts[4] != ENCODING:
        raise ValueError(f"malformed gossip topic {t!r}")
    return bytes.fromhex(parts[2]), parts[3]


def fork_digest(spec: ChainSpec, epoch: int, genesis_validators_root: bytes) -> bytes:
    return compute_fork_digest(
        spec.fork_version_at_epoch(epoch), genesis_validators_root
    )


def compute_subnet_for_attestation(
    spec: ChainSpec, slot: int, committee_index: int, committees_per_slot: int
) -> int:
    """subnet_id.rs compute_subnet_for_attestation: position of the
    committee within the epoch, mod subnet count."""
    slots_since_epoch_start = slot % spec.preset.slots_per_epoch
    committees_since_epoch_start = committees_per_slot * slots_since_epoch_start
    return (
        committees_since_epoch_start + committee_index
    ) % spec.attestation_subnet_count
