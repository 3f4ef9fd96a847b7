"""Twin of tests/test_sync.py's signature-batch tests on the port's copies:
SyncManager's batch validation (:102), its one-pass bulk verify of a
segment rejecting a tampered signature (:135), and rotation off a byzantine
peer onto an honest one, whose segments bulk-verify (:158).  The bulk
verify goes through the port's ``crypto/bls/api.py``: here its python
oracle (``port_oracle``), on the card ``TorchBackend`` (chip_smoke.py's node
phase).
"""

import pytest
import torch
from test_torch_node_rig import port_oracle  # noqa: F401

torch.set_num_threads(1)

from lighthouse_tpu_torch.beacon.harness import BeaconChainHarness  # noqa: E402
from lighthouse_tpu_torch.beacon.sync import (  # noqa: E402
    Batch,
    BatchInvalid,
    SyncManager,
    SyncPeer,
    SyncState,
    serve_blocks_by_range,
)
from lighthouse_tpu_torch.network import rpc  # noqa: E402
from lighthouse_tpu_torch.network.peer_manager import PeerManager  # noqa: E402


def tuple_server(chain, fork="altair"):
    """Adapt serve_blocks_by_range (encoded chunks) to the SyncPeer
    request contract (decoded (code, ssz) tuples)."""
    serve = serve_blocks_by_range(chain, fork)

    def request_blocks(start_slot, count):
        return [rpc.decode_response_chunk(c) for c in serve(start_slot, count)]

    return request_blocks


def honest_peer(peer_id, harness, **kw):
    return SyncPeer(
        peer_id=peer_id,
        head_slot=int(harness.head_state().slot),
        request_blocks=tuple_server(harness.chain),
        **kw,
    )


# ---------------------------------------------------------------------------
# SyncManager: adversarial batch validation, rotation, penalties, stalls
# ---------------------------------------------------------------------------


def decoded_blocks(harness, start, count, fork="altair"):
    serve = serve_blocks_by_range(harness.chain, fork)
    cls = harness.chain.types.SignedBeaconBlock_BY_FORK[fork]
    return [
        cls.deserialize_value(rpc.decode_response_chunk(c)[1])
        for c in serve(start, count)
    ]


def test_sync_manager_validation_reasons(port_oracle):
    ahead = BeaconChainHarness(n_validators=16)
    ahead.extend_chain(6)
    fresh = BeaconChainHarness(n_validators=16)
    mgr = SyncManager(fresh.chain)
    blocks = decoded_blocks(ahead, 1, 6)

    with pytest.raises(BatchInvalid) as e:
        mgr._validate(Batch(start_slot=1, count=2), blocks[:4])
    assert e.value.reason == "over-count"

    with pytest.raises(BatchInvalid) as e:
        mgr._validate(Batch(start_slot=5, count=4), blocks[:4])
    assert e.value.reason == "slot-out-of-range"

    with pytest.raises(BatchInvalid) as e:
        mgr._validate(Batch(start_slot=1, count=4), list(reversed(blocks[:4])))
    assert e.value.reason == "non-increasing-slots"

    with pytest.raises(BatchInvalid) as e:
        mgr._validate(Batch(start_slot=1, count=4), [blocks[0], blocks[2]])
    assert e.value.reason == "broken-linkage"

    # a well-formed segment whose first block doesn't anchor to any state
    # we hold (batch edge not linked to our chain)
    with pytest.raises(BatchInvalid) as e:
        mgr._validate(Batch(start_slot=2, count=4), blocks[1:5])
    assert e.value.reason == "unknown-anchor"

    # the honest segment passes
    mgr._validate(Batch(start_slot=1, count=6), blocks)


def test_sync_manager_rejects_tampered_signature_batch(port_oracle):
    """Bulk segment verification: a block whose signature is a valid G2
    point over the WRONG message fails the one-pass verify."""
    ahead = BeaconChainHarness(n_validators=16)
    ahead.extend_chain(4)
    fresh = BeaconChainHarness(n_validators=16)
    pm = PeerManager()
    mgr = SyncManager(fresh.chain, peer_manager=pm, batch_slots=4,
                      max_batch_attempts=1)
    tampered = decoded_blocks(ahead, 1, 4)
    tampered[2].signature = bytes(tampered[1].signature)

    def serve_tampered(start_slot, count):
        return [(rpc.SUCCESS, b.encode()) for b in tampered]

    mgr.add_peer(SyncPeer(peer_id="forger", head_slot=4,
                          request_blocks=serve_tampered))
    assert mgr.tick() == SyncState.STALLED
    assert mgr.failed_batches == 1
    assert fresh.chain.head_root != ahead.chain.head_root
    assert pm.greylisted("forger")


def test_sync_manager_rotates_off_byzantine_peer(port_oracle):
    """Wrong-order blocks from one peer: penalized + greylisted on the
    first strike, sync completes through the honest alternative."""
    ahead = BeaconChainHarness(n_validators=16)
    ahead.extend_chain(8)
    fresh = BeaconChainHarness(n_validators=16)
    pm = PeerManager()
    mgr = SyncManager(fresh.chain, peer_manager=pm, batch_slots=4)

    honest_serve = tuple_server(ahead.chain)

    def serve_reversed(start_slot, count):
        return list(reversed(honest_serve(start_slot, count)))

    # "a-byz" sorts first so deterministic rotation picks it initially
    mgr.add_peer(SyncPeer(peer_id="a-byz", head_slot=8,
                          request_blocks=serve_reversed))
    mgr.add_peer(honest_peer("b-good", ahead))
    assert mgr.tick() == SyncState.SYNCED
    assert fresh.chain.head_root == ahead.chain.head_root
    assert mgr.failed_batches >= 1
    assert pm.greylisted("a-byz") and not pm.is_banned("a-byz")
    assert pm.score("b-good") == 0.0
