"""Req/resp RPC: protocol registry, SSZ-snappy chunk codec, rate limiting.

Twin of lighthouse_network/src/rpc (protocol registry protocol.rs:149-174:
Status, Goodbye, BlocksByRange, BlocksByRoot, Ping, MetaData, ...; SSZ-
snappy chunk codec rpc/codec/; token-bucket rate limiting
rpc/rate_limiter.rs both directions).  The transport underneath is
pluggable (in-process pipes for the simulator; TCP framing is the same
bytes).

Chunk wire form (the reference's ssz_snappy response chunk):
``<result u8> <uncompressed_len uvarint> <framed-snappy payload>``.
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field

from ..consensus.containers import Checkpoint  # noqa: F401 (type anchors)
from ..consensus.ssz import Container, ByteVector, U64
from . import snappy
from .snappy import _read_uvarint

Root = ByteVector(32)
Bytes4 = ByteVector(4)


class StatusMessage(Container):
    """protocol.rs Status: fork digest + finalized/head pointers."""

    fields = {
        "fork_digest": Bytes4,
        "finalized_root": Root,
        "finalized_epoch": U64,
        "head_root": Root,
        "head_slot": U64,
    }


class GoodbyeReason(Container):
    fields = {"reason": U64}


class Ping(Container):
    fields = {"data": U64}


class MetaData(Container):
    fields = {
        "seq_number": U64,
        "attnets": U64,  # bitfield packed in a u64 for the 64 subnets
        "syncnets": U64,
    }


class BlocksByRangeRequest(Container):
    fields = {
        "start_slot": U64,
        "count": U64,
        "step": U64,  # deprecated = 1
    }


class BlobsByRangeRequest(Container):
    """protocol.rs:149-174 BlobsByRange (deneb)."""

    fields = {
        "start_slot": U64,
        "count": U64,
    }


class BlobIdentifier(Container):
    """types/src/blob_sidecar.rs BlobIdentifier — BlobsByRoot addresses a
    single (block, index) pair."""

    fields = {
        "block_root": Root,
        "index": U64,
    }


PROTOCOLS = {
    # name -> (version, request type or None, response type tag)
    "status": ("1", StatusMessage, StatusMessage),
    "goodbye": ("1", GoodbyeReason, None),
    "ping": ("1", Ping, Ping),
    "metadata": ("2", None, MetaData),
    "beacon_blocks_by_range": ("2", BlocksByRangeRequest, "signed_block"),
    "beacon_blocks_by_root": ("1", None, "signed_block"),
    "blob_sidecars_by_range": ("1", BlobsByRangeRequest, "blob_sidecar"),
    "blob_sidecars_by_root": ("1", None, "blob_sidecar"),
    # protocol.rs:149-174 light-client serving: request = block root
    "light_client_bootstrap": ("1", None, "light_client_bootstrap"),
    # request = (start_period u64, count u64); chunked best updates
    "light_client_updates_by_range": ("1", None, "light_client_update"),
}

PROTOCOL_PREFIX = "/eth2/beacon_chain/req"


def protocol_id(name: str) -> str:
    version = PROTOCOLS[name][0]
    return f"{PROTOCOL_PREFIX}/{name}/{version}/ssz_snappy"


# spec cap on BlocksByRange request size; a peer asking for more is
# misbehaving, not just ambitious (p2p-interface.md MAX_REQUEST_BLOCKS)
MAX_REQUEST_BLOCKS = 1024

# result codes (RPCCodedResponse)
SUCCESS = 0
# handler-side sentinel: response is already a stream of coded chunks
RAW_CHUNKS = -1
INVALID_REQUEST = 1
SERVER_ERROR = 2
RESOURCE_UNAVAILABLE = 3


def _uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_request(payload_ssz: bytes) -> bytes:
    """Requests: <len uvarint><framed snappy>."""
    return _uvarint(len(payload_ssz)) + snappy.compress_framed(payload_ssz)


def decode_request(data: bytes, max_len: int = 2**22) -> bytes:
    want, pos = _read_uvarint(data, 0)
    if want > max_len:
        raise ValueError(f"request over limit ({want} > {max_len})")
    out = snappy.decompress_framed(data[pos:])
    if len(out) != want:
        raise ValueError("request length mismatch")
    return out


def encode_response_chunk(result: int, payload_ssz: bytes = b"") -> bytes:
    return (
        bytes([result])
        + _uvarint(len(payload_ssz))
        + snappy.compress_framed(payload_ssz)
    )


def decode_response_chunk(data: bytes) -> tuple[int, bytes]:
    result = data[0]
    want, pos = _read_uvarint(data, 1)
    out = snappy.decompress_framed(data[pos:])
    if len(out) != want:
        raise ValueError("response length mismatch")
    return result, out


def decode_response_chunks(data: bytes) -> list[tuple[int, bytes]]:
    """Split a stream of back-to-back coded chunks (the multi-block
    BlocksByRange response shape: one <code><len><framed-snappy> per
    block on a single stream)."""
    out, pos = [], 0
    while pos < len(data):
        code = data[pos]
        want, p2 = _read_uvarint(data, pos + 1)
        payload, consumed = snappy.decompress_framed_prefix(data[p2:], want)
        out.append((code, payload))
        pos = p2 + consumed
    return out


# ---------------------------------------------------------------------------
# rate limiting (token bucket per protocol per peer, rate_limiter.rs)
# ---------------------------------------------------------------------------


@dataclass
class TokenBucket:
    capacity: float
    refill_per_sec: float
    tokens: float = field(default=-1.0)
    last: float = field(default=-1.0)

    def allow(self, cost: float = 1.0, now: float | None = None) -> bool:
        now = time.monotonic() if now is None else now
        if self.tokens < 0:  # lazy init pins `last` to the caller's clock
            self.tokens = self.capacity
            self.last = now
        self.tokens = min(
            self.capacity, self.tokens + (now - self.last) * self.refill_per_sec
        )
        self.last = now
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False


DEFAULT_LIMITS = {
    # protocol -> (capacity, refill/s); shaped after rate_limiter.rs defaults
    "status": (5, 1.0),
    "goodbye": (1, 0.1),
    "ping": (2, 0.5),
    "metadata": (2, 0.5),
    "beacon_blocks_by_range": (1024, 100.0),
    "beacon_blocks_by_root": (128, 20.0),
    "blob_sidecars_by_range": (768, 100.0),
    "blob_sidecars_by_root": (128, 20.0),
    # gossipsub IWANT retransmission budget (ids/sec, not requests)
    "gossip_iwant": (256, 32.0),
}


class RateLimiter:
    def __init__(self, limits: dict | None = None):
        self.limits = limits or DEFAULT_LIMITS
        self._buckets: dict[tuple[str, str], TokenBucket] = {}

    def allow(self, peer_id: str, protocol: str, cost: float = 1.0,
              now: float | None = None) -> bool:
        cap, refill = self.limits.get(protocol, (10, 1.0))
        key = (peer_id, protocol)
        if key not in self._buckets:
            self._buckets[key] = TokenBucket(cap, refill)
        return self._buckets[key].allow(cost, now)
