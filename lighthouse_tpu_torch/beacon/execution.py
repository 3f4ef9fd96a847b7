"""Execution-layer boundary: Engine API client, engine watchdog, mock EL.

Twin of beacon_node/execution_layer (Engine-API JSON-RPC client with JWT
auth src/engine_api/http.rs + auth.rs, engine state machine + watchdog
src/engines.rs, and the comprehensive mock EL the tests run against,
src/test_utils/).  The consensus side only needs three verbs —
new_payload, forkchoice_updated, get_payload — plus health tracking;
payload VALID/INVALID/SYNCING statuses feed the fork choice's
execution-status invalidation (proto_array EXEC_* codes).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
import urllib.request
from dataclasses import dataclass, field
from enum import Enum


class PayloadStatus(Enum):
    VALID = "VALID"
    INVALID = "INVALID"
    SYNCING = "SYNCING"
    ACCEPTED = "ACCEPTED"


class EngineState(Enum):
    ONLINE = "online"
    OFFLINE = "offline"
    SYNCING = "syncing"
    AUTH_FAILED = "auth_failed"


def jwt_token(secret: bytes, now: float | None = None) -> str:
    """Engine-API JWT (HS256, iat claim) — auth.rs."""
    header = base64.urlsafe_b64encode(
        json.dumps({"alg": "HS256", "typ": "JWT"}).encode()
    ).rstrip(b"=")
    claims = base64.urlsafe_b64encode(
        json.dumps({"iat": int(now or time.time())}).encode()
    ).rstrip(b"=")
    signing_input = header + b"." + claims
    sig = base64.urlsafe_b64encode(
        hmac.new(secret, signing_input, hashlib.sha256).digest()
    ).rstrip(b"=")
    return (signing_input + b"." + sig).decode()


def json_rpc_post(
    url: str, method: str, params: list, req_id: int,
    timeout: float, headers: dict | None = None,
):
    """One JSON-RPC 2.0 POST round trip (shared by the engine, eth1, and
    any other RPC client in the package — one place to fix transport
    behavior).  Raises IOError on an error response."""
    body = json.dumps(
        {"jsonrpc": "2.0", "id": req_id, "method": method, "params": params}
    ).encode()
    req = urllib.request.Request(
        url,
        data=body,
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        out = json.loads(r.read())
    if out.get("error"):
        raise IOError(f"{method}: {out['error']}")
    return out["result"]


class EngineApiClient:
    """JSON-RPC over HTTP with JWT bearer auth (engine_api/http.rs)."""

    def __init__(self, url: str, jwt_secret: bytes, timeout: float = 8.0):
        self.url = url
        self.jwt_secret = jwt_secret
        self.timeout = timeout
        self._id = 0

    def call(self, method: str, params: list) -> dict:
        self._id += 1
        return json_rpc_post(
            self.url, method, params, self._id, self.timeout,
            headers={"Authorization": f"Bearer {jwt_token(self.jwt_secret)}"},
        )

    def new_payload(self, payload_json: dict) -> PayloadStatus:
        res = self.call("engine_newPayloadV2", [payload_json])
        return PayloadStatus(res["status"])

    def new_payload_from(self, payload) -> PayloadStatus:
        """Marshal a consensus ExecutionPayload container into the Engine-API
        JSON shape (engine_api/json_structures.rs) and send it."""
        return self.new_payload(payload_to_json(payload))

    def get_payload(self, payload_id: str) -> dict:
        return self.call("engine_getPayloadV2", [payload_id])

    def build_payload(self, state, spec, payload_cls):
        """The production flow (engine_api.rs get_payload):
        forkchoiceUpdated with payload attributes → payloadId →
        engine_getPayload → decode into the consensus container."""
        from ..consensus.state_processing.per_block import (
            compute_timestamp_at_slot,
            get_expected_withdrawals,
        )

        parent = bytes(state.latest_execution_payload_header.block_hash)
        preset = spec.preset
        epoch = state.slot // preset.slots_per_epoch
        attrs = {
            "timestamp": hex(compute_timestamp_at_slot(state, state.slot, spec)),
            "prevRandao": "0x"
            + bytes(
                state.randao_mixes[epoch % preset.epochs_per_historical_vector]
            ).hex(),
            "suggestedFeeRecipient": "0x" + "00" * 20,
        }
        if "withdrawals" in payload_cls._fields:
            attrs["withdrawals"] = [
                {
                    "index": hex(w.index),
                    "validatorIndex": hex(w.validator_index),
                    "address": "0x" + bytes(w.address).hex(),
                    "amount": hex(w.amount),
                }
                for w in get_expected_withdrawals(state, spec)
            ]
        res = self.forkchoice_updated(parent, parent, parent, attrs)
        payload_id = res.get("payloadId")
        if payload_id is None:
            raise IOError("engine returned no payloadId")
        out = self.get_payload(payload_id)
        # blockValue feeds the builder-vs-local profit comparison
        # (get_payload's GetPayloadResponse.block_value)
        self.last_block_value_wei = int(out.get("blockValue", "0x0"), 16)
        return json_to_payload(payload_cls, out["executionPayload"])

    def build_payload_with_value(self, state, spec, payload_cls):
        payload = self.build_payload(state, spec, payload_cls)
        return payload, getattr(self, "last_block_value_wei", 0)

    def forkchoice_updated(self, head: bytes, safe: bytes, finalized: bytes,
                           payload_attributes: dict | None = None) -> dict:
        state = {
            "headBlockHash": "0x" + head.hex(),
            "safeBlockHash": "0x" + safe.hex(),
            "finalizedBlockHash": "0x" + finalized.hex(),
        }
        return self.call(
            "engine_forkchoiceUpdatedV2", [state, payload_attributes]
        )


def _hex(b: bytes) -> str:
    return "0x" + bytes(b).hex()


def _qty(n: int) -> str:
    return hex(int(n))


def payload_to_json(payload) -> dict:
    """ExecutionPayload container → Engine-API JSON (camelCase, 0x-hex
    values — engine_api/json_structures.rs JsonExecutionPayload)."""
    out = {
        "parentHash": _hex(payload.parent_hash),
        "feeRecipient": _hex(payload.fee_recipient),
        "stateRoot": _hex(payload.state_root),
        "receiptsRoot": _hex(payload.receipts_root),
        "logsBloom": _hex(payload.logs_bloom),
        "prevRandao": _hex(payload.prev_randao),
        "blockNumber": _qty(payload.block_number),
        "gasLimit": _qty(payload.gas_limit),
        "gasUsed": _qty(payload.gas_used),
        "timestamp": _qty(payload.timestamp),
        "extraData": _hex(payload.extra_data),
        "baseFeePerGas": _qty(payload.base_fee_per_gas),
        "blockHash": _hex(payload.block_hash),
        "transactions": [_hex(tx) for tx in payload.transactions],
    }
    if hasattr(payload, "withdrawals"):
        out["withdrawals"] = [
            {
                "index": _qty(w.index),
                "validatorIndex": _qty(w.validator_index),
                "address": _hex(w.address),
                "amount": _qty(w.amount),
            }
            for w in payload.withdrawals
        ]
    if hasattr(payload, "blob_gas_used"):
        out["blobGasUsed"] = _qty(payload.blob_gas_used)
        out["excessBlobGas"] = _qty(payload.excess_blob_gas)
    return out


def json_to_payload(payload_cls, data: dict):
    """Engine-API JSON → consensus ExecutionPayload container (the inverse
    of payload_to_json)."""
    def b(x):
        return bytes.fromhex(x.removeprefix("0x"))

    def q(x):
        return int(x, 16)

    kwargs = dict(
        parent_hash=b(data["parentHash"]),
        fee_recipient=b(data["feeRecipient"]),
        state_root=b(data["stateRoot"]),
        receipts_root=b(data["receiptsRoot"]),
        logs_bloom=b(data["logsBloom"]),
        prev_randao=b(data["prevRandao"]),
        block_number=q(data["blockNumber"]),
        gas_limit=q(data["gasLimit"]),
        gas_used=q(data["gasUsed"]),
        timestamp=q(data["timestamp"]),
        extra_data=b(data["extraData"]),
        base_fee_per_gas=q(data["baseFeePerGas"]),
        block_hash=b(data["blockHash"]),
        transactions=[b(tx) for tx in data["transactions"]],
    )
    if "withdrawals" in payload_cls._fields:
        kwargs["withdrawals"] = [
            {
                "index": q(w["index"]),
                "validator_index": q(w["validatorIndex"]),
                "address": b(w["address"]),
                "amount": q(w["amount"]),
            }
            for w in data.get("withdrawals", [])
        ]
        from ..consensus.containers import Withdrawal

        kwargs["withdrawals"] = [Withdrawal(**w) for w in kwargs["withdrawals"]]
    if "blob_gas_used" in payload_cls._fields:
        kwargs["blob_gas_used"] = q(data.get("blobGasUsed", "0x0"))
        kwargs["excess_blob_gas"] = q(data.get("excessBlobGas", "0x0"))
    return payload_cls(**kwargs)


def notify_new_payload(engine, payload) -> PayloadStatus:
    """Uniform chain→engine verb: full-payload marshal when the engine
    speaks Engine-API JSON (EngineApiClient), block-hash shortcut for the
    in-process mock."""
    if hasattr(engine, "new_payload_from"):
        return engine.new_payload_from(payload)
    return engine.new_payload(bytes(payload.block_hash))


class MockExecutionEngine:
    """In-process EL double (execution_layer/src/test_utils analog): serves
    the three verbs directly (no HTTP), with fault injection — mark block
    hashes INVALID to drive the payload-invalidation path
    (beacon_chain/tests/payload_invalidation.rs pattern)."""

    def __init__(self, blobs_per_block: int = 0):
        self.invalid_hashes: set[bytes] = set()
        self.syncing = False
        self.calls: list[tuple[str, object]] = []
        self._head: bytes = b"\x00" * 32
        self.fail_build = False  # fault injection: local production down
        self.block_value_wei = 10**9  # reported local block value
        # deneb: blobs bundled with produced payloads (get_payload's
        # BlobsBundle — commitments, proofs, blobs — keyed by block hash)
        self.blobs_per_block = blobs_per_block
        self._bundles: dict[bytes, tuple[list, list, list]] = {}

    @property
    def kzg_setup(self):
        """Known-tau dev setup when this mock serves blobs (lazy: building
        it costs ~25 s once per process), else None."""
        if self.blobs_per_block <= 0:
            return None
        from ..crypto.kzg.kzg import dev_setup

        return dev_setup()

    def get_blobs_bundle(self, block_hash: bytes):
        """(commitments, proofs, blobs) for a produced payload, or None."""
        return self._bundles.get(bytes(block_hash))

    def inject_invalid(self, block_hash: bytes) -> None:
        self.invalid_hashes.add(block_hash)

    def new_payload(self, block_hash: bytes) -> PayloadStatus:
        self.calls.append(("new_payload", block_hash))
        if self.syncing:
            return PayloadStatus.SYNCING
        if block_hash in self.invalid_hashes:
            return PayloadStatus.INVALID
        return PayloadStatus.VALID

    def forkchoice_updated(self, head: bytes, safe: bytes, finalized: bytes):
        self.calls.append(("forkchoice_updated", head))
        self._head = head
        return {"payloadStatus": {"status": "VALID"}, "payloadId": "0x01"}

    def build_payload(self, state, spec, payload_cls):
        """ExecutionBlockGenerator analog (execution_layer/src/test_utils/
        execution_block_generator.rs): produce a payload that satisfies the
        consensus checks of process_execution_payload — parent linkage,
        prev_randao, timestamp — plus expected withdrawals for capella+."""
        if self.fail_build:
            raise IOError("mock EL: payload production disabled")
        preset = spec.preset
        parent = bytes(state.latest_execution_payload_header.block_hash)
        epoch = state.slot // preset.slots_per_epoch
        prev_randao = bytes(
            state.randao_mixes[epoch % preset.epochs_per_historical_vector]
        )
        number = state.latest_execution_payload_header.block_number + 1
        block_hash = hashlib.sha256(
            b"mock-el" + parent + number.to_bytes(8, "little")
        ).digest()
        from ..consensus.state_processing.per_block import (
            compute_timestamp_at_slot,
            get_expected_withdrawals,
        )

        kwargs = dict(
            parent_hash=parent,
            fee_recipient=bytes(20),
            state_root=hashlib.sha256(b"el-state" + block_hash).digest(),
            receipts_root=bytes(32),
            prev_randao=prev_randao,
            block_number=number,
            gas_limit=30_000_000,
            gas_used=0,
            timestamp=compute_timestamp_at_slot(state, state.slot, spec),
            base_fee_per_gas=7,
            block_hash=block_hash,
            transactions=[],
        )
        if "withdrawals" in payload_cls._fields:
            kwargs["withdrawals"] = get_expected_withdrawals(state, spec)
        if "blob_gas_used" in payload_cls._fields:
            kwargs["blob_gas_used"] = 0
            kwargs["excess_blob_gas"] = 0
            if self.blobs_per_block > 0:
                self._bundles[block_hash] = self._make_bundle(number)
        return payload_cls(**kwargs)

    def build_payload_with_value(self, state, spec, payload_cls):
        return (
            self.build_payload(state, spec, payload_cls),
            self.block_value_wei,
        )

    def _make_bundle(self, block_number: int):
        """Deterministic canonical blobs + commitments + proofs."""
        from ..crypto.kzg import kzg as K

        setup = self.kzg_setup
        blobs, commitments, proofs = [], [], []
        for i in range(self.blobs_per_block):
            seed = block_number * 64 + i
            blob = b"".join(
                b"\x00" + hashlib.sha256(
                    seed.to_bytes(8, "big") + j.to_bytes(4, "big")
                ).digest()[:31]
                for j in range(K.FIELD_ELEMENTS_PER_BLOB)
            )
            c = K.blob_to_kzg_commitment(blob, setup)
            p = K.compute_blob_kzg_proof(blob, c, setup)
            blobs.append(blob)
            commitments.append(c)
            proofs.append(p)
        return commitments, proofs, blobs


class MockELServer:
    """HTTP JSON-RPC Engine-API double (execution_layer/src/test_utils/
    mock_execution_layer.rs): serves engine_newPayloadV2 /
    engine_forkchoiceUpdatedV2 / engine_getPayloadV2 over a real socket
    with JWT-header validation, backed by a MockExecutionEngine — the
    EngineApiClient path is then testable end-to-end over the wire."""

    def __init__(self, jwt_secret: bytes, engine: "MockExecutionEngine",
                 port: int = 0):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        outer_engine = engine
        self.jwt_secret = jwt_secret
        # payloadId -> (state-ish context for build) is driven by the
        # forkchoice attributes: the mock builds the payload AT fcu time
        self._payloads: dict[str, dict] = {}
        self._next_id = [0]
        # eth1 side (execution_block_generator.rs's eth1 chain): blocks +
        # ABI-encoded DepositEvent logs served over the unauthenticated
        # eth_ namespace for the Eth1PollingService
        self.eth1_blocks: list[dict] = []
        self.eth1_logs: list[dict] = []
        self._eth1_deposit_count = 0
        mock = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                method, params = req["method"], req["params"]
                if method.startswith("eth_"):
                    # the eth1 RPC surface carries no engine-API JWT
                    result = mock._eth1_call(method, params)
                    body = json.dumps(
                        {"jsonrpc": "2.0", "id": req["id"], "result": result}
                    ).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(body)
                    return
                auth = self.headers.get("Authorization", "")
                if not auth.startswith("Bearer "):
                    self.send_response(401)
                    self.end_headers()
                    return
                result = None
                if method == "engine_newPayloadV2":
                    block_hash = bytes.fromhex(
                        params[0]["blockHash"].removeprefix("0x")
                    )
                    status = outer_engine.new_payload(block_hash)
                    result = {"status": status.value, "latestValidHash": None}
                elif method == "engine_forkchoiceUpdatedV2":
                    attrs = params[1]
                    payload_id = None
                    if attrs:
                        mock._next_id[0] += 1
                        payload_id = hex(mock._next_id[0])
                        mock._payloads[payload_id] = {
                            "head": params[0]["headBlockHash"],
                            "attrs": attrs,
                        }
                    result = {
                        "payloadStatus": {"status": "VALID"},
                        "payloadId": payload_id,
                    }
                elif method == "engine_getPayloadV2":
                    ctx = mock._payloads.pop(params[0], None)
                    if ctx is None:
                        result = None
                    else:
                        result = {
                            "executionPayload": mock._assemble(ctx),
                            "blockValue": "0x0",
                        }
                body = json.dumps(
                    {"jsonrpc": "2.0", "id": req["id"], "result": result}
                ).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True, name="mock-el"
        )

    # -- eth1 namespace (deposit-log ingestion test double) -----------------

    def add_eth1_block(self, deposits=None, timestamp: int | None = None):
        """Append one eth1 block carrying the given DepositData logs
        (ABI-encoded exactly as the deposit contract emits them)."""
        from .eth1 import DEPOSIT_EVENT_TOPIC, encode_deposit_log_data

        number = len(self.eth1_blocks)
        block_hash = hashlib.sha256(
            b"eth1" + number.to_bytes(8, "little")
        ).digest()
        self.eth1_blocks.append(
            {
                "number": hex(number),
                "hash": "0x" + block_hash.hex(),
                "timestamp": hex(
                    timestamp if timestamp is not None else number * 14
                ),
            }
        )
        for li, dd in enumerate(deposits or []):
            self.eth1_logs.append(
                {
                    "blockNumber": hex(number),
                    "logIndex": hex(li),
                    "topics": ["0x" + DEPOSIT_EVENT_TOPIC.hex()],
                    "data": "0x"
                    + encode_deposit_log_data(
                        dd, self._eth1_deposit_count
                    ).hex(),
                }
            )
            self._eth1_deposit_count += 1
        return block_hash

    def _eth1_call(self, method: str, params: list):
        if method == "eth_chainId":
            return "0x1"
        if method == "eth_blockNumber":
            return hex(len(self.eth1_blocks) - 1) if self.eth1_blocks else "0x0"
        if method == "eth_getBlockByNumber":
            n = int(params[0], 16)
            if 0 <= n < len(self.eth1_blocks):
                return self.eth1_blocks[n]
            return None
        if method == "eth_getLogs":
            flt = params[0]
            lo = int(flt.get("fromBlock", "0x0"), 16)
            hi = int(flt.get("toBlock", hex(len(self.eth1_blocks))), 16)
            topics = flt.get("topics") or []
            return [
                entry
                for entry in self.eth1_logs
                if lo <= int(entry["blockNumber"], 16) <= hi
                and (not topics or entry["topics"][0] == topics[0])
            ]
        return None

    def _assemble(self, ctx: dict) -> dict:
        """Build the payload JSON from the stored forkchoice attributes
        (the mock EL's block production)."""
        parent = bytes.fromhex(ctx["head"].removeprefix("0x"))
        attrs = ctx["attrs"]
        # consensus checks parent_hash/randao/timestamp, not EL numbering;
        # the timestamp gives a monotonic stand-in block number
        number = int(attrs["timestamp"], 16) % 2**32
        block_hash = hashlib.sha256(
            b"mock-el-http" + parent + attrs["timestamp"].encode()
        ).digest()
        out = {
            "parentHash": "0x" + parent.hex(),
            "feeRecipient": attrs.get(
                "suggestedFeeRecipient", "0x" + "00" * 20
            ),
            "stateRoot": "0x" + hashlib.sha256(block_hash).digest().hex(),
            "receiptsRoot": "0x" + "00" * 32,
            "logsBloom": "0x" + "00" * 256,
            "prevRandao": attrs["prevRandao"],
            "blockNumber": hex(number),
            "gasLimit": hex(30_000_000),
            "gasUsed": "0x0",
            "timestamp": attrs["timestamp"],
            "extraData": "0x",
            "baseFeePerGas": "0x7",
            "blockHash": "0x" + block_hash.hex(),
            "transactions": [],
        }
        if "withdrawals" in attrs:
            out["withdrawals"] = attrs["withdrawals"]
        return out

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


@dataclass
class EngineWatchdog:
    """Engine health state machine (engines.rs): periodic upcheck flips
    ONLINE/OFFLINE/SYNCING; consumers gate optimistic import on it."""

    engine: object
    state: EngineState = EngineState.OFFLINE
    consecutive_failures: int = 0
    failure_threshold: int = 3
    history: list = field(default_factory=list)

    def upcheck(self) -> EngineState:
        try:
            status = self.engine.new_payload(b"\x00" * 32)
            if status == PayloadStatus.SYNCING:
                self.state = EngineState.SYNCING
            else:
                self.state = EngineState.ONLINE
            self.consecutive_failures = 0
        except Exception:
            self.consecutive_failures += 1
            if self.consecutive_failures >= self.failure_threshold:
                self.state = EngineState.OFFLINE
        self.history.append(self.state)
        return self.state
