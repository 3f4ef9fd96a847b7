"""Builder / MEV client + payload-source selection + in-repo mock relay.

Capability twin of the reference's external-builder stack:

* ``BuilderHttpClient`` — beacon_node/builder_client/src/lib.rs: the
  builder-specs HTTP surface (status, validator registration,
  header/{slot}/{parent_hash}/{pubkey}, blinded-block submission).
* ``select_payload_source`` — execution_layer/src/lib.rs:955-1160
  (determine_and_fetch_payload): the (relay, local) decision matrix —
  chain-health gate, bid verification, boost factor, local-profit
  comparison, and every fallback arm.
* ``MockRelay`` — execution_layer/src/test_utils/mock_builder.rs: an
  in-repo relay over a real HTTP socket that fabricates valid payloads,
  signs bids with its BLS key, and reveals on submission.

Scaled-down divergence (documented, deliberate): the proposer-side
handshake is single-phase — the BN reveals the payload at production
time by submitting the accepted header's root + proposer signature
instead of a full SignedBlindedBeaconBlock (this repo has no blinded
container family; the relay still verifies the submission references
the bid it served).  The ECONOMIC selection logic — the part that
decides builder vs local — is complete.
"""

from __future__ import annotations

import hashlib
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib import error as urlerror
from urllib import request as urlrequest

from ..consensus import spec as S
from ..utils.logging import get_logger

log = get_logger("builder")

# builder-specs DomainType('0x00000001'); domain mixes the genesis fork
# version with a ZERO genesis-validators-root (chain-agnostic)
DOMAIN_APPLICATION_BUILDER = bytes([0, 0, 0, 1])


def builder_signing_domain(spec) -> bytes:
    return S.compute_domain(
        DOMAIN_APPLICATION_BUILDER,
        spec.genesis_fork_version,
        b"\x00" * 32,
    )


def payload_to_header(payload, types, fork: str):
    """Full payload -> header: shared fields + list-field roots
    (types/src/execution_payload_header.rs From<ExecutionPayload>)."""
    hdr_cls = types.ExecutionPayloadHeader_BY_FORK[fork]
    pay_cls = type(payload)
    kwargs = {}
    for name in hdr_cls._fields:
        if name == "transactions_root":
            kwargs[name] = pay_cls._fields["transactions"].hash_tree_root(
                payload.transactions
            )
        elif name == "withdrawals_root":
            kwargs[name] = pay_cls._fields["withdrawals"].hash_tree_root(
                payload.withdrawals
            )
        else:
            kwargs[name] = getattr(payload, name)
    return hdr_cls(**kwargs)


class BuilderError(IOError):
    pass


class CannotProducePayload(Exception):
    """Both the local EL and the builder failed (lib.rs CannotProduceHeader):
    the proposal must be missed rather than built on garbage."""


class BuilderHttpClient:
    """builder_client/src/lib.rs over urllib: tight per-call timeouts —
    a slow relay must not eat the proposal slot."""

    def __init__(self, base_url: str, timeout: float = 3.0,
                 expected_pubkey: bytes | None = None):
        self.base = base_url.rstrip("/")
        self.timeout = timeout
        # pin the relay's BLS identity: bids signed by anyone else reject
        self.expected_pubkey = expected_pubkey

    def _get(self, path: str):
        req = urlrequest.Request(self.base + path)
        with urlrequest.urlopen(req, timeout=self.timeout) as resp:
            if resp.status == 204:
                return None
            return json.loads(resp.read() or b"{}")

    def _post(self, path: str, payload) -> dict:
        req = urlrequest.Request(
            self.base + path,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urlrequest.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read() or b"{}")

    def status(self) -> bool:
        """GET /eth/v1/builder/status — reachable AND willing."""
        try:
            self._get("/eth/v1/builder/status")
            return True
        except Exception:  # noqa: BLE001
            return False

    def register_validators(self, registrations: list[dict]) -> None:
        self._post("/eth/v1/builder/validators", registrations)

    def get_header(self, slot: int, parent_hash: bytes, pubkey: bytes):
        """(fork_name, signed_bid_json) or None (204 = no bid)."""
        out = self._get(
            f"/eth/v1/builder/header/{slot}/0x{parent_hash.hex()}"
            f"/0x{pubkey.hex()}"
        )
        if out is None:
            return None
        return out["version"], out["data"]

    def submit(self, slot: int, header_root: bytes, signature: bytes) -> dict:
        """Reveal: submission must reference the served bid's header root
        (the scaled-down SignedBlindedBeaconBlock — module docstring)."""
        return self._post(
            "/eth/v1/builder/blinded_blocks",
            {
                "slot": str(slot),
                "header_root": "0x" + header_root.hex(),
                "signature": "0x" + signature.hex(),
            },
        )


def verify_builder_bid(
    signed_bid_json: dict,
    fork: str,
    types,
    spec,
    parent_hash: bytes,
    expected_pubkey: bytes | None,
    local_block_number: int | None,
) -> str | None:
    """lib.rs verify_builder_bid: None if acceptable, else the rejection
    reason (each maps to an EXECUTION_LAYER_GET_PAYLOAD_BUILDER_REJECTIONS
    label in the reference)."""
    from ..crypto.bls import api as bls
    from ..network.api import from_json

    bid_cls = types.SignedBuilderBid_BY_FORK[fork]
    try:
        signed = from_json(bid_cls, signed_bid_json)
    except Exception:  # noqa: BLE001
        return "malformed bid"
    header = signed.message.header
    if bytes(header.parent_hash) != parent_hash:
        return "bid parent hash mismatch"
    if int(signed.message.value) == 0:
        return "zero bid value"
    if (
        local_block_number is not None
        and int(header.block_number) != local_block_number
    ):
        return "bid block number mismatch"
    if (
        expected_pubkey is not None
        and bytes(signed.message.pubkey) != expected_pubkey
    ):
        return "unexpected builder pubkey"
    # the signature is ALWAYS verified (the reference never skips it);
    # without a pinned pubkey it proves possession of the claimed key
    try:
        pk = bls.PublicKey.from_bytes(bytes(signed.message.pubkey))
        root = S.compute_signing_root(
            signed.message, builder_signing_domain(spec)
        )
        if not bls.verify(
            pk, root, bls.Signature.from_bytes(bytes(signed.signature))
        ):
            return "bid signature invalid"
    except Exception:  # noqa: BLE001
        return "bid signature invalid"
    return None


def select_payload_source(
    local_fn,
    relay_fn,
    *,
    chain_healthy: bool = True,
    boost_factor: int | None = None,
    verify_fn=None,
):
    """The determine_and_fetch_payload decision matrix (lib.rs:1023-1160).

    ``local_fn`` -> (payload, value_wei); ``relay_fn`` -> (bid_value_wei,
    reveal_fn) or None (no bid); ``verify_fn(bid)`` -> rejection reason or
    None.  Returns ("local"|"builder", payload-or-reveal, value).  Raises
    CannotProducePayload when no side can produce (the reference's
    CannotProduceHeader)."""
    if relay_fn is None or not chain_healthy:
        payload, value = local_fn()  # pre-merge/unhealthy: never ask
        return "local", payload, value

    try:
        relay_result = relay_fn()
        relay_err = None
    except Exception as exc:  # noqa: BLE001
        relay_result, relay_err = None, exc
    try:
        local_result = local_fn()
        local_err = None
    except Exception as exc:  # noqa: BLE001
        local_result, local_err = None, exc

    if local_err is None:
        local_payload, local_value = local_result
        if relay_err is not None:
            log.warning("builder error, falling back to local: %s", relay_err)
            return "local", local_payload, local_value
        if relay_result is None:
            log.info("builder returned no bid; using local payload")
            return "local", local_payload, local_value
        bid_value, reveal = relay_result
        if verify_fn is not None:
            reason = verify_fn()
            if reason is not None:
                log.warning("builder bid rejected (%s); using local", reason)
                return "local", local_payload, local_value
        boosted = (
            bid_value * boost_factor // 100  # mul before div: no 100-wei
            if boost_factor is not None      # truncation (lib.rs order)
            else bid_value
        )
        if local_value >= boosted:
            log.info(
                "local block more profitable (%d >= boosted %d)",
                local_value, boosted,
            )
            return "local", local_payload, local_value
        log.info(
            "relay block more profitable (boosted %d > local %d)",
            boosted, local_value,
        )
        return "builder", reveal, bid_value

    # local failed
    if relay_err is not None or relay_result is None:
        raise CannotProducePayload(
            f"local EL failed ({local_err}) and builder "
            f"{'errored: ' + str(relay_err) if relay_err else 'had no bid'}"
        )
    bid_value, reveal = relay_result
    if verify_fn is not None:
        reason = verify_fn()
        if reason is not None:
            raise CannotProducePayload(
                f"local EL failed ({local_err}) and builder bid rejected: "
                f"{reason}"
            )
    log.warning("local EL failed (%s); proposing with builder payload",
                local_err)
    return "builder", reveal, bid_value


class MockRelay:
    """mock_builder.rs: a relay double over a real HTTP socket.

    Reads the chain in-process (the reference's mock builder wraps the
    mock-EL block generator the same way) to fabricate payloads that pass
    process_execution_payload, signs bids with its own BLS key, and only
    reveals a payload whose header it actually served."""

    def __init__(self, chain, bid_wei: int = 10**18, healthy: bool = True):
        self.chain = chain
        self.bid_wei = bid_wei
        self.healthy = healthy
        self.return_no_bid = False
        self.registrations: list[dict] = []
        self.submissions: list[dict] = []
        # served bids: header_root -> payload (revealed on submission)
        self._served: dict[bytes, object] = {}
        from ..crypto.bls import api as bls

        self.sk = bls.SecretKey(0x42B)
        self.pubkey = self.sk.public_key().to_bytes()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code: int, payload=None):
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                if payload is not None:
                    self.wfile.write(json.dumps(payload).encode())

            def do_GET(self):
                try:
                    outer._handle_get(self)
                except Exception as e:  # noqa: BLE001
                    self._send(500, {"message": repr(e)})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                try:
                    outer._handle_post(self, body)
                except Exception as e:  # noqa: BLE001
                    self._send(500, {"message": repr(e)})

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    # -- server plumbing ----------------------------------------------------

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()

    # -- relay logic --------------------------------------------------------

    def _fabricate_payload(self, slot: int, parent_hash: bytes):
        """A valid-for-consensus payload on the chain's production state
        (parent linkage, prev_randao, timestamp, withdrawals), with a
        relay-salted block hash and a token extra_data so builder blocks
        are distinguishable in tests."""
        from ..consensus.state_processing.per_block import (
            compute_timestamp_at_slot,
            get_expected_withdrawals,
        )

        chain = self.chain
        state = chain._advance_for_production(slot)
        fork = chain.spec.fork_name_at_epoch(
            slot // chain.preset.slots_per_epoch
        )
        if fork not in chain.types.ExecutionPayload_BY_FORK:
            raise BuilderError(f"no payloads pre-merge (fork {fork})")
        payload_cls = chain.types.ExecutionPayload_BY_FORK[fork]
        preset = chain.preset
        epoch = state.slot // preset.slots_per_epoch
        number = int(state.latest_execution_payload_header.block_number) + 1
        block_hash = hashlib.sha256(
            b"relay" + parent_hash + number.to_bytes(8, "little")
        ).digest()
        kwargs = dict(
            parent_hash=parent_hash,
            fee_recipient=bytes(20),
            state_root=hashlib.sha256(b"relay-state" + block_hash).digest(),
            receipts_root=bytes(32),
            prev_randao=bytes(
                state.randao_mixes[epoch % preset.epochs_per_historical_vector]
            ),
            block_number=number,
            gas_limit=30_000_000,
            gas_used=0,
            timestamp=compute_timestamp_at_slot(state, state.slot, chain.spec),
            extra_data=b"mock-relay",
            base_fee_per_gas=7,
            block_hash=block_hash,
            transactions=[],
        )
        if "withdrawals" in payload_cls._fields:
            kwargs["withdrawals"] = get_expected_withdrawals(
                state, chain.spec
            )
        if "blob_gas_used" in payload_cls._fields:
            kwargs["blob_gas_used"] = 0
            kwargs["excess_blob_gas"] = 0
        return payload_cls(**kwargs), fork

    def _handle_get(self, h) -> None:
        path = h.path.split("?")[0].rstrip("/")
        if path == "/eth/v1/builder/status":
            if self.healthy:
                h._send(200, {})
            else:
                h._send(503, {"message": "relay paused"})
            return
        if path.startswith("/eth/v1/builder/header/"):
            if not self.healthy:
                h._send(503, {"message": "relay paused"})
                return
            if self.return_no_bid:
                h._send(204)
                return
            parts = path.split("/")
            slot = int(parts[5])
            parent_hash = bytes.fromhex(parts[6].removeprefix("0x"))
            payload, fork = self._fabricate_payload(slot, parent_hash)
            from ..network.api import to_json

            types = self.chain.types
            header = payload_to_header(payload, types, fork)
            bid_cls = types.BuilderBid_BY_FORK[fork]
            bid_kwargs = dict(
                header=header, value=self.bid_wei, pubkey=self.pubkey
            )
            if "blob_kzg_commitments" in bid_cls._fields:
                bid_kwargs["blob_kzg_commitments"] = []
            bid = bid_cls(**bid_kwargs)
            sig = self.sk.sign(
                S.compute_signing_root(
                    bid, builder_signing_domain(self.chain.spec)
                )
            )
            signed_cls = types.SignedBuilderBid_BY_FORK[fork]
            signed = signed_cls(message=bid, signature=sig.to_bytes())
            self._served[header.root()] = payload
            h._send(
                200,
                {"version": fork, "data": to_json(signed_cls, signed)},
            )
            return
        h._send(404, {"message": f"no route {path}"})

    def _handle_post(self, h, body: bytes) -> None:
        path = h.path.rstrip("/")
        if path == "/eth/v1/builder/validators":
            self.registrations.extend(json.loads(body))
            h._send(200, {})
            return
        if path == "/eth/v1/builder/blinded_blocks":
            sub = json.loads(body)
            root = bytes.fromhex(sub["header_root"].removeprefix("0x"))
            payload = self._served.get(root)
            if payload is None:
                # never-served header: the relay refuses to reveal
                h._send(400, {"message": "unknown header root"})
                return
            self.submissions.append(sub)
            from ..network.api import to_json

            h._send(
                200, {"data": to_json(type(payload), payload)}
            )
            return
        h._send(404, {"message": f"no route {path}"})
